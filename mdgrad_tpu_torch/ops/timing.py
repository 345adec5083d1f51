"""Device times of kernels on the card, from CUDA events around CUDA graphs.

A graph replays many launches with no host launch cost between them, so
its time over the launch count is the kernel's device time.  Warm
(:func:`time_graph`): every launch reads the same inputs, which stay in
the 50 MB L2 of an H100 as they do on the MD path, where a kernel reads
what the previous one just wrote.  Cold (:func:`time_cold`): the launches
cycle over input sets whose bytes together exceed the L2, so each launch
finds its inputs in device memory; a share of the bandwidth bound is
stated against this reading only.
"""

import statistics

import torch


def _median_events(run, groups):
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_of(calls):
    """A CUDA graph of ``calls`` in order, after one eager warm-up pass."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        calls[0]()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def time_graph(fn, reps=100, groups=7):
    """Median device time (ms) of one ``fn()`` replayed from a CUDA graph
    of ``reps`` calls: the launch cost of the host is not in it."""
    graph = _graph_of([fn] * reps)
    return _median_events(graph.replay, groups) / reps


def time_cold(fns, rounds=8, groups=7):
    """Median device time (ms) of one call from a CUDA graph that calls
    ``fns`` in turn ``rounds`` times; each ``fns[s]`` reads and writes its
    own set of tensors, all the sets together larger than the L2."""
    calls = list(fns) * rounds
    graph = _graph_of(calls)
    return _median_events(graph.replay, groups) / len(calls)


def time_loop(fn, reps, groups=5):
    """Median time (ms) of one ``fn()`` called back to back, host launch
    cost included (for code that reads the device, e.g. masks)."""
    fn()
    torch.cuda.synchronize()
    return _median_events(lambda: [fn() for _ in range(reps)],
                          groups) / reps
