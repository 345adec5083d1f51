"""Tracing and timing helpers.

Port of ``mdgrad_tpu/profiling.py``.  ``trace`` runs ``torch.profiler``
over a block and writes a Chrome trace (view it in Perfetto or
``chrome://tracing``); ``busy_us`` reads the union of the card's busy
intervals from its events; ``Throughput`` is the steps/s counter the
fit drivers print; ``time_fn`` is the warm-then-time micro-benchmark.
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir, host_only=False):
    """Trace of everything inside the block, written to
    ``logdir/trace.json`` when the block ends.

    Usage::

        with profiling.trace("/tmp/trace") as prof:
            traj = sim.simulate(steps=100, dt=dt)
            torch.cuda.synchronize()
        busy, n = profiling.busy_us(prof.events(),
                                    torch.autograd.DeviceType.CUDA)

    The CPU is always recorded; the card too (kernels, copies) when one
    is present, unless ``host_only``.  Yields the
    ``torch.profiler.profile`` object.
    """
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if not host_only and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def busy_us(events, device_type):
    """Length in microseconds of the union of the intervals of the
    ``events`` on ``device_type`` (a ``torch.autograd.DeviceType``), and
    their count."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == device_type)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total, len(spans)


class Throughput:
    """Steps/s (and any-unit/s) counter with exponential smoothing.

    >>> tp = Throughput(unit="steps")
    >>> for epoch in range(10):
    ...     run_epoch()           # doctest: +SKIP
    ...     print(tp.update(steps_this_epoch))  # doctest: +SKIP
    """

    def __init__(self, unit="steps", alpha=0.3):
        self.unit = unit
        self.alpha = alpha
        self.rate = None
        self._t = time.perf_counter()
        self.total = 0

    def update(self, n):
        now = time.perf_counter()
        dt = max(now - self._t, 1e-9)
        self._t = now
        inst = n / dt
        self.rate = (inst if self.rate is None
                     else self.alpha * inst + (1 - self.alpha) * self.rate)
        self.total += n
        return self.rate

    def __str__(self):
        r = 0.0 if self.rate is None else self.rate
        return f"{r:.1f} {self.unit}/s"


def _on_card(out):
    """Whether any tensor in ``out`` (nested tuples, lists, dicts) lies on
    a card."""
    from torch.utils._pytree import tree_leaves
    return any(torch.is_tensor(x) and x.is_cuda for x in tree_leaves(out))


def time_fn(fn, *args, iters=20, warmup=2):
    """Mean wall-clock seconds of ``fn(*args)`` after ``warmup`` calls;
    when the output lies on a card, the card is synchronized after the
    warmup and after the timed loop."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if _on_card(out):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    if _on_card(out):
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters
