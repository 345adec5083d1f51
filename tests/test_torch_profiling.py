"""The port's ``profiling.py`` against the JAX package's
(``mdgrad_tpu/profiling.py``), mirroring
tests/test_md_extras.py::test_profiling_helpers: ``trace`` writes a
trace into its directory, ``Throughput`` and ``time_fn`` behave as the
JAX helpers do, and ``busy_us`` takes the union of device intervals.

``Throughput`` is a copy: fed the same clock readings, both packages
give the same rates to the last bit.
"""

import json
import types

import torch

from mdgrad_tpu import profiling as profiling_j
from mdgrad_tpu_torch import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.arange(128.0)
    with profiling.trace(str(tmp_path), host_only=True) as prof:
        (x ** 2).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"], "trace wrote no event"
    assert any(e.name.startswith("aten::") for e in prof.events())
    # host only: nothing on a device
    assert profiling.busy_us(prof.events(),
                             torch.autograd.DeviceType.CUDA) == (0.0, 0)


def test_throughput_matches_jax(monkeypatch):
    now = [0.0]
    rates = {}
    for name, mod in (("jax", profiling_j), ("port", profiling)):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: now[0])
        now[0] = 0.0
        tp = mod.Throughput(unit="frames", alpha=0.3)
        out = []
        for t, n in zip([0.5, 1.25, 1.5, 3.0], [10, 20, 5, 40]):
            now[0] = t
            out.append(tp.update(n))
        rates[name] = (out, tp.total, str(tp))
    assert rates["port"] == rates["jax"]
    assert rates["port"][1] == 75 and "frames/s" in rates["port"][2]


def test_time_fn():
    calls = []

    def f(x):
        calls.append(1)
        return (x ** 2).sum()

    x = torch.arange(128.0)
    dt = profiling.time_fn(f, x, iters=3, warmup=1)
    assert dt > 0 and len(calls) == 4
    assert not profiling._on_card({"a": [x, (x,)]})


def _event(a, b, dev):
    return types.SimpleNamespace(
        time_range=types.SimpleNamespace(start=a, end=b), device_type=dev)


def test_busy_us_is_the_union_of_intervals():
    cuda, cpu = (torch.autograd.DeviceType.CUDA,
                 torch.autograd.DeviceType.CPU)
    events = [_event(0, 10, cuda), _event(5, 12, cuda), _event(20, 25, cuda),
              _event(21, 22, cuda), _event(0, 100, cpu)]
    assert profiling.busy_us(events, cuda) == (17.0, 4)
    assert profiling.busy_us(events, cpu) == (100.0, 1)
    assert profiling.busy_us([], cuda) == (0.0, 0)
