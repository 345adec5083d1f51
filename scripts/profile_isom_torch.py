#!/usr/bin/env python
"""Device-busy share of an isomerization epoch of the PyTorch/CUDA port.

Runs ``fit_isomerization`` for one epoch of 1000 RK4 steps (the
retinal operators, the replay adjoint) three times on the card: once to
warm up, once timed by the wall clock, once under ``torch.profiler``.
The busy time is the union of the profiled run's device intervals
(kernels and copies); the share divides it by the unprofiled and by the
profiled run's wall time.  Prints one JSON line and writes the
profiler's table to ``chiprun_out/profile_isom.txt``.

    python scripts/profile_isom_torch.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

STEPS = 1000
OUT = os.path.join("chiprun_out", "profile_isom.txt")


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mdgrad_tpu_torch._device import resolve_device
    from mdgrad_tpu_torch.profiling import busy_us
    from mdgrad_tpu_torch.train.isom import fit_isomerization

    resolve_device("cuda")      # raises without a card

    def epoch():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_isomerization(n_epochs=1, n_steps=STEPS, look_back=STEPS,
                          log=lambda m: None, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    epoch()
    wall = epoch()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = epoch()
    busy, n_dev = busy_us(prof.events(), torch.autograd.DeviceType.CUDA)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    print(json.dumps({
        "steps": STEPS, "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "profiled_wall_s": wall_prof,
        "device_busy_s": busy * 1e-6, "device_events": n_dev,
        "busy_share": busy * 1e-6 / wall,
        "busy_share_profiled": busy * 1e-6 / wall_prof}))


if __name__ == "__main__":
    main()
