#!/usr/bin/env python
"""Device-busy share of the supervised workload's four loops on the card.

The workload itself, through the functions that
``scripts/run_supervised_torch.py`` runs (``train/supervised_workload.py``)
at its defaults (lj_0.845_1.2, 108 atoms, cutoff 2.5, dt
0.005; the 400 labelled frames after 20 burn-in epochs; SchNet 64/64,
2.5 // 0.1 = 24 Gaussians, 2 convolutions, its seeded weights): one
label-MD epoch (120 dense-LJ Nose-Hoover steps), one training epoch (the
``Trainer``'s steps of 16 frames over the 280-frame training split and
its validation pass), one validation-MD epoch (120 steps of the SchNet
through ``GNNPotentials``, the gather kernels) and one TI segment (20
BAOAB steps).  Each runs three times: to warm up, timed by the wall
clock, and under ``torch.profiler``; the busy time is the union of the
profiled run's device intervals (kernels and copies).  Prints one JSON
line and writes the profiler's tables to
``chiprun_out/profile_supervised.txt``.

    python scripts/profile_supervised_torch.py
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join("chiprun_out", "profile_supervised.txt")
TI_STEPS = 20


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mdgrad_tpu_torch._device import resolve_device
    from mdgrad_tpu_torch.data.dataset import Dataset
    from mdgrad_tpu_torch.interface import GNNPotentials
    from mdgrad_tpu_torch.md import NoseHooverChain, Simulation
    from mdgrad_tpu_torch.md.ti import TI
    from mdgrad_tpu_torch.nn.models import GraphConvIntegration
    from mdgrad_tpu_torch.profiling import busy_us
    from mdgrad_tpu_torch.train import supervised_workload as workload
    from mdgrad_tpu_torch.train.builders import get_model

    dev = resolve_device("cuda")      # raises without a card
    tmp = tempfile.TemporaryDirectory()
    args = workload.parse_args(["-logdir", tmp.name])
    steps = workload.EPOCH_STEPS
    entry, system, cell_len, T = workload.build_system(args)
    n = system.get_number_of_atoms()
    _, sim, props = workload.make_labels(system, entry, cell_len, T, args,
                                         dev)

    def label_epoch():
        return sim.simulate(steps, dt=args.dt, frequency=steps)

    train_loader, val_loader, _, _ = workload.make_loaders(
        Dataset(props, units_name="kcal/mol", check=False), args)
    mp = workload.model_params(args)
    model = get_model(mp, "SchNet", device=dev, seed=args.seed)
    trainer = workload.make_trainer(model, train_loader, val_loader, args,
                                    log=lambda m: None)

    def train_epoch():
        trainer.train(n_epochs=trainer.epoch + 1)

    gnn_sim = Simulation(system, NoseHooverChain(
        GNNPotentials(system, model, cutoff=args.cutoff, device=dev),
        system, T=T, Q=50.0, num_chains=5, adjoint=False, device=dev))

    def gnn_epoch():
        return gnn_sim.simulate(steps, dt=args.dt, frequency=steps)

    gci = GraphConvIntegration(mp)
    gci.load_state_dict(model.state_dict())
    final = np.ones(n)
    final[-1] = 0.0
    ti = TI(system, gci.to(dev), np.ones(n), final, T_init=T, dt=args.dt,
            cutoff=args.cutoff, steps=TI_STEPS,
            nbr_list_update_freq=TI_STEPS, device=dev)

    def ti_segment():
        ti.run(log=lambda m: None)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {"device": torch.cuda.get_device_name(0), "n_atoms": n}
    tables = []
    for name, fn, n_steps in (("label_md_epoch", label_epoch, steps - 1),
                              ("train_epoch", train_epoch,
                               len(train_loader)),
                              ("validation_md_epoch", gnn_epoch, steps - 1),
                              ("ti_segment", ti_segment, TI_STEPS)):
        timed(fn)
        wall = timed(fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof = timed(fn)
        busy, n_dev = busy_us(prof.events(), torch.autograd.DeviceType.CUDA)
        out[name] = {"steps": n_steps, "wall_s": wall,
                     "ms_a_step": 1e3 * wall / n_steps,
                     "profiled_wall_s": wall_prof,
                     "device_busy_s": busy * 1e-6,
                     "device_events_a_step": n_dev / n_steps,
                     "busy_share": busy * 1e-6 / wall,
                     "busy_share_profiled": busy * 1e-6 / wall_prof}
        tables.append(f"== {name}\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=25))
    tmp.cleanup()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write("\n".join(tables))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
