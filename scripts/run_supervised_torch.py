#!/usr/bin/env python
"""Supervised force matching with the PyTorch/CUDA port (mdgrad_tpu_torch):
``scripts/run_supervised.py``'s flags and defaults, plus ``-device``
(default ``cuda``; ``cpu`` for a run without a card) and ``-seed`` (the
SchNet's initial weights).

1. **Labels**: a Nose-Hoover trajectory of the ground-truth LJ fluid
   (the pair registry entry, ``PairPotentials`` dense), its frames
   turned into (nxyz, energy, energy_grad) by autograd, with
   minimum-image pair lists and real-space offsets
   (``train/supervised_workload.py``, shared with the profile script).
2. **Training**: ``Dataset`` -> padded ``DataLoader`` -> the standard
   ``Trainer`` (early stopping, plateau LR, CSV log, rotating
   checkpoints) on energies shifted by the training split's mean, then
   ``evaluate`` on the test split.
3. **Validation by use**: the trained SchNet alone drives MD through
   ``GNNPotentials`` (its (N, K) table, the gather kernels on the card)
   at the same state point; its RDF is scored against the ground truth's.

Files under ``-logdir``: ``paramset.json``, ``dataset.npz``,
``model.pt``, ``best_model.pt``, ``checkpoint-<epoch>.pt``, ``log.csv``,
``rdf_compare.csv``, ``result.json``.

    python scripts/run_supervised_torch.py                  # on the card
    python scripts/run_supervised_torch.py --dry_run -device cpu
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mdgrad_tpu_torch.train.supervised_workload import (  # noqa: E402
    EPOCH_STEPS, build_system, make_labels, make_loaders, make_trainer,
    model_params, parse_args, sync)


def main(argv=None, log=print):
    """Run the workload; ``argv`` the flags (default ``sys.argv[1:]``),
    ``log`` takes each progress line.  Returns the result dict."""
    args = parse_args(argv)

    from mdgrad_tpu_torch.data.dataset import Dataset
    from mdgrad_tpu_torch.interface import GNNPotentials
    from mdgrad_tpu_torch.md import NoseHooverChain, Simulation
    from mdgrad_tpu_torch.observables import rdf as rdf_obs
    from mdgrad_tpu_torch.train.builders import get_model, save_model
    from mdgrad_tpu_torch.train.supervised import evaluate

    device = args.device
    os.makedirs(args.logdir, exist_ok=True)
    with open(os.path.join(args.logdir, "paramset.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    entry, system, cell_len, T = build_system(args)
    n_atoms = system.get_number_of_atoms()
    log(f"system: {args.data} N={n_atoms} L={cell_len:.3f} T={T:.2f} K")
    seconds = {}

    # ---- 1. ground-truth trajectory -> labeled frames -----------------
    sync(device)
    t0 = time.perf_counter()
    pot_int, _, props = make_labels(system, entry, cell_len, T, args,
                                    device)
    ds = Dataset(props, units_name="kcal/mol", check=False)
    ds.save(os.path.join(args.logdir, "dataset.npz"))
    e = np.asarray(props["energy"])
    sync(device)
    seconds["labels"] = time.perf_counter() - t0
    log(f"dataset: {len(ds)} frames, E/N mean {e.mean() / n_atoms:.4f} "
        f"std {e.std() / n_atoms:.4f}; labels {seconds['labels']:.3f} s")

    # ---- 2. supervised training ---------------------------------------
    train_loader, val_loader, test_loader, e_shift = make_loaders(ds, args)
    log(f"energy reference shift (train mean): {e_shift:.4f} "
        f"({e_shift / n_atoms:.4f}/atom)")
    mp = model_params(args)
    model = get_model(mp, "SchNet", device=device, seed=args.seed)
    trainer = make_trainer(model, train_loader, val_loader, args, log=log)
    step0, epoch0 = trainer.step, trainer.epoch
    sync(device)
    t0 = time.perf_counter()
    trainer.train()
    sync(device)
    seconds["train"] = time.perf_counter() - t0
    n_steps, n_epochs = trainer.step - step0, trainer.epoch - epoch0
    log(f"training: {n_epochs} epochs, {n_steps} steps in "
        f"{seconds['train']:.3f} s")
    save_model(os.path.join(args.logdir, "model.pt"), "SchNet",
               {**mp, "energy_shift": e_shift}, model)

    metrics = evaluate(model, test_loader)
    log(f"test metrics: {metrics}")

    # ---- 3. validation by use: the trained GNN drives MD ---------------
    rdf_start, rdf_end, nbins = entry.get("start", 0.75), entry["end"], 100
    robs = rdf_obs(system, nbins, (rdf_start, rdf_end), device=device)

    def rdf_of(potential, tag):
        mdint = NoseHooverChain(potential, system, T=T, Q=50.0,
                                num_chains=5, adjoint=False, device=device)
        mdsim = Simulation(system, mdint)
        gs = []
        for i in range(args.val_sim):
            traj = mdsim.simulate(EPOCH_STEPS, dt=args.dt,
                                  frequency=EPOCH_STEPS)
            if i >= args.val_sim // 3:
                g = robs(traj.q[::4])[2]
                gs.append(g.cpu().numpy())
            log(f"  [{tag}] epoch {i}")
        log(f"  [{tag}] sampled {len(gs)} epochs")
        return np.mean(gs, axis=0)

    rng2 = np.random.default_rng(7)
    system.set_temperature(T, rng=rng2)
    g_truth = rdf_of(pot_int, "truth")
    system.set_temperature(T, rng=rng2)
    gnn_int = GNNPotentials(system, model, cutoff=args.cutoff,
                            device=device)
    sync(device)
    t0 = time.perf_counter()
    g_gnn = rdf_of(gnn_int, "gnn")
    sync(device)
    seconds["validation_md"] = time.perf_counter() - t0

    rdf_mse = float(np.mean((g_gnn - g_truth) ** 2))
    x = np.linspace(rdf_start, rdf_end, nbins)
    np.savetxt(os.path.join(args.logdir, "rdf_compare.csv"),
               np.vstack([x, g_truth, g_gnn]).T, delimiter=",",
               header="r,g_truth,g_gnn")
    result = {"test_metrics": {k: {m: float(v) for m, v in d.items()}
                               for k, d in metrics.items()},
              "energy_shift": e_shift,
              "rdf_mse_vs_truth": rdf_mse,
              "n_frames": len(ds), "n_atoms": n_atoms,
              "train_steps": n_steps, "train_epochs": n_epochs,
              "seconds": seconds}
    with open(os.path.join(args.logdir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    log(f"validation-by-use RDF MSE vs ground truth: {rdf_mse:.5f}")
    return result


if __name__ == "__main__":
    main()
