#!/usr/bin/env python
"""Supervised force matching with the PyTorch/CUDA port (mdgrad_tpu_torch):
``scripts/run_supervised.py``'s flags and defaults, plus ``-device``
(default ``cuda``; ``cpu`` for a run without a card) and ``-seed`` (the
SchNet's initial weights).

1. **Labels**: a Nose-Hoover trajectory of the ground-truth LJ fluid
   (the pair registry entry, ``PairPotentials`` dense), its frames
   turned into (nxyz, energy, energy_grad) by autograd, with
   minimum-image pair lists and real-space offsets (:func:`pbc_pairs`).
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

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

EPOCH_STEPS = 120        # MD steps a simulate() call, labels and validation


def pbc_pairs(xyz, cell_len, cutoff):
    """Min-image pair list for a diagonal cell: (P,2) int32 indices and
    (P,3) real-space offsets such that edge = xyz[i]-xyz[j]-offset."""
    disp = xyz[:, None] - xyz[None, :]
    shift = np.round(disp / cell_len)
    off = shift * cell_len
    dis = np.linalg.norm(disp - off, axis=-1)
    n = len(xyz)
    iu = np.triu(np.ones((n, n), dtype=bool), k=1)
    i, j = np.nonzero(iu & (dis < cutoff))
    return (np.stack([i, j], axis=-1).astype(np.int32),
            off[i, j].astype(np.float32))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/supervised")
    p.add_argument("-data", type=str, default="lj_0.845_1.2")
    p.add_argument("-size", type=int, default=3)
    p.add_argument("-cutoff", type=float, default=2.5)
    p.add_argument("-dt", type=float, default=0.005)
    p.add_argument("-burnin", type=int, default=20,
                   help="equilibration epochs (discarded)")
    p.add_argument("-n_frames", type=int, default=400)
    p.add_argument("-frame_stride", type=int, default=20,
                   help="MD steps between kept frames (decorrelation)")
    p.add_argument("-batch_size", type=int, default=16)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-max_epochs", type=int, default=150)
    p.add_argument("-patience", type=int, default=30)
    p.add_argument("-n_atom_basis", type=int, default=64)
    p.add_argument("-n_filters", type=int, default=64)
    p.add_argument("-n_convolutions", type=int, default=2)
    p.add_argument("-val_sim", type=int, default=12,
                   help="validation MD epochs (120 steps each)")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    p.add_argument("-seed", type=int, default=0,
                   help="seed of the SchNet's initial weights")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    if args.dry_run:
        args.n_frames, args.burnin, args.max_epochs = 24, 2, 4
        args.val_sim, args.frame_stride = 4, 5
    return args


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_system(args):
    """(registry entry, System, cell length, T in Kelvin) of ``-data`` at
    ``-size``."""
    from mdgrad_tpu_torch.data.registry import pair_data_dict
    from mdgrad_tpu_torch.train.fit_rdf import get_system, registry_T_kelvin
    entry = pair_data_dict[args.data]
    system = get_system(args.data, args.size, pair_data_dict,
                        rng=np.random.default_rng(0))
    cell = np.asarray(system.get_cell())
    cell_len = float(cell[0, 0] if cell.ndim == 2 else cell[0])
    return entry, system, cell_len, registry_T_kelvin(entry)


def make_labels(system, entry, cell_len, T, args, device):
    """The ground-truth LJ (dense ``PairPotentials``), its Nose-Hoover
    ``Simulation`` after ``-burnin`` epochs, and ``-n_frames`` frames, one
    every ``-frame_stride`` steps, wrapped into the box and labelled by
    autograd: ``(pot, sim, props)``."""
    import torch
    from mdgrad_tpu_torch.interface import PairPotentials
    from mdgrad_tpu_torch.md import NoseHooverChain, Simulation
    from mdgrad_tpu_torch.train.fit_rdf_pair import resolve_target_pot
    pot = PairPotentials(system, resolve_target_pot(entry["target_pot"]),
                         cutoff=args.cutoff, device=device)
    sim = Simulation(system, NoseHooverChain(pot, system, T=T, Q=50.0,
                                             num_chains=5, adjoint=False,
                                             device=device))

    def label(q):
        x = torch.as_tensor(q, device=device).requires_grad_(True)
        u = pot.energy(x, pot.aux_init(x))
        (g,) = torch.autograd.grad(u, x)
        return u.item(), g.cpu().numpy()

    for _ in range(args.burnin):
        sim.simulate(EPOCH_STEPS, dt=args.dt, frequency=EPOCH_STEPS)

    z = np.asarray(system.get_atomic_numbers(), dtype=np.float32)
    props = {"nxyz": [], "energy": [], "energy_grad": [],
             "nbr_list": [], "offsets": []}
    while len(props["nxyz"]) < args.n_frames:
        traj = sim.simulate(EPOCH_STEPS, dt=args.dt, frequency=EPOCH_STEPS)
        frames = traj.q.cpu().numpy()[::args.frame_stride]
        for q in frames:
            if len(props["nxyz"]) >= args.n_frames:
                break
            q = q - cell_len * np.floor(q / cell_len)  # wrap into box
            u, g = label(q)
            nbrs, offs = pbc_pairs(q, cell_len, args.cutoff)
            props["nxyz"].append(np.concatenate(
                [z[:, None], q.astype(np.float32)], axis=1))
            props["energy"].append(np.float32(u))
            props["energy_grad"].append(np.asarray(g, dtype=np.float32))
            props["nbr_list"].append(nbrs)
            props["offsets"].append(offs)
    return pot, sim, props


def make_loaders(ds, args):
    """Split ``ds`` 70/15/15 and shift every energy by the training
    split's mean: ``(train, val, test loaders, the shift)``."""
    from mdgrad_tpu_torch.data.dataset import split_train_validation_test
    from mdgrad_tpu_torch.data.loader import DataLoader
    train, val, test = split_train_validation_test(ds, 0.15, 0.15, seed=1)
    # forces do not see the energy origin and the energy weight is small,
    # so train against labels shifted by the training split's mean; a
    # prediction in use is pred + e_shift
    e_shift = float(np.mean([float(e) for e in train.props["energy"]]))
    for subset in (train, val, test):
        subset.props["energy"] = [np.float32(float(e) - e_shift)
                                  for e in subset.props["energy"]]
    return (DataLoader(train, batch_size=args.batch_size, seed=1),
            DataLoader(val, batch_size=args.batch_size, shuffle=False),
            DataLoader(test, batch_size=args.batch_size, shuffle=False),
            e_shift)


def model_params(args):
    """The SchNet's hyperparameters, as ``run_supervised.py`` sets them
    (``int(cutoff // 0.1)`` Gaussians: 24 at cutoff 2.5)."""
    return {"n_atom_basis": args.n_atom_basis,
            "n_filters": args.n_filters,
            "n_gaussians": int(args.cutoff // 0.1),
            "n_convolutions": args.n_convolutions,
            "cutoff": args.cutoff}


def make_trainer(model, train_loader, val_loader, args, log=print):
    """The workload's ``Trainer``: energy weight 0.01, forces 1."""
    from mdgrad_tpu_torch.train.builders import get_trainer
    return get_trainer(model, train_loader, val_loader, args.logdir,
                       lr=args.lr,
                       loss_coef={"energy": 0.01, "energy_grad": 1.0},
                       max_epochs=args.max_epochs, patience=args.patience,
                       log=log)


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
    _sync(device)
    t0 = time.perf_counter()
    pot_int, _, props = make_labels(system, entry, cell_len, T, args,
                                    device)
    ds = Dataset(props, units_name="kcal/mol", check=False)
    ds.save(os.path.join(args.logdir, "dataset.npz"))
    e = np.asarray(props["energy"])
    _sync(device)
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
    _sync(device)
    t0 = time.perf_counter()
    trainer.train()
    _sync(device)
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
    _sync(device)
    t0 = time.perf_counter()
    g_gnn = rdf_of(gnn_int, "gnn")
    _sync(device)
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
