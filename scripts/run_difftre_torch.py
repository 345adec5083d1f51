#!/usr/bin/env python
"""Multi-state LJ fitting by Differentiable Trajectory Reweighting with the
PyTorch/CUDA port (mdgrad_tpu_torch): ``scripts/run_difftre.py``'s flags,
defaults and model, plus ``-device`` (default ``cuda``; ``cpu`` for a run
without a card).

The model and targets of ``scripts/run_lj_torch.py`` (a PairMLP of 25
Gaussians, width 128, 3 layers, SELU, on the (N, K) table over the
LJ-family prior; lj_0.7_1 at size 5, 500 atoms), warm-started by
Boltzmann-inversion pretraining (``-pretrain``), ``-init_pt``, a
``best.pt`` / ``last.pt`` this script wrote, or the JAX script's
``-init_pkl``, a JAX pickle whose parameters hold ``'pairnn'`` (its
``best.pkl``, ``fit_lj``'s ``best_eval.pkl`` or fit checkpoints), of
which the MLP takes ``params['pairnn']`` as the JAX script grafts it.
The gradients come from ``train/difftre.py``: within an outer iteration the frames are fixed, so
the inner Adam steps on the MLP (the prior frozen) are deterministic.
Writes ``paramset.json``, ``last.pt`` (each outer), ``best.pt`` (the
outer entry of the lowest fresh-frame loss), ``history.json`` and the
recovered u(r) on a grid, ``potential.txt``, into ``-logdir``.

    python scripts/run_difftre_torch.py                      # on the card
    python scripts/run_difftre_torch.py --dry_run -device cpu
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def load_init_pkl(net, path):
    """Load the PairMLP ``net`` from the ``'pairnn'`` subtree of the
    parameters in the JAX pickle ``path``."""
    from mdgrad_tpu_torch.train.checkpoint import pair_mlp_state
    net.load_state_dict(pair_mlp_state(path))


def main(argv=None):
    """Run the fit; ``argv`` the flags (default ``sys.argv[1:]``).
    Returns the history (one dict an outer)."""
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/difftre")
    p.add_argument("-data", type=str, nargs="+", default=["lj_0.7_1"])
    p.add_argument("-size", type=int, default=5)
    p.add_argument("-sigma", type=float, default=0.9)
    p.add_argument("-cutoff", type=float, default=2.5)
    p.add_argument("-lr", type=float, default=3e-4)
    p.add_argument("-n_outer", type=int, default=30)
    p.add_argument("-inner_steps", type=int, default=60)
    p.add_argument("-n_frames", type=int, default=48)
    p.add_argument("-steps_between", type=int, default=60)
    p.add_argument("-equil_steps", type=int, default=1200)
    p.add_argument("-ess_min", type=float, default=0.9)
    p.add_argument("-pressure_weight", type=float, default=0.0)
    p.add_argument("-target_nsim", type=int, default=30)
    p.add_argument("-pretrain", type=int, default=2000)
    warm = p.add_mutually_exclusive_group()
    warm.add_argument("-init_pt", type=str, default=None,
                      help="warm start from a best.pt / last.pt of this "
                           "script; replaces the BI pretrain")
    warm.add_argument("-init_pkl", type=str, default=None,
                      help="warm start from a JAX pickle's "
                           "params['pairnn']; replaces the BI pretrain")
    p.add_argument("-capacity_slack", type=float, default=2.5)
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    if args.dry_run:
        args.size, args.n_outer, args.inner_steps = 2, 2, 5
        args.n_frames, args.steps_between = 6, 10
        args.equil_steps, args.target_nsim, args.pretrain = 30, 4, 50

    import torch
    from mdgrad_tpu_torch import potentials as pot_zoo, units
    from mdgrad_tpu_torch.data.registry import pair_data_dict
    from mdgrad_tpu_torch.interface import PairPotentials, Stack
    from mdgrad_tpu_torch.md import NoseHooverChain, Simulation
    from mdgrad_tpu_torch.nn import PairMLP
    from mdgrad_tpu_torch.train.difftre import difftre_fit
    from mdgrad_tpu_torch.train.fit_rdf import fit_parameters
    from mdgrad_tpu_torch.train.fit_rdf_pair import (get_observer,
                                                     get_system,
                                                     registry_T_kelvin)
    from mdgrad_tpu_torch.train.optim import FitUpdate
    from mdgrad_tpu_torch.train.pretrain import boltzmann_inversion_pretrain

    device = torch.device(args.device)
    os.makedirs(args.logdir, exist_ok=True)
    rng = np.random.default_rng(0)
    nbins, t_range, opt_freq = 100, 50, 120
    cfg = {
        "nbins": nbins, "opt_freq": opt_freq, "lr": args.lr,
        "sigma": args.sigma, "gaussian_width": 0.1, "n_width": 128,
        "n_layers": 3, "nonlinear": "SELU", "rdf_weight": 1.0,
        "vacf_weight": 0.0, "pressure_weight": args.pressure_weight,
        "size": args.size, "cutoff": args.cutoff, "t_range": t_range,
        "data": list(args.data), "capacity_slack": args.capacity_slack,
        "pretrain_iters": args.pretrain, "engine": "difftre",
        "n_outer": args.n_outer, "inner_steps": args.inner_steps,
        "n_frames": args.n_frames, "steps_between": args.steps_between,
        "ess_min": args.ess_min, "target_nsim": args.target_nsim,
    }
    with open(os.path.join(args.logdir, "paramset.json"), "w") as f:
        json.dump({k: str(v) for k, v in cfg.items()}, f, indent=2)

    net = PairMLP(n_gauss=int(args.cutoff // 0.1), r_start=0.0,
                  r_end=args.cutoff, n_width=128, n_layers=3,
                  nonlinear="SELU", device=device)
    prior = pot_zoo.LJFamily(epsilon=2.0, sigma=args.sigma, rep_pow=6,
                             attr_pow=3)

    sims, observers, targets, kTs, cells, dts, p_targets, xs = \
        [], [], [], [], [], [], [], []
    stack = None
    for tag in args.data:
        entry = pair_data_dict[tag]
        system = get_system(tag, args.size, pair_data_dict, rng=rng)
        stack = Stack({
            "pairnn": PairPotentials(system, net, cutoff=args.cutoff,
                                     mode="table",
                                     capacity_slack=args.capacity_slack,
                                     device=device),
            "pair": PairPotentials(system, prior, cutoff=args.cutoff,
                                   device=device)})
        train = fit_parameters(stack, key="pairnn")
        integ = NoseHooverChain(stack, system, T=registry_T_kelvin(entry),
                                Q=50.0, num_chains=5, adjoint=False,
                                device=device)
        x, g_t, robs, _, _, p_t = get_observer(
            system, tag, nbins, t_range, entry.get("start", 0.75),
            pair_data_dict, target_nsim=args.target_nsim,
            want_pressure=args.pressure_weight > 0, rng=rng, device=device)
        print(f"{tag}: P target {p_t}", flush=True)
        sims.append(Simulation(system, integ))
        observers.append(robs)
        targets.append(g_t)
        kTs.append(registry_T_kelvin(entry) * units.kB)
        cells.append(system.get_cell())
        dts.append(entry.get("dt", 0.01))
        p_targets.append(p_t)
        xs.append(x)

    # warm start: a saved candidate or the BI pretrain
    if args.init_pt:
        stack.load_state_dict(torch.load(args.init_pt, map_location=device,
                                         weights_only=True))
        print(f"warm start from {args.init_pt}", flush=True)
    elif args.init_pkl:
        load_init_pkl(net, args.init_pkl)
        print(f"warm start from {args.init_pkl}", flush=True)
    elif args.pretrain:
        T_list = [registry_T_kelvin(pair_data_dict[t]) for t in args.data]
        r_lo = min(pair_data_dict[t].get("start", 0.75) for t in args.data)
        boltzmann_inversion_pretrain(
            net, prior, xs, targets, T_list,
            rrange=np.linspace(max(r_lo, 0.8 * args.sigma), args.cutoff,
                               400), n_iters=args.pretrain)

    dt = dts[0]
    assert all(abs(d - dt) < 1e-12 for d in dts), \
        "difftre_fit shares one dt across states"

    def checkpoint_outer(outer, hist):
        torch.save(stack.state_dict(), os.path.join(args.logdir, "last.pt"))
        with open(os.path.join(args.logdir, "history.json"), "w") as f:
            json.dump(hist, f, indent=2)

    def checkpoint_best(outer, loss0, entry_states):
        # the lowest fresh-frame uniform-weight loss: the outer's entry
        torch.save(entry_states[0], os.path.join(args.logdir, "best.pt"))

    history = difftre_fit(
        sims, observers, targets, kTs, cells,
        FitUpdate(train, args.lr, grad_clip=None), dt,
        n_outer=args.n_outer, inner_steps=args.inner_steps,
        n_frames=args.n_frames, steps_between=args.steps_between,
        equil_steps=args.equil_steps, ess_min=args.ess_min,
        pressure_targets=(p_targets if args.pressure_weight > 0
                          else None),
        pressure_weight=args.pressure_weight,
        dim=pair_data_dict[args.data[0]].get("dim", 3),
        on_outer=checkpoint_outer, on_best=checkpoint_best)

    torch.save(stack.state_dict(), os.path.join(args.logdir, "last.pt"))
    if not os.path.exists(os.path.join(args.logdir, "best.pt")):
        # no clean outer recorded a best: the last parameters
        torch.save(stack.state_dict(), os.path.join(args.logdir, "best.pt"))
    with open(os.path.join(args.logdir, "history.json"), "w") as f:
        json.dump(history, f, indent=2)

    # the recovered potential on a grid
    r_grid = np.linspace(0.3, args.cutoff, 250)
    with torch.no_grad():
        r = torch.tensor(r_grid, dtype=torch.float32, device=device)[:, None]
        u = (net(r) + prior(r)).squeeze(-1).cpu().double().numpy()
    u = u - u[-1]
    np.savetxt(os.path.join(args.logdir, "potential.txt"),
               np.vstack([r_grid, u]), delimiter=",")
    last = (f"final loss {history[-1]['loss']:.6f} (min ESS/F "
            f"{history[-1]['ess']:.3f}); " if history
            else "no completed outers (best.pt = entry params); ")
    print(last + f"recovered depth {float(u.min()):.4f} "
          f"@ r={r_grid[int(u.argmin())]:.3f}", flush=True)
    return history


if __name__ == "__main__":
    main()
