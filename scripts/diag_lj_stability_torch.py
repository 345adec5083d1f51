#!/usr/bin/env python
"""Per-state dynamical stability of a saved LJ pair candidate with the
PyTorch/CUDA port: ``scripts/diag_lj_stability.py``'s flags, defaults and
loop, plus ``-device`` (default ``cuda``; ``cpu`` for a run without a
card).

Each state point of ``-data`` runs on its own, for each of ``-seeds``
momenta seeds, at the fixed candidate parameters: a PairMLP (``cutoff //
0.1`` Gaussians, width 128, 3 layers, SELU) on the (N, K) table over the
LJ-family prior (epsilon 2.0, ``-sigma``, powers 6 and 3) under a
Nose-Hoover chain (Q 50, 5 chains, no adjoint), the velocities redrawn
at the state's temperature from the seed's generator.  Chunks of
``-chunk`` steps run until ``-steps`` or the first non-finite position.
The candidate is the ``'pairnn'`` subtree of the JAX pickle
``-init_pkl`` (read by ``train/checkpoint.py::read_jax_pickle``);
``--truth`` runs the registry's ground-truth potential instead (a
control of the sampler).  The pair MLP and the prior run in plain
PyTorch, as the JAX package runs them in ``jnp``: no kernel of the port
is on this path.

    python scripts/diag_lj_stability_torch.py              # on the card
    python scripts/diag_lj_stability_torch.py -device cpu -data lj_0.7_1 \\
        -size 3 -steps 1000 -seeds 1
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-init_pkl", type=str,
                   default="results/lj_multi_r3g/0/best_eval.pkl")
    p.add_argument("-data", type=str, nargs="+",
                   default=["lj_0.845_0.75", "lj_0.845_1.2", "lj_0.7_1",
                            "lj_0.5_1.2", "lj_0.3_1.2"])
    p.add_argument("-size", type=int, default=5)
    p.add_argument("-sigma", type=float, default=0.9)
    p.add_argument("-cutoff", type=float, default=2.5)
    p.add_argument("-steps", type=int, default=15000)
    p.add_argument("-chunk", type=int, default=500,
                   help="epoch length; -chunk == -steps runs one long "
                        "epoch")
    p.add_argument("-seeds", type=int, default=2)
    p.add_argument("-capacity_slack", type=float, default=2.5)
    p.add_argument("--truth", action="store_true",
                   help="probe the registry ground-truth potential "
                        "instead of the saved candidate (sampler "
                        "control: any blowup is the engine, not the "
                        "candidate)")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def main(argv=None, log=print, dtype=None):
    """Run the probe; ``argv`` the flags (default ``sys.argv[1:]``),
    ``log`` takes each line, ``dtype`` the MD's and the models' (default
    float32; float64 for parity checks).  Returns one dict a (state,
    seed): ``tag``, ``seed``, ``died`` (the step of the chunk that left a
    non-finite position, or None), ``status`` (the printed verdict) and
    ``q`` (the last positions, an (N, 3) numpy array)."""
    args = parse_args(argv)
    import torch
    from mdgrad_tpu_torch import potentials as pot_zoo, units
    from mdgrad_tpu_torch.data.registry import pair_data_dict
    from mdgrad_tpu_torch.interface import PairPotentials, Stack
    from mdgrad_tpu_torch.md import NoseHooverChain, Simulation, rethermalize
    from mdgrad_tpu_torch.nn import PairMLP
    from mdgrad_tpu_torch.train.checkpoint import pair_mlp_state
    from mdgrad_tpu_torch.train.fit_rdf_pair import (get_system,
                                                     registry_T_kelvin,
                                                     resolve_target_pot)

    dtype = torch.float32 if dtype is None else dtype
    dev = torch.device(args.device)
    log(f"device: {torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
        else f"device: {dev}")
    cand = None if args.truth else pair_mlp_state(args.init_pkl)

    records = []
    for tag in args.data:
        entry = pair_data_dict[tag]
        dt = entry.get("dt", 0.01)
        T = registry_T_kelvin(entry)
        for seed in range(args.seeds):
            rng = np.random.default_rng(seed)
            system = get_system(tag, args.size, pair_data_dict, rng=rng)
            if args.truth:
                stack = Stack({"pair": PairPotentials(
                    system, resolve_target_pot(entry["target_pot"]),
                    cutoff=args.cutoff, device=dev)})
            else:
                net = PairMLP(n_gauss=int(args.cutoff // 0.1), r_start=0.0,
                              r_end=args.cutoff, n_width=128, n_layers=3,
                              nonlinear="SELU", device=dev)
                net.load_state_dict(cand)
                prior = pot_zoo.LJFamily(epsilon=2.0, sigma=args.sigma,
                                         rep_pow=6, attr_pow=3)
                stack = Stack({
                    "pairnn": PairPotentials(
                        system, net, cutoff=args.cutoff, mode="table",
                        capacity_slack=args.capacity_slack, device=dev),
                    "pair": PairPotentials(system, prior, cutoff=args.cutoff,
                                           device=dev)})
            if dtype != torch.float32:
                stack.to(dtype)
            integ = NoseHooverChain(stack, system, T=T, Q=50.0, num_chains=5,
                                    adjoint=False, device=dev, dtype=dtype)
            sim = Simulation(system, integ)
            st, aux = sim.initial_state()
            sim.state = rethermalize(st, T * units.kB, system.get_masses(),
                                     rng=rng, dim=system.dim)
            sim.aux = aux
            died = None
            for start in range(0, args.steps, args.chunk):
                sim.simulate(steps=args.chunk, dt=dt, frequency=args.chunk)
                if not bool(torch.isfinite(sim.state.q).all()):
                    died = start + args.chunk
                    break
            status = (f"NaN by step {died}" if died
                      else f"stable through {args.steps}")
            log(f"{tag} seed {seed}: {status}")
            records.append({"tag": tag, "seed": seed, "died": died,
                            "status": status,
                            "q": sim.state.q.detach().cpu().double().numpy()})
    return records


if __name__ == "__main__":
    main()
