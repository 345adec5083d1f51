#!/usr/bin/env python
"""a-Si size transfer with the PyTorch/CUDA port: the 512-site fit's
SchNet driving MD in a 4096-site cell.

The flags and protocol of ``scripts/si_transfer.py``, plus ``-device``
(default ``cuda``; ``cpu`` for a run without a card).  SchNet's weights
do not depend on the box size, so the potential that
``scripts/run_si_torch.py`` fit at size 4 (512 sites) drives MD at
``-size`` 8 (4096 sites) on the cell-list table (``-nbr_mode cells``).
The fit stack is rebuilt with the training run's model settings, the
checkpoint loaded into its SchNet, then: the melt-quench anneal (1500 K
-> the target's 100 K) as inference-only MD, an equilibration at the
target, and the 800-bin RDF (the K3/K4 kernels on the card) averaged
over the sampling epochs' frames and scored against the experimental
target.

``-ckpt`` is a ``fit-ckpt-<epoch>.pt`` that ``scripts/run_si_torch.py``
wrote (read with ``torch.load(weights_only=True)``) or a JAX fit
checkpoint (``.pkl``, its ``params['nn']`` read by
``train/checkpoint.py::read_jax_pickle``); the default is the JAX
script's, the trained a-Si SchNet ``results/si_r2/0/fit-ckpt-5699.pkl``
(a path relative to the working directory, as there).  ``--dry_run``:
size 2 (64 sites) on the ``table`` path (a size-2 box holds fewer than 3
cells of the cutoff's width a side), 4 anneal, 2 equilibration and 2
sampling epochs, 100 bins.

Writes ``rdf_<tag>_<N>.csv``, ``transfer.json`` and the RDF plot under
``-logdir``.

    python scripts/si_transfer_torch.py           # the trained JAX model
    python scripts/si_transfer_torch.py -ckpt outputs/si/0/fit-ckpt-999.pt
    python scripts/si_transfer_torch.py --dry_run -device cpu
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-ckpt", type=str,
                   default="results/si_r2/0/fit-ckpt-5699.pkl",
                   help="a fit-ckpt-<epoch>.pt of scripts/run_si_torch.py "
                        "or a JAX fit checkpoint (.pkl)")
    p.add_argument("-data", type=str, default="Si_2.293_100K")
    p.add_argument("-size", type=int, default=8)
    p.add_argument("-nbr_mode", type=str, default="cells")
    p.add_argument("-capacity_slack", type=float, default=3.0,
                   help="sized off the crystal's neighbor count; the "
                        "1500 K melt densifies the first shell")
    p.add_argument("-anneal_epochs", type=int, default=500)
    p.add_argument("-equil_epochs", type=int, default=60)
    p.add_argument("-sample_epochs", type=int, default=40)
    p.add_argument("-opt_freq", type=int, default=40)
    p.add_argument("-start_T", type=float, default=1500.0)
    p.add_argument("-anneal_rate", type=float, default=5.0)
    p.add_argument("-compute_dtype", type=str, default="float32")
    p.add_argument("-nhc_tau", type=float, default=50.0,
                   help="MTK thermostat time constant in units of dt")
    p.add_argument("-logdir", type=str, default="outputs/si_4k")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    args = p.parse_args(argv)
    if args.dry_run:
        args.size, args.anneal_epochs = 2, 4
        args.equil_epochs, args.sample_epochs = 2, 2
        args.nbr_mode = "table"  # a size-2 box < 3 cells of cutoff width
    return args


def transfer_config(args):
    """(assignments, sys_params): the training run's model settings (the
    checkpoint's state dict must fit the SchNet), 800 bins on the pallas
    RDF backend, the MTK chain masses at ``nhc_tau`` dt (tau = 50 dt
    keeps every link of the chain at its thermal scale through the
    4096-site melt transient)."""
    from mdgrad_tpu_torch import units
    from mdgrad_tpu_torch.data.registry import exp_rdf_data_dict
    assignments = {
        "cutoff": 5.0, "epsilon": 0.05, "gaussian_width": 0.125,
        "n_atom_basis": "tiny", "n_filters": "low", "n_convolutions": 3,
        "nbins": 100 if args.dry_run else 800, "rdf_backend": "pallas",
        "opt_freq": args.opt_freq, "sigma": 2.0, "start_T": args.start_T,
        "anneal_freq": 2, "anneal_rate": args.anneal_rate, "lr": 0.0,
        "compute_dtype": args.compute_dtype,
    }
    sys_params = {
        "dt": 1.0, "n_epochs": args.anneal_epochs, "n_sim": 20,
        "data": [args.data], "val": None, "size": args.size,
        "anneal_flag": "True", "pair_flag": False, "tpair_flag": False,
        "topology_update_freq": 1, "nbr_mode": args.nbr_mode,
        "capacity_slack": args.capacity_slack,
    }
    time_unit = (1.0 if exp_rdf_data_dict[args.data].get("reduced_units")
                 else units.fs)
    sys_params["nhc_tau"] = args.nhc_tau * sys_params["dt"] * time_unit
    return assignments, sys_params


def main(argv=None, log=print):
    """Run the transfer; ``argv`` the flags (default ``sys.argv[1:]``),
    ``log`` takes each progress line.  Returns a dict: ``mse``,
    ``n_atoms``, ``frames``, ``seconds`` (``build``, ``anneal``,
    ``equil``, ``sample``), ``sim`` (the simulation, at its last state),
    ``obs`` (the RDF) and ``last_frames`` (the last sampling epoch's
    positions, (25, N, 3))."""
    args = parse_args(argv)
    import torch
    from mdgrad_tpu_torch import units
    from mdgrad_tpu_torch.data.registry import exp_rdf_data_dict
    from mdgrad_tpu_torch.topology import aux_overflow
    from mdgrad_tpu_torch.train.checkpoint import load_schnet_checkpoint
    from mdgrad_tpu_torch.train.fit_rdf import (build_fit, get_temp,
                                                registry_T_kelvin)
    from mdgrad_tpu_torch.train.plots import plot_rdfs

    os.makedirs(args.logdir, exist_ok=True)
    assignments, sys_params = transfer_config(args)
    rng = np.random.default_rng(0)
    entry = exp_rdf_data_dict[args.data]
    time_unit = 1.0 if entry.get("reduced_units") else units.fs
    seconds = {}
    t0 = time.perf_counter()
    built = build_fit(assignments, sys_params, registry=exp_rdf_data_dict,
                      rng=rng, device=args.device)
    system, sim = built["systems"][0], built["sims"][0]
    obs, g_obs, x = (built["observers"][0], built["targets"][0],
                     built["r_axes"][0])
    n_atoms = system.get_number_of_atoms()
    log(f"system: {n_atoms} atoms, cell {np.diag(system.get_cell())}")
    epoch = load_schnet_checkpoint(built["net"], args.ckpt)
    log(f"loaded {args.ckpt} (epoch {epoch})")
    seconds["build"] = time.perf_counter() - t0

    T_equil = registry_T_kelvin(entry)
    dt = sys_params["dt"] * time_unit
    integ = sim.integrator
    tau = args.opt_freq

    def check(tag, i):
        if not bool(torch.isfinite(sim.state.q).all()):
            raise RuntimeError(f"NaN during {tag} at epoch {i}")
        if sim.aux is not None and aux_overflow(sim.aux):
            log(f"WARNING: neighbor overflow during {tag} epoch {i}")

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        if str(args.device).startswith("cuda"):
            torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t
        return out

    # the melt-quench anneal (inference-only MD, frozen parameters); the
    # hot start puts the velocities at the melt temperature
    system.set_temperature(args.start_T, rng=rng)

    def anneal():
        for i in range(args.anneal_epochs):
            if i % assignments["anneal_freq"] == 0:
                integ.update_T(get_temp(args.start_T, T_equil,
                                        args.anneal_epochs, i,
                                        args.anneal_rate))
            sim.simulate(steps=tau, dt=dt, frequency=tau)
            check("anneal", i)
            if i % 50 == 0:
                log(f"anneal epoch {i}")

    def equil():
        integ.update_T(T_equil)
        for i in range(args.equil_epochs):
            sim.simulate(steps=tau, dt=dt, frequency=tau)
            check("equil", i)

    def sample():
        gs, frames = [], None
        with torch.no_grad():
            for i in range(args.sample_epochs):
                frames = sim.simulate(steps=100, dt=dt, frequency=25).q
                check("sample", i)
                gs.extend(obs(f)[2].cpu().numpy() for f in frames)
        return gs, frames

    timed("anneal", anneal)
    timed("equil", equil)
    gs, frames = timed("sample", sample)
    g_sim = np.mean(gs, axis=0)
    g_obs = g_obs.cpu().numpy()
    mse = float(((g_obs - g_sim) ** 2).mean())
    log(f"{args.data} @ {n_atoms} atoms: {assignments['nbins']}-bin "
        f"inference MSE {mse:.5f} ({len(gs)} frames)")

    np.savetxt(os.path.join(args.logdir, f"rdf_{args.data}_{n_atoms}.csv"),
               np.vstack([x, g_sim]), delimiter=",")
    with open(os.path.join(args.logdir, "transfer.json"), "w") as f:
        json.dump({"ckpt": args.ckpt, "n_atoms": int(n_atoms),
                   "size": args.size, "nbr_mode": args.nbr_mode,
                   "anneal_epochs": args.anneal_epochs,
                   "equil_epochs": args.equil_epochs,
                   "sample_frames": len(gs), "mse": mse}, f, indent=2)
    plot_rdfs(x, g_obs, g_sim, f"rdf_{args.data}_{n_atoms}", args.logdir,
              pname="transfer")
    return {"mse": mse, "n_atoms": int(n_atoms), "frames": len(gs),
            "seconds": seconds, "sim": sim, "obs": obs,
            "last_frames": frames}


if __name__ == "__main__":
    main()
