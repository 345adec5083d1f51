#!/usr/bin/env python
"""The first few hundred steps of the 4096-site a-Si melt, instrumented,
with the PyTorch/CUDA port: ``scripts/diag_si4k.py``'s flags, defaults and
loop, plus ``-device`` (default ``cuda``; ``cpu`` for a run without a
card).

The trained a-Si SchNet (``-ckpt``, default the JAX fit checkpoint
``results/si_r2/0/fit-ckpt-5699.pkl``, its ``params['nn']`` read by
``train/checkpoint.py::read_jax_pickle``; a ``fit-ckpt-<epoch>.pt`` of
``scripts/run_si_torch.py`` also serves) drives the transfer's stack,
built by ``build_fit`` with the fit's model settings, over its frozen
ExcludedVolume prior.  The thermostat is set to ``-start_T`` and, with
``-hot_start``, the velocities are drawn at it from the seed-0 generator
that built the system; then ``-nchunks`` chunks of ``-chunk`` steps (an
epoch of ``chunk - 1`` steps each, as the JAX loop's ``simulate``), the
MTK chain masses at ``-nhc_tau`` dt.  After each chunk one line: the
kinetic temperature, max |f|, max |v|, the bath momenta, the last
table's overflow flag and whether every position is finite; at the
first non-finite position the atoms that hold one, and the run stops.

At size 8 on the card the SchNet runs on the ``'cells'`` table at 4096
rows: K1 in each energy, K2a and K2b in the force's backward, and the
CSR build on its grid path every energy.

    python scripts/diag_si4k_torch.py                 # on the card
    python scripts/diag_si4k_torch.py -size 2 -nbr_mode table -device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-ckpt", type=str,
                   default="results/si_r2/0/fit-ckpt-5699.pkl")
    p.add_argument("-data", type=str, default="Si_2.293_100K")
    p.add_argument("-size", type=int, default=8)
    p.add_argument("-nbr_mode", type=str, default="cells")
    p.add_argument("-capacity_slack", type=float, default=3.0)
    p.add_argument("-start_T", type=float, default=1500.0)
    p.add_argument("-nhc_tau", type=float, default=50.0)
    p.add_argument("-chunk", type=int, default=10)
    p.add_argument("-nchunks", type=int, default=30)
    p.add_argument("-hot_start", type=int, default=1)
    p.add_argument("-compute_dtype", type=str, default="float32")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def diag_config(args):
    """(assignments, sys_params) of the JAX diagnostic: the a-Si fit's
    model settings (the checkpoint's tree must fit the SchNet)."""
    from mdgrad_tpu_torch import units
    from mdgrad_tpu_torch.data.registry import exp_rdf_data_dict
    assignments = {
        "cutoff": 5.0, "epsilon": 0.05, "gaussian_width": 0.125,
        "n_atom_basis": "tiny", "n_filters": "low", "n_convolutions": 3,
        "nbins": 800, "rdf_backend": "pallas", "opt_freq": 40,
        "sigma": 2.0, "start_T": args.start_T, "anneal_freq": 2,
        "anneal_rate": 5.0, "lr": 0.0,
        "compute_dtype": args.compute_dtype,
    }
    sys_params = {
        "dt": 1.0, "n_epochs": 10, "n_sim": 20,
        "data": [args.data], "val": None, "size": args.size,
        "anneal_flag": "True", "pair_flag": False, "tpair_flag": False,
        "topology_update_freq": 1, "nbr_mode": args.nbr_mode,
        "capacity_slack": args.capacity_slack,
    }
    entry = exp_rdf_data_dict[args.data]
    time_unit = 1.0 if entry.get("reduced_units") else units.fs
    if args.nhc_tau > 0:
        sys_params["nhc_tau"] = args.nhc_tau * sys_params["dt"] * time_unit
    return assignments, sys_params


def main(argv=None, log=print, dtype=None):
    """Run the diagnostic; ``argv`` the flags (default ``sys.argv[1:]``),
    ``log`` takes each line, ``dtype`` the MD's and the model's (default
    float32; float64 for parity checks).  Returns one dict a chunk:
    ``chunk``, ``step`` (the JAX line's nominal step), ``T_kin`` (K),
    ``max_f``, ``max_v``, ``pv`` (a list), ``overflow`` (the last
    table's flag), ``finite``, ``bad_atoms`` (those with a non-finite
    position) and ``seconds`` (the chunk's wall time, its readout
    included)."""
    args = parse_args(argv)
    import torch
    from mdgrad_tpu_torch import thermo, units
    from mdgrad_tpu_torch.data.registry import exp_rdf_data_dict
    from mdgrad_tpu_torch.topology import aux_overflow
    from mdgrad_tpu_torch.train.checkpoint import load_schnet_checkpoint
    from mdgrad_tpu_torch.train.fit_rdf import build_fit

    dtype = torch.float32 if dtype is None else dtype
    dev = torch.device(args.device)
    if dev.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(dev)}")
    else:
        log(f"device: {dev}")
    assignments, sys_params = diag_config(args)
    entry = exp_rdf_data_dict[args.data]
    time_unit = 1.0 if entry.get("reduced_units") else units.fs
    rng = np.random.default_rng(0)
    built = build_fit(assignments, sys_params, registry=exp_rdf_data_dict,
                      rng=rng, device=args.device, dtype=dtype)
    system, sim = built["systems"][0], built["sims"][0]
    n = system.get_number_of_atoms()
    masses = system.get_masses()
    log(f"{n} atoms; Q = {sim.integrator.Q.cpu().numpy()}")
    load_schnet_checkpoint(built["net"], args.ckpt)

    dt = sys_params["dt"] * time_unit
    sim.integrator.update_T(args.start_T)
    if args.hot_start:
        system.set_temperature(args.start_T, rng=rng)

    records = []
    for c in range(args.nchunks):
        t0 = time.perf_counter()
        sim.simulate(steps=args.chunk, dt=dt, frequency=args.chunk)
        st = sim.state
        v = st.v.detach().cpu().double().numpy()
        q = st.q.detach().cpu().double().numpy()
        f = st.f.detach().cpu().double().numpy()
        pv = st.pv.detach().cpu().double().numpy()
        T_k = float(thermo.temperature(st.v, masses, dim=3)) / units.kB
        ovf = aux_overflow(sim.aux) if sim.aux is not None else False
        finite = bool(np.isfinite(q).all())
        bad = np.where(~np.isfinite(q).any(axis=-1))[0]
        rec = {"chunk": c, "step": (c + 1) * args.chunk, "T_kin": T_k,
               "max_f": float(np.abs(f).max()),
               "max_v": float(np.abs(v).max()), "pv": pv.tolist(),
               "overflow": bool(ovf), "finite": finite,
               "bad_atoms": bad.tolist(),
               "seconds": time.perf_counter() - t0}
        records.append(rec)
        log(f"chunk {c:3d} (step {rec['step']:4d}): "
            f"T_kin {T_k:9.1f} K  max|f| {rec['max_f']:11.4g}  "
            f"max|v| {rec['max_v']:9.4g}  pv "
            f"{np.array2string(pv, precision=2)}  "
            f"overflow={rec['overflow']}  finite(q)={finite}")
        if not finite:
            log(f"  non-finite positions at atoms {bad[:20]}")
            break
    return records


if __name__ == "__main__":
    main()
