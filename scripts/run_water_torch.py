#!/usr/bin/env python
"""Water O-O RDF fit with the PyTorch/CUDA port (mdgrad_tpu_torch).

The flags, defaults and GNN assignments of ``scripts/run_water.py`` (the
"low" SchNet: 128/128, 30 Gaussians, 2 convolutions, cutoff 6.0; a 4^3
diamond lattice of 512 O sites at 298 K, dt 0.5 fs, 52-step epochs),
plus ``-device`` (default ``cuda``; ``cpu`` for a run without a card).
``-compute_dtype`` takes ``float32``, ``bf16`` and ``mixed``,
``-nbr_mode`` ``table``, ``cells`` (the table built through the cell
list: the large-N path of the 4096-site fit, ``-size 8``), ``topk``
and ``sparse``, and ``-gnn_skin`` the Verlet skin (with ``-update_freq``
for its refresh cadence).  ``--angle`` adds the water angle-distribution
target (``-angle_cutoff`` 2.7 or 3.7 picks its file).  ``--pair`` and
``--tpair`` fit a PairMLP / TPairMLP (width 115, 3 layers, ELU, 400 bins,
192-step epochs) after Boltzmann-inversion pretraining, with
``-rdf_backend pallas`` through the RDF kernels.  ``-mts k`` integrates
with the multiple-time-step chain (the prior at dt / k) and
``--share_prior_aux`` hands the SchNet's table to the prior.
``--dry_run`` runs 2 epochs of 24 steps at size 2 (64 sites), or size 3
(216 sites) with ``-nbr_mode cells``, whose cells need 3 a side of at
least the 6.0 A cutoff.

    python scripts/run_water_torch.py                        # on the card
    python scripts/run_water_torch.py -size 8 -nbr_mode cells \
        -rdf_backend pallas -frame_skip 1                    # 4096 sites
    python scripts/run_water_torch.py --angle
    python scripts/run_water_torch.py -compute_dtype bf16 -gnn_skin 0.5 \
        -update_freq 3
    python scripts/run_water_torch.py --pair -rdf_backend pallas
    python scripts/run_water_torch.py --dry_run -device cpu  # a quick check
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/water")
    p.add_argument("-data", type=str, nargs="+",
                   default=["H20_298K_redd"])
    p.add_argument("-val", type=str, nargs="+", default=None)
    p.add_argument("-nepochs", type=int, default=700)
    p.add_argument("-nsim", type=int, default=20)
    p.add_argument("-nruns", type=int, default=1)
    p.add_argument("--pair", action="store_true")
    p.add_argument("--tpair", action="store_true")
    p.add_argument("--angle", action="store_true",
                   help="add the water angle-distribution target")
    p.add_argument("-angle_cutoff", type=float, default=3.7)
    p.add_argument("-angle_weight", type=float, default=1.0)
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("-compute_dtype", type=str, default="float32",
                   help="SchNet dtype: float32, bf16 or mixed")
    p.add_argument("-rdf_backend", type=str, default="xla",
                   help="'pallas' counts the soft histogram with the "
                        "K3/K4 kernels and their K3b/K4b backward (the "
                        "fast path for the pair fits' 400 bins)")
    p.add_argument("-frame_skip", type=int, default=20)
    p.add_argument("-capacity_slack", type=float, default=1.6,
                   help="neighbor-table k_max headroom")
    p.add_argument("-size", type=int, default=4,
                   help="diamond supercell size (size^3 * 8 sites)")
    p.add_argument("-mts", type=int, default=0)
    p.add_argument("-Q", type=float, default=None,
                   help="NHC bath mass (default 50)")
    p.add_argument("-nhc_tau", type=float, default=None,
                   help="MTK thermostat time constant in fs (overrides -Q)")
    p.add_argument("-lr_override", type=float, default=None,
                   help="learning-rate override (0 freezes training)")
    p.add_argument("-prior_mode", type=str, default="auto",
                   help="prior PairPotentials mode (dense|sparse|table|"
                        "auto); auto is dense for N^2 <= 2^20, else sparse")
    p.add_argument("-dt_override", type=float, default=None,
                   help="time step in fs (default 0.5)")
    p.add_argument("-overflow_policy", type=str, default="warn",
                   help="neighbor-capacity overflow handling: 'warn', "
                        "'skip' (drop the epoch's update) or 'regrow' "
                        "(grow capacity, restore the epoch entry state)")
    p.add_argument("-regrow_factor", type=float, default=1.5)
    p.add_argument("-init_pkl", type=str, default=None,
                   help="parameters-only warm start from a JAX pickle "
                        "(a fit checkpoint) whose params hold 'nn'")
    p.add_argument("-nbr_mode", type=str, default="table")
    p.add_argument("--share_prior_aux", action="store_true")
    p.add_argument("-gnn_skin", type=float, default=0.0)
    p.add_argument("-update_freq", type=int, default=1,
                   help="topology refresh cadence (steps)")
    p.add_argument("-adjoint", type=int, default=1,
                   help="1 = trajectory-replay adjoint; 0 = direct "
                        "backprop through the steps")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    args = p.parse_args()

    from mdgrad_tpu_torch import units
    from mdgrad_tpu_torch.train.fit_rdf import fit_rdf

    if args.pair or args.tpair:
        # the pair-MLP assignments of scripts/run_water.py
        assignments = {
            "cutoff": 6.0, "epsilon": 1.8245160642515632,
            "gaussian_width": 0.15,
            "lr": 0.0006548601438181719, "mse_weight": 0.345,
            "n_layers": 3, "n_width": 115, "nbins": 400,
            "nonlinear": "ELU", "opt_freq": 192, "power": 12,
            "sigma": 1.68191635809129,
        }
    else:
        # the GNN assignments of scripts/run_water.py
        assignments = {
            "cutoff": 6.0, "epsilon": 0.010637550996566496,
            "gaussian_width": 0.195, "lr": 0.0001839,
            "mse_weight": 3.2, "n_atom_basis": "low",
            "n_filters": "low", "n_convolutions": 2,
            "nbins": 109, "opt_freq": 52, "sigma": 2.61227614490785,
        }
    sys_params = {
        "dt": args.dt_override or 0.5,
        "n_epochs": args.nepochs, "n_sim": args.nsim,
        "data": args.data, "val": args.val, "size": args.size,
        "anneal_flag": "False", "pair_flag": args.pair,
        "tpair_flag": args.tpair,
        "topology_update_freq": args.update_freq,
        "adjoint": bool(args.adjoint),
        "share_prior_aux": args.share_prior_aux,
        "gnn_skin": args.gnn_skin,
        "capacity_slack": args.capacity_slack,
        "nbr_mode": args.nbr_mode,
        "mts_inner": args.mts,
        "frame_skip": args.frame_skip,
        "overflow_policy": args.overflow_policy,
        "regrow_factor": args.regrow_factor,
        "prior_mode": args.prior_mode,
        "init_pkl": args.init_pkl,
    }
    if args.lr_override is not None:
        assignments["lr"] = args.lr_override
    if args.Q is not None:
        sys_params["Q"] = args.Q
    if args.nhc_tau is not None:
        sys_params["nhc_tau"] = args.nhc_tau * units.fs
    assignments["rdf_backend"] = args.rdf_backend
    if args.angle:
        assignments.update(angle_weight=args.angle_weight,
                           angle_cutoff=args.angle_cutoff,
                           angle_nbins=64, angle_start=0.5)
        sys_params.update(angle_flag=True, angle_k_max=24)

    if args.dry_run:
        assignments["opt_freq"] = 25
        sys_params.update(n_epochs=2, n_sim=1,
                          size=3 if args.nbr_mode == "cells" else 2,
                          frame_skip=5, test_nbins=100, pretrain_iters=50)

    if not (args.pair or args.tpair):
        assignments["compute_dtype"] = args.compute_dtype

    for i in range(args.nruns):
        out = fit_rdf(assignments, sys_params,
                      model_path=os.path.join(args.logdir, str(i)),
                      device=args.device)
        print("objective:", out["objective"])


if __name__ == "__main__":
    main()
