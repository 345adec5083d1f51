#!/usr/bin/env python
"""Multi-temperature water RDF fit with the PyTorch/CUDA port
(mdgrad_tpu_torch): one potential trained on every state point with one
summed gradient an epoch (``train/fit_rdf_multi.py``), the state points
one after another on one device.

The flags, defaults and assignments of ``scripts/run_water_multi.py`` --
the GNN ("low" SchNet, cutoff 6.0, 109 bins, 52-step epochs) or with
``--tpair`` the T-dependent pair MLP (192-step epochs) over H20_298K_redd,
H20_308K_redd and H20_338K_redd at 512 sites -- plus ``-device`` (default
``cuda``; ``cpu`` for a run without a card) and ``-backtrack_after`` (the
consecutive failures that trigger a backtrack).

    python scripts/run_water_multi_torch.py                  # on the card
    python scripts/run_water_multi_torch.py --tpair -nepochs 100
    python scripts/run_water_multi_torch.py --dry_run -device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build(argv=None):
    """(assignments, sys_params, args) from the command line ``argv``."""
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/water_multi")
    p.add_argument("-data", type=str, nargs="+",
                   default=["H20_298K_redd", "H20_308K_redd",
                            "H20_338K_redd"])
    p.add_argument("-val", type=str, nargs="+", default=None,
                   help="held-out state points: evaluated at inference "
                        "with the trained parameters, never trained on")
    p.add_argument("-nepochs", type=int, default=500)
    p.add_argument("-nsim", type=int, default=10)
    p.add_argument("-size", type=int, default=4)
    p.add_argument("-frame_skip", type=int, default=20)
    p.add_argument("-lr", type=float, default=None)
    p.add_argument("-compute_dtype", type=str, default="float32")
    p.add_argument("--tpair", action="store_true",
                   help="the temperature-dependent TPairMLP u(r, kT), each "
                        "state point's kT set before its epoch")
    p.add_argument("-capacity_slack", type=float, default=2.0)
    p.add_argument("-overflow_policy", type=str, default="warn",
                   choices=["warn", "skip", "regrow"])
    p.add_argument("-regrow_factor", type=float, default=1.5)
    p.add_argument("-u_reg_weight", type=float, default=0.0,
                   help="well-depth guard weight (pair/tpair)")
    p.add_argument("-u_floor_mult", type=float, default=1.5)
    p.add_argument("-pretrain", type=int, default=1000)
    p.add_argument("-lr_schedule", type=str, default="plateau",
                   choices=["plateau", "cosine"])
    p.add_argument("-cosine_alpha", type=float, default=0.05)
    p.add_argument("-backtrack_every", type=int, default=10,
                   help="snapshot cadence of the backtrack recovery")
    p.add_argument("-backtrack_after", type=int, default=2,
                   help="consecutive non-finite epochs that trigger a "
                        "backtrack")
    p.add_argument("-max_backtracks", type=int, default=8)
    p.add_argument("--dt_backoff", action="store_true",
                   help="halve the training dt for dt_hold clean epochs "
                        "after each backtrack")
    p.add_argument("-dt_hold", type=int, default=20)
    p.add_argument("-seed", type=int, default=0,
                   help="seed of the lattice momenta and rethermalize draws")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)

    if args.tpair:
        # the pair-MLP assignments; 109 bins for the multistate soft RDF
        assignments = {
            "cutoff": 6.0, "epsilon": 1.8245160642515632,
            "gaussian_width": 0.15, "lr": args.lr or 0.0006548601438181719,
            "n_layers": 3, "n_width": 115, "nbins": 109,
            "nonlinear": "ELU", "opt_freq": 192, "power": 12,
            "sigma": 1.68191635809129,
        }
    else:
        # the GNN assignments of scripts/run_water.py
        assignments = {
            "cutoff": 6.0, "epsilon": 0.010637550996566496,
            "gaussian_width": 0.195, "lr": args.lr or 0.0001839,
            "n_atom_basis": "low", "n_filters": "low", "n_convolutions": 2,
            "nbins": 109, "opt_freq": 52, "sigma": 2.61227614490785,
            "compute_dtype": args.compute_dtype,
        }
    sys_params = {
        "dt": 0.5, "n_epochs": args.nepochs, "n_sim": args.nsim,
        "data": args.data, "val": args.val, "size": args.size,
        "frame_skip": args.frame_skip, "topology_update_freq": 1,
        "tpair_flag": args.tpair, "capacity_slack": args.capacity_slack,
        "overflow_policy": args.overflow_policy,
        "regrow_factor": args.regrow_factor,
        "u_reg_weight": args.u_reg_weight,
        "u_floor_mult": args.u_floor_mult,
        "pretrain_iters": args.pretrain,
        "lr_schedule": args.lr_schedule,
        "cosine_alpha": args.cosine_alpha,
        "backtrack_every": args.backtrack_every,
        "backtrack_after": args.backtrack_after,
        "max_backtracks": args.max_backtracks,
        "dt_backoff": args.dt_backoff,
        "dt_hold": args.dt_hold,
    }
    if args.dry_run:
        assignments["opt_freq"] = 25
        sys_params.update(n_epochs=2, n_sim=1, size=2, frame_skip=5,
                          test_nbins=100, pretrain_iters=50)
    return assignments, sys_params, args


def main():
    assignments, sys_params, args = build()
    import numpy as np
    from mdgrad_tpu_torch.train.fit_rdf_multi import fit_rdf_multistate
    out = fit_rdf_multistate(assignments, sys_params,
                             model_path=os.path.join(args.logdir, "0"),
                             rng=np.random.default_rng(args.seed),
                             device=args.device)
    print("objective:", out["objective"])
    for tag, fin in out.get("final", {}).items():
        print(f"  {tag}: mse {fin['mse']:.4f}")
    if out.get("nan_bailout"):
        print(f"NaN bailout at epoch {out.get('bailout_epoch')} -- "
              "inference salvaged from the last-good snapshot")


if __name__ == "__main__":
    main()
