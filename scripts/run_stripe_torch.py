#!/usr/bin/env python
"""2-D stripe-phase pair-potential fit with the PyTorch/CUDA port.

The flags, defaults and assignments of ``scripts/run_stripe.py``: the
registry's 2-D stripe systems (``overlap_0.9766_T0.07``: 40 x 40 = 1600
sites on a square lattice, reduced units, kT = 0.07, the SplineOverlap
ground truth) through ``fit_lj``: a PairMLP (width 128, 3 layers, SELU,
cutoff 8.0, 0.1 Gaussian width, 128 bins) over the bounded GaussianCore
prior (epsilon 2.0, sigma 0.55; a hard r^-12 prior leaves a cliff below
the data range after Boltzmann-inversion pretraining), 60-step epochs,
every 5th frame in the RDF.  Plus ``-device`` (default ``cuda``; ``cpu``
for a run without a card).  ``--dry_run``: 2 epochs of 11 steps, 30
pretraining iterations, a 5-step VACF window.

    python scripts/run_stripe_torch.py                       # on the card
    python scripts/run_stripe_torch.py --dry_run -device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/stripe")
    p.add_argument("-data", type=str, nargs="+",
                   default=["overlap_0.9766_T0.07"])
    p.add_argument("-cutoff", type=float, default=8.0)
    p.add_argument("-dt", type=float, default=0.005)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-sigma", type=float, default=0.55)
    p.add_argument("-pretrain", type=int, default=1000)
    p.add_argument("-nepochs", type=int, default=300)
    p.add_argument("-opt_freq", type=int, default=60,
                   help="MD steps per epoch")
    p.add_argument("-frame_skip", type=int, default=5,
                   help="RDF frame subsampling; 1 averages every step")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' or 'cpu'")
    return p.parse_args(argv)


def fit_config(args):
    """(assignments, sys_params) of the stripe fit."""
    assignments = {
        "nbins": 128, "opt_freq": args.opt_freq, "lr": args.lr,
        "sigma": args.sigma, "gaussian_width": 0.1, "n_width": 128,
        "n_layers": 3, "nonlinear": "SELU",
        "rdf_weight": 1.0, "vacf_weight": 0.0, "train_vacf": "False",
        "prior": "gauss", "prior_epsilon": 2.0,
    }
    sys_params = {
        "size": 25, "cutoff": args.cutoff, "t_range": 20,
        "n_epochs": args.nepochs, "n_sim": 10, "data": args.data,
        "val": None, "topology_update_freq": 1,
        "pretrain_iters": args.pretrain, "dt": args.dt,
        "frame_skip": args.frame_skip,
    }
    if args.dry_run:
        assignments["opt_freq"] = 11
        sys_params.update(n_epochs=2, n_sim=1, t_range=5,
                          frame_skip=2, pretrain_iters=30)
    return assignments, sys_params


def main(argv=None, log=print):
    """Run the fit; returns ``fit_lj``'s result dict."""
    args = parse_args(argv)
    from mdgrad_tpu_torch.train.fit_rdf_pair import fit_lj
    assignments, sys_params = fit_config(args)
    out = fit_lj(assignments, sys_params,
                 model_path=os.path.join(args.logdir, "0"), log=log,
                 device=args.device)
    print("objective:", out["objective"])
    return out


if __name__ == "__main__":
    main()
