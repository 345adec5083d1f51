#!/usr/bin/env python
"""Amorphous-silicon RDF fit with the PyTorch/CUDA port (mdgrad_tpu_torch).

The flags, defaults and assignments of ``scripts/run_si.py``: a 4^3
diamond lattice of 512 Si sites at the ``Si_2.293_100K`` target, SchNet
with ``n_atom_basis`` "tiny" (64), ``n_filters`` "low" (128), 3
convolutions, cutoff 5.0, a 0.125 A Gaussian width, the ExcludedVolume
prior at epsilon 0.05, sigma 2.0; a melt-quench anneal from ``-start_T``
(1500 K) to the target's 100 K, the temperature moved every 2 epochs;
dt 1 fs, 40-step epochs, 119 bins.  Plus ``-device`` (default ``cuda``;
``cpu`` for a run without a card).  ``-rdf_backend pallas``
counts the soft histogram with the K3/K4 kernels and their K3b/K4b
backward.  ``--dry_run`` runs 2 epochs of 25 steps at size 2 (64 sites),
one rollout, a 100-bin inference RDF.  Checkpoints are
``fit-ckpt-<epoch>.pt`` under ``-logdir/0``; ``scripts/si_transfer_torch.py``
reads them.

    python scripts/run_si_torch.py                          # on the card
    python scripts/run_si_torch.py -rdf_backend pallas -nbins 800
    python scripts/run_si_torch.py --dry_run -device cpu    # a quick check
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/si")
    p.add_argument("-data", type=str, nargs="+", default=["Si_2.293_100K"])
    p.add_argument("-nepochs", type=int, default=1000)
    p.add_argument("-cutoff", type=float, default=5.0)
    p.add_argument("-opt_freq", type=int, default=40)
    p.add_argument("-start_T", type=float, default=1500.0)
    p.add_argument("-anneal_rate", type=float, default=5.0)
    p.add_argument("-epsilon", type=float, default=0.05)
    p.add_argument("-sigma", type=float, default=2.0)
    p.add_argument("-lr", type=float, default=2e-4)
    p.add_argument("-nbins", type=int, default=119)
    p.add_argument("-rdf_backend", type=str, default="xla",
                   choices=["xla", "pallas"],
                   help="'pallas' counts the soft histogram with the K3/K4 "
                        "kernels; use it for high-resolution (-nbins 800) "
                        "refinement")
    p.add_argument("-compute_dtype", type=str, default="float32")
    p.add_argument("--no_anneal", action="store_true")
    p.add_argument("--reset_opt", action="store_true",
                   help="fresh optimizer when resuming from a checkpoint")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p.parse_args(argv)


def fit_config(args):
    """(assignments, sys_params) of the fit.  The melt-quench anneal
    (1500 K -> 100 K) disorders the cold diamond crystal towards the
    amorphous target; the 5 A cutoff covers the second Si shell (~3.8 A);
    the stronger ExcludedVolume prior closes the learned short-range
    hole."""
    assignments = {
        "cutoff": args.cutoff, "epsilon": args.epsilon,
        "gaussian_width": 0.125, "lr": args.lr,
        "n_atom_basis": "tiny", "n_filters": "low",
        "n_convolutions": 3, "nbins": args.nbins,
        "rdf_backend": args.rdf_backend, "opt_freq": args.opt_freq,
        "sigma": args.sigma, "start_T": args.start_T, "anneal_freq": 2,
        "anneal_rate": args.anneal_rate,
        "compute_dtype": args.compute_dtype,
    }
    sys_params = {
        "dt": 1.0, "n_epochs": args.nepochs, "n_sim": 20,
        "data": args.data, "val": None, "size": 4,
        "anneal_flag": "False" if args.no_anneal else "True",
        "pair_flag": False, "tpair_flag": False,
        "topology_update_freq": 1,
        "reset_opt_on_resume": args.reset_opt,
    }
    if args.dry_run:
        assignments["opt_freq"] = 25
        sys_params.update(n_epochs=2, n_sim=1, size=2, frame_skip=5,
                          test_nbins=100)
    return assignments, sys_params


def main(argv=None, log=print):
    """Run the fit; ``argv`` the flags (default ``sys.argv[1:]``), ``log``
    takes each progress line.  Returns ``fit_rdf``'s result dict."""
    args = parse_args(argv)
    from mdgrad_tpu_torch.train.fit_rdf import fit_rdf
    assignments, sys_params = fit_config(args)
    out = fit_rdf(assignments, sys_params,
                  model_path=os.path.join(args.logdir, "0"), log=log,
                  device=args.device)
    print("objective:", out["objective"])
    return out


if __name__ == "__main__":
    main()
