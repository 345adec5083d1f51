#!/usr/bin/env python
"""Polymer folding with the PyTorch/CUDA port (mdgrad_tpu_torch):
``scripts/run_fold.py``'s flags and parameters, plus ``-device`` (default
``cuda``; ``cpu`` for a run without a card).

A 50-atom straight chain learns to fold toward a helix: SchNet (64/64, 32
Gaussians, 3 convolutions, cutoff 4.0) over a harmonic-bond prior and an
excluded-volume pair term, trained through 49-frame epochs (dt 0.02) of
the Nose-Hoover chain (``-method NH_verlet`` or ``rk4``) or NVE
(``verlet``).  ``--dry_run`` is the tiny chain of 16 atoms for 3 epochs.

    python scripts/run_fold_torch.py                      # on the card
    python scripts/run_fold_torch.py --dry_run -device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PARAMS = {
    "n_atoms": 50, "n_spiral": 10, "a_spiral": 1.5,
    "dz_spiral": 0.25, "loss_cutoff": 5.0, "k0": 2.0,
    "epsilon": 0.1, "sigma": 1.0, "n_atom_basis": 64,
    "n_filters": 64, "n_gaussians": 32, "n_convolutions": 3,
    "cutoff": 4.0, "T": 0.05, "method": "NH_verlet", "dt": 0.02,
    "tau": 49, "lr": 1e-3, "l_b": 1.0, "l_a": 1.0, "l_d": 1.0,
    "l_dis": 1.0, "n_epochs": 500,
}
DRY_RUN = dict(n_atoms=16, n_spiral=3, tau=11, n_epochs=3, n_atom_basis=32,
               n_filters=32, n_gaussians=16, n_convolutions=2, cutoff=3.0,
               loss_cutoff=4.0)


def main(argv=None):
    """Run the fold; ``argv`` the flags (default ``sys.argv[1:]``)."""
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/fold")
    p.add_argument("-nepochs", type=int, default=500)
    p.add_argument("-method", type=str, default="NH_verlet",
                   choices=["NH_verlet", "verlet", "rk4"])
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)

    params = dict(PARAMS, method=args.method, n_epochs=args.nepochs)
    if args.dry_run:
        params.update(DRY_RUN)

    from mdgrad_tpu_torch.train.fold import train_fold
    out = train_fold(params, model_path=args.logdir, device=args.device)
    print("objective:", out["objective"])


if __name__ == "__main__":
    main()
