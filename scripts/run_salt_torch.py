#!/usr/bin/env python
"""Molten-salt charge recovery through the Ewald path with the
PyTorch/CUDA port (mdgrad_tpu_torch): ``scripts/run_salt.py``'s flags and
defaults, plus ``-device`` (default ``cuda``; ``cpu`` for a run without a
card) and ``--dry_run``.

216 ions of an expanded rock salt (a = 6.2 A) melt at 2500 K; the fit
recovers the charge magnitude (truth 0.8, start 0.4) from the partial
RDFs through 60-frame epochs (``train/fit_salt.py``) and writes
``result.json`` into ``-logdir``.  ``--dry_run`` is the 64-ion box at a
= 6.0 A, 3 epochs of 20 frames, 2 target epochs.

    python scripts/run_salt_torch.py                      # on the card
    python scripts/run_salt_torch.py --dry_run -device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    """Run the fit; ``argv`` the flags (default ``sys.argv[1:]``)."""
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", default="results/salt")
    p.add_argument("-n_cells", type=int, default=3)
    p.add_argument("-a", type=float, default=6.2)
    p.add_argument("-T", type=float, default=2500.0)
    p.add_argument("-q_true", type=float, default=0.8)
    p.add_argument("-q0", type=float, default=0.4)
    p.add_argument("-nepochs", type=int, default=200)
    p.add_argument("-tau", type=int, default=60)
    p.add_argument("-lr", type=float, default=2e-2)
    p.add_argument("-target_nsim", type=int, default=16)
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' or 'cpu'")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    if args.dry_run:
        args.n_cells, args.a, args.nepochs = 2, 6.0, 3
        args.tau, args.target_nsim = 20, 2
    print("device:", args.device, flush=True)

    from mdgrad_tpu_torch.train.fit_salt import fit_salt
    res = fit_salt(model_path=args.logdir, n_cells=args.n_cells, a=args.a,
                   T_kelvin=args.T, q_true=args.q_true, q0=args.q0,
                   n_epochs=args.nepochs, tau=args.tau, lr=args.lr,
                   target_nsim=args.target_nsim,
                   log=lambda *a: print(*a, flush=True), device=args.device)
    print(f"final qscale {res['q_final']:.4f} (truth {res['q_true']}), "
          f"loss {res['loss_final']:.6f}")


if __name__ == "__main__":
    main()
