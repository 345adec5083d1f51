#!/usr/bin/env python
"""Retinal quantum-yield optimisation with the PyTorch/CUDA port
(mdgrad_tpu_torch.train.isom).

The flags and defaults of ``scripts/run_isom.py`` (SGD at lr 1e-2 for 40
epochs of the full 30479-step run, ``--adam`` for Adam) plus ``-device``
(default ``cuda``; ``cpu`` for a run without a card).

    python scripts/run_isom_torch.py                 # on the card
    python scripts/run_isom_torch.py --dry_run -device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/isom")
    p.add_argument("-lr", type=float, default=1e-2)
    p.add_argument("-nepochs", type=int, default=40)
    p.add_argument("--adam", action="store_true", default=False)
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' or 'cpu'")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args()

    kwargs = dict(n_epochs=args.nepochs, lr=args.lr, adam=args.adam,
                  logdir=args.logdir, device=args.device)
    if args.dry_run:
        kwargs.update(n_epochs=2, n_steps=500, look_back=200)

    from mdgrad_tpu_torch.train.isom import fit_isomerization
    out = fit_isomerization(**kwargs)
    print("final yield:", out["q_yields"][-1])


if __name__ == "__main__":
    main()
