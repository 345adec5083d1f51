#!/usr/bin/env python
"""LJ pair-potential fit with the PyTorch/CUDA port (mdgrad_tpu_torch).

The flags, defaults and hard-coded assignments of ``scripts/run_lj.py``
(a PairMLP of 25 Gaussians, width 128, 3 layers, SELU, over the LJ-family
prior; the lj_0.7_1 target at size 4, 256 atoms; 120-step epochs, 100
bins), plus ``-device`` (default ``cuda``; ``cpu`` for a run without a
card), driving the port's ``fit_lj``.

    python scripts/run_lj_torch.py                          # on the card
    python scripts/run_lj_torch.py --dry_run -device cpu    # a quick check
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/lj")
    p.add_argument("-data", type=str, nargs="+", default=["lj_0.7_1"])
    p.add_argument("-val", type=str, nargs="+", default=None)
    p.add_argument("-nruns", type=int, default=1)
    p.add_argument("-sigma", type=float, default=0.9)
    p.add_argument("-cutoff", type=float, default=2.5)
    p.add_argument("-dt", type=float, default=0.005)
    p.add_argument("-update_freq", type=int, default=1)
    p.add_argument("-vacf_weight", type=float, default=0.0)
    p.add_argument("-pressure_weight", type=float, default=0.0,
                   help="virial-pressure target weight: P pins the "
                        "attractive-well DEPTH that g(r) alone leaves "
                        "soft (target from the ground-truth sim)")
    p.add_argument("-lr", type=float, default=2e-3)
    p.add_argument("-pretrain", type=int, default=1000)
    p.add_argument("-nepochs", type=int, default=300)
    p.add_argument("-size", type=int, default=4)
    p.add_argument("-opt_freq", type=int, default=120)
    p.add_argument("-frame_skip", type=int, default=5,
                   help="RDF frame subsampling: the training loss "
                        "minimizes bias^2 + Var(g_hat); few frames make "
                        "the variance term large, and ITS gradient "
                        "rewards over-structured (low-variance) systems "
                        "-- the classic over-deepened-well failure. "
                        "frame_skip 1 averages every step")
    p.add_argument("-grad_clip", type=float, default=10.0)
    p.add_argument("-burnin", type=int, default=0,
                   help="equilibration epochs (no parameter updates) "
                        "after pretraining -- see fit_rdf_pair.fit_lj")
    p.add_argument("-state_reset_every", type=int, default=0,
                   help="restore post-burn-in MD snapshots every K "
                        "epochs (keeps sub-critical low-density states "
                        "on the metastable uniform branch their targets "
                        "sampled; see fit_rdf_pair.fit_lj)")
    p.add_argument("-capacity_slack", type=float, default=1.6,
                   help="pair-table capacity headroom; low-density "
                        "states need >=2.5 (density fluctuations "
                        "overflow the 1.6 default)")
    p.add_argument("-eval_every", type=int, default=0,
                   help="equilibrated-eval cadence for best-model "
                        "selection: every K epochs, freeze params, run "
                        "eval_eq_epochs then average observables over "
                        "eval_sample_epochs and score those (the "
                        "per-epoch train loss is biased by MD state "
                        "drift; see fit_rdf_pair.fit_lj)")
    p.add_argument("-eval_eq_epochs", type=int, default=4)
    p.add_argument("-target_nsim", type=int, default=8,
                   help="ground-truth target-generation epochs (100 "
                        "steps each; 1/3 discarded as equilibration). "
                        "Dense-cold states need >=30 or the P target "
                        "is biased low -- see fit_rdf_pair."
                        "get_target_obs")
    p.add_argument("-eval_sample_epochs", type=int, default=8)
    p.add_argument("-init_pkl", type=str, default=None,
                   help="warm-start params from a saved best.pt / "
                        "best_eval.pt, or a JAX pickle whose params "
                        "hold 'pairnn' (replaces the BI pretrain)")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' or 'cpu'")
    args = p.parse_args()

    assignments = {
        "nbins": 100, "opt_freq": args.opt_freq, "lr": args.lr,
        "sigma": args.sigma, "gaussian_width": 0.1, "n_width": 128,
        "n_layers": 3, "nonlinear": "SELU", "grad_clip": args.grad_clip,
        "rdf_weight": 1.0, "vacf_weight": args.vacf_weight,
        "pressure_weight": args.pressure_weight,
        "train_vacf": "True" if args.vacf_weight > 0 else "False",
    }
    sys_params = {
        "size": args.size, "cutoff": args.cutoff, "t_range": 50,
        "n_epochs": args.nepochs, "n_sim": 10, "data": args.data,
        "val": args.val, "topology_update_freq": args.update_freq,
        "pretrain_iters": args.pretrain, "burnin_epochs": args.burnin,
        "frame_skip": args.frame_skip,
        "state_reset_every": args.state_reset_every,
        "eval_every": args.eval_every,
        "eval_eq_epochs": args.eval_eq_epochs,
        "eval_sample_epochs": args.eval_sample_epochs,
        "capacity_slack": args.capacity_slack,
        "target_nsim": args.target_nsim,
        "init_pkl": args.init_pkl,
    }
    if args.dry_run:
        assignments["opt_freq"] = 21
        sys_params.update(n_epochs=2, n_sim=1, size=2, t_range=10,
                          target_nsim=4, frame_skip=5, pretrain_iters=30)

    from mdgrad_tpu_torch.train.fit_rdf_pair import fit_lj
    for i in range(args.nruns):
        out = fit_lj(assignments, sys_params,
                     model_path=os.path.join(args.logdir, str(i)),
                     device=args.device)
        print("objective:", out["objective"])


if __name__ == "__main__":
    main()
