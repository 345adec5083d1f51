#!/usr/bin/env python
"""Hyperparameter search over the fitting objective with the PyTorch/CUDA
port.

The search of ``scripts/run_hyperopt.py``: the GNN and pair search
spaces, sampled with a numpy generator from ``-seed``, and either

  * ``-algo random`` -- plain random search (each configuration trained
    to the full epoch budget), or
  * ``-algo sha`` (default) -- synchronous successive halving: many
    configurations start at a small epoch budget, the best 1/eta are
    promoted each rung and resume from their own fit checkpoints
    (``train/checkpoint.py`` ``FitCheckpointer``), so a promotion costs
    only the budget's increase.

For one seed the trials, their assignments, the rung budgets and the
promotions are the JAX script's.  Each trial runs the port's
``fit_rdf`` on ``-device`` (default ``cuda``; ``cpu`` for a run without
a card).  Rows of (assignment, objective, epochs) go to
``-logdir/results.json``.  ``--dry_run``: at most 4 epochs a
configuration at size 2, one rollout, the cutoff at most 2.5.

    python scripts/run_hyperopt_torch.py                     # on the card
    python scripts/run_hyperopt_torch.py --dry_run -device cpu -n_trials 3
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the search spaces of the SigOpt loops the JAX script transcribes
GNN_SPACE = {
    "n_atom_basis": ("cat", ["tiny", "low", "mid"]),
    "n_filters": ("cat", ["tiny", "low", "mid"]),
    "n_convolutions": ("int", 2, 4),
    "cutoff": ("float", 4.0, 8.0),
    "gaussian_width": ("float", 0.05, 0.5),
    "lr": ("log", 1e-5, 1e-3),
    "opt_freq": ("int", 40, 200),
    "nbins": ("int", 60, 128),
    "sigma": ("float", 1.5, 3.0),
    "epsilon": ("log", 5e-3, 2e-2),
}

PAIR_SPACE = {
    "n_width": ("int", 64, 160),
    "n_layers": ("int", 2, 5),
    "nonlinear": ("cat", ["SELU", "ELU", "Tanh"]),
    "cutoff": ("float", 4.0, 8.0),
    "gaussian_width": ("float", 0.05, 0.5),
    "lr": ("log", 1e-5, 1e-3),
    "opt_freq": ("int", 40, 200),
    "nbins": ("int", 60, 128),
    "sigma": ("float", 1.5, 3.0),
    "epsilon": ("log", 0.5, 2.0),
    "power": ("int", 9, 12),
}


def sample(space, rng):
    out = {}
    for k, spec in space.items():
        kind = spec[0]
        if kind == "cat":
            out[k] = spec[1][rng.integers(len(spec[1]))]
        elif kind == "int":
            out[k] = int(rng.integers(spec[1], spec[2] + 1))
        elif kind == "float":
            out[k] = float(rng.uniform(spec[1], spec[2]))
        elif kind == "log":
            out[k] = float(np.exp(rng.uniform(np.log(spec[1]),
                                              np.log(spec[2]))))
    return out


def _prepare(assignments, args):
    """sys_params for one trial (shared by both algorithms); the dry run
    shrinks the box, the epochs and the cutoff."""
    sys_params = {
        "dt": args.dt, "n_epochs": args.nepochs,
        "n_sim": 1 if args.dry_run else 10,
        "data": args.data, "val": None,
        "size": 2 if args.dry_run else 4,
        "anneal_flag": "False", "pair_flag": args.pair,
        "tpair_flag": False, "topology_update_freq": 1,
    }
    if args.dry_run:
        assignments["opt_freq"] = 21
        # small dry-run boxes cannot host the full cutoff range
        assignments["cutoff"] = min(assignments["cutoff"], 2.5)
        assignments["gaussian_width"] = min(
            assignments["gaussian_width"], 0.2)
        sys_params.update(frame_skip=5, test_nbins=100,
                          pretrain_iters=30)
    return sys_params


def _run_trial(fit_rdf, assignments, sys_params, registry, n_epochs,
               model_path, label):
    """Train one config to a CUMULATIVE epoch budget (resumes from its
    own checkpoint when model_path already holds one); returns
    (objective, total epochs)."""
    sp = dict(sys_params)
    sp["n_epochs"] = int(n_epochs)
    sp["ckpt_every"] = 1          # every rung boundary must be resumable
    try:
        out = fit_rdf(assignments, sp, model_path=model_path,
                      registry=registry,
                      log=lambda *a: None)
        obj = float(out["objective"])
        epochs_total = len(out["loss_log"])
    except Exception as e:  # NaN-type failures score a penalty
        print(f"{label} failed: {e}")
        obj, epochs_total = 5.0, n_epochs
    return obj, epochs_total


def run_random(args, space, rng, registry, fit_rdf):
    results, epochs_spent = [], 0
    for trial in range(args.n_trials):
        assignments = sample(space, rng)
        sys_params = _prepare(assignments, args)
        obj, ep = _run_trial(fit_rdf, assignments, sys_params, registry,
                             args.nepochs,
                             os.path.join(args.logdir, f"t{trial}"),
                             f"trial {trial}")
        epochs_spent += ep
        results.append({"trial": trial, "objective": obj,
                        "epochs": ep, "assignments": assignments})
        results.sort(key=lambda r: r["objective"])
        with open(os.path.join(args.logdir, "results.json"), "w") as f:
            json.dump({"algo": "random", "epochs_spent": epochs_spent,
                       "rows": results}, f, indent=1)
        print(f"trial {trial}: objective {obj:.5f} "
              f"(best {results[0]['objective']:.5f}, "
              f"{epochs_spent} epochs spent)")
    return results


def run_sha(args, space, rng, registry, fit_rdf):
    """Synchronous successive halving: n0 configs at budget R/eta^s,
    promote the best 1/eta per rung; promoted configs RESUME from their
    checkpoints so a rung costs only the budget delta."""
    eta = args.eta
    R = args.nepochs
    n0 = args.n_trials
    s = max(1, int(np.floor(np.log(n0) / np.log(eta))))
    budgets = [max(1, int(np.ceil(R / eta ** (s - i))))
               for i in range(s + 1)]
    print(f"SHA: {n0} configs, rung budgets {budgets} (eta={eta})")

    pool = []
    for trial in range(n0):
        assignments = sample(space, rng)
        pool.append({"trial": trial, "assignments": assignments,
                     "sys_params": _prepare(assignments, args),
                     "objective": None, "epochs": 0})

    epochs_spent = 0
    history = []
    for rung, budget in enumerate(budgets):
        for row in pool:
            obj, ep_total = _run_trial(
                fit_rdf, row["assignments"], row["sys_params"], registry,
                budget, os.path.join(args.logdir, f"t{row['trial']}"),
                f"rung {rung} trial {row['trial']}")
            epochs_spent += max(0, ep_total - row["epochs"])
            row["objective"], row["epochs"] = obj, ep_total
            print(f"rung {rung} trial {row['trial']}: objective "
                  f"{obj:.5f} at {ep_total} epochs "
                  f"({epochs_spent} total spent)")
        pool.sort(key=lambda r: r["objective"])
        history.append([{k: r[k] for k in
                         ("trial", "objective", "epochs")} for r in pool])
        with open(os.path.join(args.logdir, "results.json"), "w") as f:
            json.dump({"algo": "sha", "eta": eta,
                       "epochs_spent": epochs_spent, "rungs": history,
                       "rows": pool}, f, indent=1, default=str)
        keep = max(1, len(pool) // eta)
        if rung < len(budgets) - 1:
            pool = pool[:keep]
    print(f"SHA best: trial {pool[0]['trial']} objective "
          f"{pool[0]['objective']:.5f}; {epochs_spent} epochs spent "
          f"(random search at the same config count would spend "
          f"{n0 * R})")
    return pool


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/hyperopt")
    p.add_argument("-data", type=str, nargs="+",
                   default=["H20_298K_redd"])
    p.add_argument("-n_trials", type=int, default=20,
                   help="random: configs at full budget; sha: initial "
                        "pool size")
    p.add_argument("-nepochs", type=int, default=200,
                   help="per-config MAX epoch budget")
    p.add_argument("-algo", type=str, default="sha",
                   choices=["random", "sha"])
    p.add_argument("-eta", type=int, default=3,
                   help="sha halving rate (keep top 1/eta per rung)")
    p.add_argument("--pair", action="store_true")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("-dt", type=float, default=0.5)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' or 'cpu'")
    args = p.parse_args(argv)
    if args.dry_run:
        args.nepochs = min(args.nepochs, 4)
    return args


def main(argv=None):
    """Run the search; returns its rows (random) or its last pool
    (sha)."""
    import functools
    args = parse_args(argv)
    rng = np.random.default_rng(args.seed)
    space = PAIR_SPACE if args.pair else GNN_SPACE
    os.makedirs(args.logdir, exist_ok=True)

    from mdgrad_tpu_torch._device import resolve_device
    from mdgrad_tpu_torch.train.fit_rdf import fit_rdf
    from mdgrad_tpu_torch.data.registry import (exp_rdf_data_dict,
                                                pair_data_dict)
    # a missing card raises here, not as a penalty inside every trial
    fit = functools.partial(fit_rdf, device=resolve_device(args.device))
    registry = dict(exp_rdf_data_dict)
    registry.update({k: pair_data_dict[k] for k in pair_data_dict
                     if k not in registry})
    if args.algo == "random":
        return run_random(args, space, rng, registry, fit)
    return run_sha(args, space, rng, registry, fit)


if __name__ == "__main__":
    main()
