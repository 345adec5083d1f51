#!/usr/bin/env python
"""Long-rollout validation of pair-potential fit candidates with the
PyTorch/CUDA port.

The protocol of ``scripts/validate_lj_best.py``.  A fit's per-epoch loss
is a noisy estimator, so candidates are re-evaluated with a low-noise
protocol: at each state point, equilibrate ``-eq_epochs`` epochs of
``opt_freq`` steps under the candidate, then average the RDF (and the
virial pressure, and the VACF where the run trained on it) over
``-sample_epochs`` epochs, and compare with the targets, the
ground-truth pressure included.  The candidate with the lower combined
score is the recovered potential.

The configuration (state tags, box size, model widths, capacity slack,
VACF) is read from the run's ``paramset.json``, so any ``fit_lj``
output directory serves.  A candidate is a file under ``-run`` (or a
path relative to it): the port's ``best.pt`` / ``best_eval.pt`` (the
PairMLP's state dict) or a JAX ``best.pkl``
(``{'params': {'pairnn': ..., 'pair': ...}}``, read by
``train/checkpoint.py::read_jax_pickle``); or the literal ``pretrain`` (the lr = 0
Boltzmann-inversion control) or ``truth`` (the registry's ground-truth
potential under the same protocol).

Flags beyond the JAX script's: ``-device`` (default ``cuda``; ``cpu``
for a run without a card), ``-outdir`` (where ``validation.json`` goes;
default beside the run, as the JAX script writes it) and ``--dry_run``
(the first state point at size 3, epochs of 20 steps, 1 equilibration
and 1 sampling epoch, 4 target epochs, 30 pretraining iterations).

    python scripts/validate_lj_best_torch.py -run results/lj_multi_r3/0
    python scripts/validate_lj_best_torch.py --dry_run -device cpu \
        -outdir /tmp/v
"""

import argparse
import ast
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

EQ_EPOCHS, SAMPLE_EPOCHS = 10, 20  # -eq_epochs / -sample_epochs override


def load_cfg(run):
    """The run's ``paramset.json``, each value read as a Python literal
    where it is one."""
    with open(os.path.join(run, "paramset.json")) as f:
        raw = json.load(f)
    cfg = {}
    for k, v in raw.items():
        try:
            cfg[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            cfg[k] = v
    return cfg


def get_pretrain_params(cfg, device):
    """Re-run the fit's configuration at lr = 0 for 1 epoch: the
    parameters never move, so the result is the raw Boltzmann-inversion
    pretraining (the PairMLP's state dict)."""
    from mdgrad_tpu_torch.train.fit_rdf_pair import fit_lj
    assignments = {"nbins": cfg["nbins"], "opt_freq": cfg["opt_freq"],
                   "lr": 0.0, "sigma": cfg["sigma"],
                   "gaussian_width": cfg["gaussian_width"],
                   "n_width": cfg["n_width"], "n_layers": cfg["n_layers"],
                   "nonlinear": cfg["nonlinear"], "grad_clip": 1.0,
                   "rdf_weight": 1.0, "vacf_weight": 0.0}
    sys_params = {"size": cfg["size"], "cutoff": cfg["cutoff"],
                  "t_range": cfg["t_range"], "n_epochs": 1, "n_sim": 1,
                  "data": list(cfg["data"]), "val": None,
                  "topology_update_freq": 1,
                  "pretrain_iters": cfg.get("pretrain_iters", 2000),
                  "burnin_epochs": 0, "frame_skip": 5,
                  "state_reset_every": 10, "train_vacf": "False"}
    out = fit_lj(assignments, sys_params, model_path=None,
                 log=lambda *a: None, device=device)
    return out["params"]


def load_candidate(path):
    """(params, description) of a candidate file: ``{'net': state dict}``
    of a ``.pt``, or ``{'tree': JAX params tree}`` of a JAX pickle."""
    import torch
    if str(path).endswith(".pt"):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        params = {"net": blob["params"]}
    else:
        from mdgrad_tpu_torch.train.checkpoint import read_jax_pickle
        blob = read_jax_pickle(path)
        params = {"tree": blob["params"]}
    sel = (f"selection loss {blob['loss']:.4f}" if "loss" in blob
           else f"engine {blob.get('engine', '?')}")
    return params, f"epoch {blob['epoch']}, {sel}"


def _u(pot, r_grid):
    import torch
    with torch.no_grad():
        return pot(r_grid[:, None]).squeeze(-1).cpu().double().numpy()


def evaluate(params, label, cfg, use_vacf, eq_epochs=EQ_EPOCHS,
             sample_epochs=SAMPLE_EPOCHS, device="cuda", log=print):
    """Score one candidate; ``params`` as :func:`load_candidate` gives
    them, ``{'net': state dict}`` for ``pretrain``, or the literal
    ``'truth'`` for the registry's ground-truth potential under the same
    protocol (a control for thermostat and estimator mismatch against
    the bundled targets)."""
    import torch
    from mdgrad_tpu_torch import potentials as pot_zoo, thermo
    from mdgrad_tpu_torch._device import resolve_device
    from mdgrad_tpu_torch.data.registry import pair_data_dict
    from mdgrad_tpu_torch.interface import PairPotentials, Stack
    from mdgrad_tpu_torch.md import NoseHooverChain, Simulation
    from mdgrad_tpu_torch.nn import PairMLP
    from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy
    from mdgrad_tpu_torch.train.fit_rdf_pair import (get_observer,
                                                     get_system,
                                                     registry_T_kelvin,
                                                     resolve_target_pot)

    device = resolve_device(device)
    rng = np.random.default_rng(1)
    cutoff = cfg["cutoff"]
    tau = cfg["opt_freq"]
    truth = isinstance(params, str) and params == "truth"
    r_grid = torch.linspace(0.3, cutoff, 250, device=device)
    if not truth:
        net = PairMLP(n_gauss=int(cutoff // cfg["gaussian_width"]),
                      r_start=0.0, r_end=cutoff, n_width=cfg["n_width"],
                      n_layers=cfg["n_layers"],
                      nonlinear=cfg["nonlinear"], res=False, device=device)
        prior = pot_zoo.LJFamily(epsilon=2.0, sigma=cfg["sigma"],
                                 rep_pow=6, attr_pow=3).to(device)
    slack = float(cfg.get("capacity_slack") or 2.5)

    rows = []
    for tag in cfg["data"]:
        entry = pair_data_dict[tag]
        system = get_system(tag, cfg["size"], pair_data_dict, rng=rng)
        if truth:
            tp = resolve_target_pot(entry["target_pot"]).to(device)
            stack = Stack({"pair": PairPotentials(system, tp, cutoff=cutoff,
                                                  device=device)})
            u = _u(tp, r_grid)
        else:
            stack = Stack({
                "pairnn": PairPotentials(system, net, cutoff=cutoff,
                                         mode="table", capacity_slack=slack,
                                         device=device),
                "pair": PairPotentials(system, prior, cutoff=cutoff,
                                       device=device)})
            if "tree" in params:
                stack.load_state_dict(stack_params_from_numpy(
                    params["tree"], stack))
            else:
                net.load_state_dict(params["net"])
            # the recovered potential's well (net + prior)
            u = _u(net, r_grid) + _u(prior, r_grid)
        u = u - u[-1]
        depth = float(u.min())
        r_min = float(r_grid[int(u.argmin())])
        integ = NoseHooverChain(stack, system, T=registry_T_kelvin(entry),
                                Q=50.0, num_chains=5, adjoint=False,
                                device=device)
        sim = Simulation(system, integ)
        x, g_t, robs, vacf_t, vobs, p_t = get_observer(
            system, tag, cfg["nbins"], cfg["t_range"],
            entry.get("start", 0.75), pair_data_dict,
            target_nsim=cfg.get("_target_nsim", 30),
            want_pressure=True, rng=rng, device=device)
        dt = entry.get("dt", 0.01)
        masses, cell = system.get_masses(), system.get_cell()
        want_vacf = use_vacf and vacf_t is not None
        for _ in range(eq_epochs):
            sim.simulate(steps=tau, dt=dt, frequency=tau)
        gs, ps, vs = [], [], []
        for _ in range(sample_epochs):
            # frequency = tau keeps every step of the epoch: the VACF
            # needs consecutive velocities; the RDF averages the same
            # frames, one at a time
            traj = sim.simulate(steps=tau, dt=dt, frequency=tau)
            with torch.no_grad():
                gs.append(torch.stack([robs(q)[2] for q in traj.q])
                          .mean(0).cpu().numpy())
                if want_vacf:
                    vs.append(vobs(traj.v).cpu().numpy())
                q, v = traj.q[-1], traj.v[-1]
                aux = stack.aux_update(q, stack.aux_init(q))
                ps.append(float(thermo.pressure(stack, q, aux, v, masses,
                                                cell, dim=system.dim)))
        g_mean = np.mean(gs, axis=0)
        mse = float(((g_mean - g_t.cpu().numpy()) ** 2).mean())
        p_mean = float(np.mean(ps))
        row = {"tag": tag, "rdf_mse": mse, "P_sim": p_mean,
               "P_target": float(p_t) if p_t is not None else None,
               "P_err": (abs(p_mean - p_t) if p_t is not None else None)}
        msg = (f"  {tag:16s} rdf_mse {mse:.5f}  P {p_mean:7.3f} "
               f"(target {p_t if p_t is not None else float('nan'):7.3f})")
        if want_vacf:
            v_mean = np.mean(vs, axis=0)
            row["vacf_mse"] = float(((v_mean - vacf_t[:cfg["t_range"]]
                                      .cpu().numpy()) ** 2).mean())
            msg += f"  vacf_mse {row['vacf_mse']:.5f}"
        rows.append(row)
        log(msg)
    tot_mse = sum(r["rdf_mse"] for r in rows)
    tot_perr = sum(r["P_err"] for r in rows if r["P_err"] is not None)
    tot_vacf = sum(r.get("vacf_mse", 0.0) for r in rows)
    log(f"{label}: total rdf_mse {tot_mse:.5f}, total |dP| {tot_perr:.3f}, "
        f"total vacf_mse {tot_vacf:.5f}, depth {depth:.4f} @ r={r_min:.3f}")
    return {"label": label, "states": rows, "total_rdf_mse": tot_mse,
            "total_P_err": tot_perr, "total_vacf_mse": tot_vacf,
            "depth": depth, "r_min": r_min}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-run", default="results/lj_multi_r3/0",
                    help="fit output dir holding paramset.json and the "
                         "candidate files")
    ap.add_argument("-candidates", nargs="+",
                    default=["best.pkl", "pretrain"],
                    help="files under -run (.pt or numpy .pkl), or the "
                         "literals 'pretrain' and 'truth'")
    ap.add_argument("-pressure_weight", type=float, default=0.05,
                    help="weight of |dP| in the combined score")
    ap.add_argument("-vacf_score_weight", type=float, default=None,
                    help="weight of vacf_mse in the combined score "
                         "(default: the run's vacf_weight)")
    ap.add_argument("-eq_epochs", type=int, default=EQ_EPOCHS)
    ap.add_argument("-sample_epochs", type=int, default=SAMPLE_EPOCHS)
    ap.add_argument("-target_nsim", type=int, default=30,
                    help="target-regeneration epochs; 1/3 of them are "
                         "discarded as equilibration")
    ap.add_argument("-outdir", type=str, default=None,
                    help="where validation.json goes (default: beside "
                         "the run)")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("-device", type=str, default="cuda",
                    help="'cuda' or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None, log=print):
    """Score the candidates; returns ``{candidate: result}`` and the
    combined scores."""
    args = parse_args(argv)
    cfg = load_cfg(args.run)
    cfg["_target_nsim"] = args.target_nsim
    if args.dry_run:
        cfg.update(data=list(cfg["data"])[:1], size=3, opt_freq=20,
                   pretrain_iters=30, _target_nsim=4)
        args.eq_epochs, args.sample_epochs = 1, 1
    use_vacf = str(cfg.get("train_vacf", "False")) == "True"
    vacf_w = (args.vacf_score_weight if args.vacf_score_weight is not None
              else float(cfg.get("vacf_weight", 0.0)))

    out, scores = {}, {}
    for cand in args.candidates:
        if cand == "truth":
            log("candidate: ground-truth target potential (protocol "
                "control)")
            params = "truth"
        elif cand == "pretrain":
            log("candidate: raw BI pretrain (lr=0 control)")
            params = {"net": get_pretrain_params(cfg, args.device)}
        else:
            params, what = load_candidate(os.path.join(args.run, cand))
            log(f"candidate: {cand} ({what})")
        res = evaluate(params, cand, cfg, use_vacf,
                       eq_epochs=args.eq_epochs,
                       sample_epochs=args.sample_epochs, device=args.device,
                       log=log)
        out[cand] = res
        scores[cand] = (res["total_rdf_mse"]
                        + args.pressure_weight * res["total_P_err"]
                        + vacf_w * res["total_vacf_mse"])
    # fit_lj runs live in <logdir>/0: write beside the logdir
    vdir = args.outdir or (
        os.path.join(args.run, "..")
        if os.path.basename(os.path.normpath(args.run)) == "0"
        else args.run)
    os.makedirs(vdir, exist_ok=True)
    with open(os.path.join(vdir, "validation.json"), "w") as f:
        json.dump(out, f, indent=2)
    for cand, s in sorted(scores.items(), key=lambda kv: kv[1]):
        log(f"combined (rdf + {args.pressure_weight}*|dP| + "
            f"{vacf_w}*vacf): {cand} = {s:.5f}")
    log(f"winner: {min(scores, key=scores.get)}")
    return out, scores


if __name__ == "__main__":
    main()
