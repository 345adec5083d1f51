#!/usr/bin/env python
"""Constant-pressure (NPT) density fitting with the PyTorch/CUDA port
(mdgrad_tpu_torch): ``scripts/run_npt_fit.py``'s flags, defaults and two
modes, plus ``-device`` (default ``cuda``; ``cpu`` for a run without a
card).

The equilibrium density that a potential gives under a target pressure is
differentiable in its parameters, because the MTK barostat
(``NPTMTKNHC``) carries the cell as a state on the autograd graph: the
loss ((rho_NPT - rho_target) / rho_target)^2 backpropagates through the
whole barostatted epoch (the replay adjoint).

* Reduced-units LJ tags (``lj_0.845_1.2``): the ground-truth potential
  fixes P_target at the registry density by a short NVT run; a wrong LJ
  model (``-eps0``, ``-sigma0``) is fitted so that its own NPT density at
  (T, P_target) returns to the registry's, with the soft g(r) of each
  NPT frame, in its own cell, held to the truth frames' (``-rdf_weight``:
  the density alone is degenerate in (eps, sigma)).
* Water tags (``H20_298K_redd``): P0 the registry's pressure in atm;
  Stack{SchNet (128/128, 30 Gaussians, 2 convolutions, cutoff 6.0, bf16)
  on the (N, K) table, ExcludedVolume prior}; the SchNet trains.  Weights
  come from a seeded init (``-seed``), ``-init_pt``, a ``best.pt`` this
  script wrote (a state dict of the whole model), or the JAX script's
  ``-init_pkl``: a JAX pickle whose parameters are the whole model's tree
  (in water mode a water fit's checkpoint, ``{'nn', 'pair'}``; in
  reduced mode the LJ pair's ``{'sigma', 'epsilon'}``), taken whole as
  the JAX script takes it.

Selection rides a window mean of the last ``-sel_window`` epochs' density
and RDF error; the best parameters are evaluated over ``-eval_epochs``
epochs (the first quarter discarded).  Writes ``paramset.json``,
``result.json`` and ``best.pt`` into ``-logdir``.

    python scripts/run_npt_fit_torch.py                       # LJ, card
    python scripts/run_npt_fit_torch.py -data H20_298K_redd -size 4
    python scripts/run_npt_fit_torch.py --dry_run -device cpu
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def load_init_pkl(model, path):
    """Load ``model`` (the water ``Stack`` or the reduced mode's LJ
    ``PairPotentials``) from the whole parameter tree of the JAX pickle
    ``path``."""
    from mdgrad_tpu_torch.interface import Stack
    from mdgrad_tpu_torch.nn.convert import (pair_params_from_numpy,
                                             stack_params_from_numpy)
    from mdgrad_tpu_torch.train.checkpoint import jax_params
    tree = jax_params(path)
    convert = (stack_params_from_numpy if isinstance(model, Stack)
               else pair_params_from_numpy)
    model.load_state_dict(convert(tree, model))


def main(argv=None):
    """Run the fit; ``argv`` the flags (default ``sys.argv[1:]``).
    Returns what ``result.json`` holds."""
    p = argparse.ArgumentParser()
    p.add_argument("-logdir", type=str, default="outputs/npt_fit")
    p.add_argument("-data", type=str, default="lj_0.845_1.2")
    p.add_argument("-size", type=int, default=3)
    p.add_argument("-nepochs", type=int, default=150)
    p.add_argument("-opt_freq", type=int, default=60)
    p.add_argument("-lr", type=float, default=5e-3)
    p.add_argument("-nhc_tau", type=float, default=None,
                   help="thermostat time constant (time units; default "
                        "40*dt)")
    p.add_argument("-tau_p", type=float, default=None,
                   help="barostat time constant (default 100*dt)")
    warm = p.add_mutually_exclusive_group()
    warm.add_argument("-init_pt", type=str, default=None,
                      help="warm start: a best.pt this script wrote")
    warm.add_argument("-init_pkl", type=str, default=None,
                      help="warm start: a JAX pickle of the whole "
                           "model's parameters")
    p.add_argument("-eps0", type=float, default=0.7)
    p.add_argument("-sigma0", type=float, default=0.92)
    p.add_argument("-rdf_weight", type=float, default=1.0,
                   help="weight of the RDF term that pins the (eps, "
                        "sigma) EOS degeneracy (reduced mode only)")
    p.add_argument("-sel_window", type=int, default=10,
                   help="epochs in the windowed time-average used for "
                        "loss reporting and best-model selection")
    p.add_argument("-eval_epochs", type=int, default=16,
                   help="epochs of the equilibrated evaluation at the best "
                        "parameters (the first quarter discarded)")
    p.add_argument("-seed", type=int, default=0,
                   help="seed of the SchNet's init (water mode)")
    p.add_argument("-device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    if args.dry_run:
        args.nepochs, args.opt_freq, args.size = 8, 20, 2
        args.eval_epochs = min(args.eval_epochs, 4)

    import torch
    from mdgrad_tpu_torch import potentials as pot_zoo, thermo, units
    from mdgrad_tpu_torch.data.registry import (exp_rdf_data_dict,
                                                pair_data_dict)
    from mdgrad_tpu_torch.interface import (GNNPotentials, PairPotentials,
                                            Stack)
    from mdgrad_tpu_torch.md import NoseHooverChain, NPTMTKNHC, Simulation
    from mdgrad_tpu_torch.nn import SchNet
    from mdgrad_tpu_torch.observables import generate_vol_bins
    from mdgrad_tpu_torch.parallel.multistate import _soft_rdf_frames
    from mdgrad_tpu_torch.train.fit_rdf import (fit_parameters, get_system,
                                                registry_T_kelvin)
    from mdgrad_tpu_torch.train.fit_rdf_pair import resolve_target_pot
    from mdgrad_tpu_torch.train.optim import FitUpdate

    device = torch.device(args.device)
    os.makedirs(args.logdir, exist_ok=True)
    registry = dict(exp_rdf_data_dict)
    registry.update({k: pair_data_dict[k] for k in pair_data_dict.keys()
                     if k not in registry})
    entry = registry[args.data]
    reduced = bool(entry.get("reduced_units"))
    rng = np.random.default_rng(0)
    system = get_system(args.data, args.size, registry, rng=rng)
    n = system.get_number_of_atoms()
    rho_target = n / system.get_volume()
    T_kelvin = registry_T_kelvin(entry)
    dt = entry.get("dt", 0.01) if reduced else 0.5 * units.fs
    tau_p = args.tau_p or 100.0 * dt
    nhc_tau = args.nhc_tau or 40.0 * dt

    with open(os.path.join(args.logdir, "paramset.json"), "w") as f:
        json.dump({k: str(v) for k, v in vars(args).items()}, f, indent=2)

    if reduced:
        # P_target from the ground-truth potential at the registry density
        truth_int = PairPotentials(system,
                                   resolve_target_pot(entry["target_pot"]),
                                   cutoff=2.5, device=device)
        nvt = NoseHooverChain(truth_int, system, T=T_kelvin, Q=50.0,
                              num_chains=5, adjoint=False, device=device)
        nvt_sim = Simulation(system, nvt)
        for _ in range(4):
            nvt_sim.simulate(200, dt=dt, frequency=200)
        ps, truth_frames = [], []
        with torch.no_grad():
            for _ in range(4):
                traj = nvt_sim.simulate(200, dt=dt, frequency=200)
                ps.extend(thermo.pressure(
                    truth_int, q, (), v, system.get_masses(),
                    system.get_cell(), dim=3).item()
                    for q, v in zip(traj.q[::20], traj.v[::20]))
                truth_frames.append(traj.q[::10])
        P0 = float(np.mean(ps))
        truth_frames = torch.cat(truth_frames)
        print(f"P_target({args.data}) = {P0:.4f} (truth NVT at rho="
              f"{rho_target:.4f})", flush=True)
        model_int = PairPotentials(
            system, pot_zoo.LennardJones(sigma=args.sigma0,
                                         epsilon=args.eps0),
            cutoff=2.5, mode="dense", device=device)
        # restart from the EQUILIBRATED truth configuration
        system.set_positions(nvt_sim.state.q.cpu().double().numpy())
        system.set_velocities(nvt_sim.state.v.cpu().double().numpy())
        train = list(model_int.parameters())
    else:
        P0 = float(entry.get("pressure", 1.0)) * units.atm
        print(f"P0 = {entry.get('pressure', 1.0)} atm = {P0:.3e} eV/A^3",
              flush=True)
        # the widths of the water-fit checkpoints (basis and filters 128,
        # 6.0 // 0.195 = 30 Gaussians)
        gnn = SchNet({"n_atom_basis": 128, "n_filters": 128,
                      "n_gaussians": 30, "n_convolutions": 2,
                      "cutoff": 6.0, "compute_dtype": "bf16"},
                     seed=args.seed)
        prior = pot_zoo.ExcludedVolume(epsilon=0.010637550996566496,
                                       sigma=2.61227614490785, power=12)
        model_int = Stack({
            "nn": GNNPotentials(system, gnn, cutoff=6.0, nbr_mode="table",
                                capacity_slack=1.6, device=device),
            "pair": PairPotentials(system, prior, cutoff=6.0,
                                   device=device)})
        train = fit_parameters(model_int)

    integ = NPTMTKNHC(model_int, system, T=T_kelvin, P=P0, tau=nhc_tau,
                      tau_p=tau_p, num_chains=5, adjoint=True, device=device)
    sim = Simulation(system, integ)
    if args.init_pt:
        model_int.load_state_dict(torch.load(args.init_pt,
                                             map_location=device,
                                             weights_only=True))
        print(f"warm start from {args.init_pt}", flush=True)
    elif args.init_pkl:
        load_init_pkl(model_int, args.init_pkl)
        print(f"warm start from {args.init_pkl}", flush=True)

    tau = args.opt_freq
    ode = sim.epoch_fn(dt, tau)
    ctrl = integ.default_ctrl()

    # the RDF degeneracy-breaker (reduced mode): each NPT frame's soft g(r)
    # in its own cell against the truth frames' (the run that fixed P0)
    rdf_weight = float(args.rdf_weight) if reduced else 0.0
    if rdf_weight:
        start_r = float(entry.get("start", 0.75))
        end_r = float(entry.get("end", 2.5))
        nbins_r = 100
        kw = {"dtype": torch.float32, "device": device}
        offsets_r = torch.linspace(start_r, end_r, nbins_r, **kw)
        widths_r = torch.full((nbins_r,), (end_r - start_r) / (nbins_r - 1),
                              **kw)
        V_r, vol_bins_r, _ = generate_vol_bins(start_r, end_r, nbins_r, 3)
        vol_bins_r = torch.tensor(vol_bins_r, **kw)
        cell0 = torch.tensor(np.diag(system.get_cell()), **kw)

        def g_of(frames, cells):
            """The mean of each frame's soft g(r) in its own cell."""
            return torch.stack([_soft_rdf_frames(
                q[None], c, offsets_r, widths_r, end_r + 0.5, vol_bins_r,
                V_r) for q, c in zip(frames, cells)]).mean(0)

        with torch.no_grad():
            g_tgt = g_of(truth_frames, cell0.expand(len(truth_frames), 3))
        print(f"rdf target from {len(truth_frames)} truth NVT frames "
              f"({nbins_r} bins on [{start_r}, {end_r}])", flush=True)

    def loss_fn(state, aux):
        traj, final_aux = ode(state, aux, ctrl)
        # the mean density over the epoch's second half (the volume relaxes)
        rho_hat = n / torch.prod(traj.cell[tau // 2:], dim=-1).mean()
        loss = ((rho_hat - rho_target) / rho_target) ** 2
        rdf_mse = torch.zeros((), device=device)
        if rdf_weight:
            g_hat = g_of(traj.q[tau // 2::4], traj.cell[tau // 2::4])
            rdf_mse = ((g_hat - g_tgt) ** 2).mean()
            loss = loss + rdf_weight * rdf_mse
        last = traj._replace(**{k: getattr(traj, k)[-1].detach()
                                for k in traj._fields
                                if torch.is_tensor(getattr(traj, k))})
        return loss, rho_hat.detach(), rdf_mse.detach(), last, final_aux

    opt = FitUpdate(train, args.lr, grad_clip=1.0)
    state, aux = sim.initial_state()
    rho_log, loss_log, rdf_log = [], [], []
    W = max(int(args.sel_window), 1)

    def snapshot():
        return {k: v.detach().clone()
                for k, v in model_int.state_dict().items()}

    best = {"loss": float("inf"), "params": snapshot(), "epoch": -1,
            "state": state, "aux": aux, "rho_window": float("nan")}
    patience = 40
    for epoch in range(args.nepochs):
        opt.zero_grad()
        loss, rho_hat, rdf_mse, last, final_aux = loss_fn(state, aux)
        if not bool(torch.isfinite(last.q).all()):
            print(f"NaN bailout at epoch {epoch}", flush=True)
            break
        loss.backward()
        state, aux = last, final_aux
        rho_log.append(rho_hat.item())
        loss_log.append(loss.item())
        rdf_log.append(rdf_mse.item())
        if epoch + 1 >= W:
            rho_w = float(np.mean(rho_log[-W:]))
            sel = ((rho_w - rho_target) / rho_target) ** 2 \
                + rdf_weight * float(np.mean(rdf_log[-W:]))
            if sel < best["loss"]:
                best = {"loss": sel, "params": snapshot(), "epoch": epoch,
                        "state": state, "aux": aux, "rho_window": rho_w}
        opt()
        if epoch % 5 == 0 or epoch == args.nepochs - 1:
            extra = ""
            if reduced:
                extra = (f" | eps {model_int.model.epsilon.item():.4f}"
                         f" sigma {model_int.model.sigma.item():.4f}")
            print(f"epoch {epoch:4d} | loss {loss_log[-1]:.6f} | rho "
                  f"{rho_log[-1]:.4f} vs {rho_target:.4f} | rdf_mse "
                  f"{rdf_log[-1]:.5f}{extra}", flush=True)
        if epoch - best["epoch"] > patience:
            print(f"early stop at epoch {epoch} (no improvement in "
                  f"{patience} epochs; best {best['loss']:.6f} at "
                  f"{best['epoch']})", flush=True)
            break
    if best["epoch"] < 0:
        # the window never filled: the last parameters and state
        best.update(params=snapshot(), state=state, aux=aux)

    # equilibrated evaluation at the best parameters, no updates
    model_int.load_state_dict(best["params"])
    est, ea = best["state"], best["aux"]
    rhos_eval, rdfs_eval = [], []
    with torch.no_grad():
        for i in range(args.eval_epochs):
            _, rho_hat, rdf_mse, est, ea = loss_fn(est, ea)
            if i >= args.eval_epochs // 4:
                rhos_eval.append(rho_hat.item())
                rdfs_eval.append(rdf_mse.item())
    rho_eval = float(np.mean(rhos_eval))
    rdf_eval = float(np.mean(rdfs_eval))

    final_rho = float(np.mean(rho_log[-10:])) if rho_log else float("nan")
    out = {"rho_target": float(rho_target), "rho_final": final_rho,
           "rho_best_eval": rho_eval, "best_epoch": best["epoch"],
           "best_loss": best["loss"],
           "rho_err_pct": 100.0 * abs(rho_eval - rho_target) / rho_target,
           "rdf_mse_eval": rdf_eval, "rdf_weight": rdf_weight,
           "sel_window": W, "rho_window_at_best": best["rho_window"],
           "selection": "windowed time-average (rho + rdf), live",
           "P0": float(P0), "rho_log": rho_log, "loss_log": loss_log,
           "rdf_log": rdf_log}
    if reduced:
        out["params"] = {"epsilon": model_int.model.epsilon.item(),
                         "sigma": model_int.model.sigma.item()}
    torch.save(model_int.state_dict(), os.path.join(args.logdir, "best.pt"))
    with open(os.path.join(args.logdir, "result.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"best-eval NPT density {rho_eval:.4f} (epoch "
          f"{best['epoch']}) vs target {rho_target:.4f} "
          f"({out['rho_err_pct']:.2f}%); last-epochs mean {final_rho:.4f}",
          flush=True)
    return out


if __name__ == "__main__":
    main()
