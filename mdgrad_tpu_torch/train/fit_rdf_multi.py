"""Multi-state-point RDF fitting: one potential trained on every state
point of an epoch with one summed gradient.

Port of ``mdgrad_tpu/train/fit_rdf_multi.py``.  :func:`build_multistate`
makes every state point's system and target and ONE integrator over a
``WithDynamicCell`` stack built on the densest state point (so its
neighbor capacity covers every box); :func:`fit_rdf_multistate` trains it
through :func:`~mdgrad_tpu_torch.parallel.multistate.make_stack_multistate_fit`,
the states one after another on one device, their gradients summed into
one update: Adam with the plateau schedule (cooldown, accumulation) or a
cosine decay, the prior frozen; for ``TPairPotentials`` each state's kT is
set in the buffer before its epoch; the well-depth guard; NaN recovery
(restore the last good snapshot, rethermalize, halve the step scale), a
backtrack to an older snapshot when failures persist, ``dt_backoff``, the
bailout that salvages inference; an EMA-selected best iterate; the
``overflow_policy`` branches; checkpoints and resume; and the inference
of every training and held-out (``val``) state point at ``test_nbins``
bins, which survives rollouts that diverge.

Deliberate deviations from the JAX driver (ROADMAP Queue 3), each shown by
a test in ``tests/test_torch_fit_multi.py``:

* the EMA of the loss is frozen while dt is halved, so best-iterate
  selection resumes from a full-dt estimator (the JAX EMA takes the
  half-dt losses);
* every backtrack under ``dt_backoff`` restarts the half-dt hold (JAX
  restarts it only when dt was still full);
* the snapshot ring holds ``max_backtracks`` snapshots (JAX: 3), and a
  backtrack skipped for an empty ring is logged.
"""

import json
import os

import numpy as np
import torch

from .. import units
from .._device import resolve_device
from ..data.registry import exp_rdf_data_dict
from ..interface import (GNNPotentials, PairPotentials, Stack,
                         TPairPotentials, WithDynamicCell)
from ..md import NoseHooverChain, Simulation, rethermalize
from ..parallel.multistate import make_stack_multistate_fit
from .checkpoint import FitCheckpointer, from_plain
from .fit_rdf import (_build_net_and_prior, _depth_guard, _dt_scale,
                      _net_state, fit_parameters, get_observer, get_system,
                      registry_T_kelvin)
from .loss import JS_rdf
from .optim import FitUpdate, ReduceOnPlateau, cosine_decay


def build_multistate(assignments, sys_params, registry=None, rng=None,
                     device="cuda", dtype=torch.float32):
    """Systems and targets of every training state point and one
    dynamic-cell stack.

    The state points must share their composition (atom count) and RDF
    range.  The stack -- the learnable net and the prior on the *densest*
    state point, whose neighbor count bounds every box's -- is wrapped in
    ``WithDynamicCell``, under one Nose-Hoover chain (Q 50, 5 chains,
    replay adjoint) at the first state point's temperature.
    """
    registry = exp_rdf_data_dict if registry is None else registry
    size, cutoff = sys_params["size"], assignments["cutoff"]
    train_list = list(sys_params["data"])
    net, prior = _build_net_and_prior(assignments, sys_params, device)

    systems, targets, r_axes, kTs, cell_lens, rhos = [], [], [], [], [], []
    rdf_range = None
    for tag in train_list:
        entry = registry[tag]
        system = get_system(tag, size, registry, rng=rng)
        systems.append(system)
        x, g_obs, _ = get_observer(system, tag, assignments["nbins"],
                                   registry, device=device, dtype=dtype)
        targets.append(g_obs)
        r_axes.append(x)
        kTs.append(registry_T_kelvin(entry) * units.kB)
        cell_lens.append(np.diag(np.asarray(system.get_cell())))
        rhos.append(system.get_number_of_atoms() / system.get_volume())
        rr = (entry["start"], entry["end"])
        if rdf_range is None:
            rdf_range = rr
        elif rdf_range != rr:
            raise ValueError(f"state points disagree on rdf range: "
                             f"{rdf_range} vs {rr} ({tag})")
    n_atoms = {s.get_number_of_atoms() for s in systems}
    if len(n_atoms) != 1:
        raise ValueError(f"state points disagree on atom count: {n_atoms}")

    densest = int(np.argmax(rhos))
    proto = systems[densest]
    slack = float(sys_params.get("capacity_slack", 2.0))
    T0 = registry_T_kelvin(registry[train_list[0]])
    prior_int = PairPotentials(proto, prior, cutoff=cutoff, device=device)
    if sys_params.get("tpair_flag"):
        nn_int = TPairPotentials(proto, net, T0, cutoff=cutoff, mode="table",
                                 capacity_slack=slack, device=device)
    elif sys_params.get("pair_flag"):
        nn_int = PairPotentials(proto, net, cutoff=cutoff, device=device)
    else:
        nn_int = GNNPotentials(proto, net, cutoff=cutoff, nbr_mode="table",
                               capacity_slack=slack, device=device)
    stack = Stack({"nn": nn_int, "pair": prior_int})
    if dtype != torch.float32:
        stack.to(dtype)
    params = fit_parameters(stack)
    dyn = WithDynamicCell(stack, cell_lens[densest])
    integ = NoseHooverChain(
        dyn, proto, T=T0, Q=50.0, num_chains=5, adjoint=True,
        topology_update_freq=sys_params.get("topology_update_freq", 1),
        device=device, dtype=dtype)
    return {"systems": systems, "targets": torch.stack(targets),
            "r_axes": r_axes, "kTs": np.asarray(kTs),
            "cell_lens": np.stack(cell_lens), "rhos": np.asarray(rhos),
            "net": net, "prior": prior, "stack": stack, "integ": integ,
            "params": params, "train_list": train_list,
            "registry": registry, "rdf_range": rdf_range}


def _states_finite(finals):
    """Whether every state's positions are finite (module-level so that
    tests can inject failures)."""
    return all(bool(torch.isfinite(s.q).all()) for s in finals)


def _rethermalize_stack(states, comps, rng):
    """Every state with fresh Maxwell-Boltzmann velocities at its own kT:
    a deterministic replay of a restored snapshot would reproduce a
    blowup driven by the state."""
    return [rethermalize(s, float(comps["kTs"][j]),
                         comps["systems"][j].get_masses(), rng=rng,
                         dim=comps["systems"][j].dim)
            for j, s in enumerate(states)]


def _make_update(params, assignments, sys_params, n_epochs):
    """Adam on the net with its gradient clipped at norm 10, under the
    plateau schedule (factor 0.5, patience 30, cooldown 30, the mean of 5
    losses, floor 0.05) or, with ``lr_schedule='cosine'``, a cosine decay
    to ``cosine_alpha`` x lr over the run."""
    if str(sys_params.get("lr_schedule", "plateau")) == "cosine":
        return FitUpdate(params, assignments["lr"], 10.0,
                         schedule=cosine_decay(
                             max(int(n_epochs), 1),
                             float(sys_params.get("cosine_alpha", 0.05))))
    return FitUpdate(params, assignments["lr"], 10.0, ReduceOnPlateau(
        factor=0.5, patience=30, cooldown=30, accumulation_size=5,
        min_scale=0.05, atol=1e-5))


def fit_rdf_multistate(assignments, sys_params, model_path=None, log=print,
                       registry=None, rng=None, device="cuda"):
    """Train one potential against every state point of ``sys_params['data']``
    with one summed gradient an epoch.

    Returns a dict: ``loss_log``, ``js_log`` (per state), ``final`` (each
    tag's inference RDF and MSE, held-out tags marked), ``objective`` (the
    training tags' summed MSE), ``params`` (the net's ``state_dict`` on the
    CPU, of the selected iterate), ``best_epoch``, ``best_ema_loss``,
    ``selected`` ('best', 'final' or 'final-fallback'), ``val_mse`` for
    held-out tags, and ``nan_bailout`` / ``bailout_epoch`` after a
    salvaged bailout.  ``device``: "cuda" unless "cpu" is asked for.
    """
    registry = exp_rdf_data_dict if registry is None else registry
    rng = np.random.default_rng(0) if rng is None else rng
    device = resolve_device(device)
    n_epochs = sys_params["n_epochs"]
    tau = assignments["opt_freq"]
    frame_skip = sys_params.get("frame_skip", 20)

    comps = build_multistate(assignments, sys_params, registry, rng=rng,
                             device=device)
    integ, net, stack = comps["integ"], comps["net"], comps["stack"]
    train_list = comps["train_list"]
    S = len(train_list)
    log(f"multistate fit: {S} states, one after another on {device}")
    tflag = bool(sys_params.get("tpair_flag"))
    # a TPairPotentials holds its kT in a buffer: each state sets its own
    set_kT = (lambda kT: stack.models["nn"].kT.fill_(kT)) if tflag else None
    dt = sys_params["dt"] * _dt_scale(registry[train_list[0]])

    if sys_params.get("pair_flag") or tflag:
        from .pretrain import boltzmann_inversion_pretrain
        rr_lo = min(registry[t]["start"] for t in train_list)
        rr_hi = max(registry[t]["end"] for t in train_list)
        boltzmann_inversion_pretrain(
            net, comps["prior"], comps["r_axes"], list(comps["targets"]),
            [registry_T_kelvin(registry[t]) for t in train_list],
            rrange=np.linspace(rr_lo + 0.5, rr_hi, 500),
            n_iters=sys_params.get("pretrain_iters", 1000),
            temperature_dependent=tflag)

    if model_path:
        os.makedirs(model_path, exist_ok=True)
        with open(os.path.join(model_path, "assignments.json"), "w") as f:
            json.dump({k: str(v) for k, v in assignments.items()}, f)

    # the pair families' well-depth guard on the common RDF range
    u_reg_weight = float(sys_params.get("u_reg_weight", 0.0))
    depth_guard = None
    if u_reg_weight > 0 and (sys_params.get("pair_flag") or tflag):
        depth_guard = _depth_guard(
            net, comps["prior"], train_list, train_list, registry,
            assignments["cutoff"], u_reg_weight,
            float(sys_params.get("u_floor_mult", 1.5)), tflag)
        log(f"depth guard: pretrained depths {np.round(depth_guard.d0, 3)}"
            f", floors {np.round(depth_guard.floor, 3)}")

    update = _make_update(comps["params"], assignments, sys_params, n_epochs)

    def build_loss(dt_scale=1.0):
        # dt_scale < 1: the dt-backoff recovery, an epoch at a smaller dt
        return make_stack_multistate_fit(
            integ, dt=dt * dt_scale, n_steps=max(int(tau) - 1, 1),
            nbins=assignments["nbins"], rdf_range=comps["rdf_range"],
            frame_skip=frame_skip, loss_type="shell", set_kT=set_kT)

    loss_fn = build_loss()
    targets = comps["targets"]

    def epoch_losses(states):
        """The summed loss (the depth guard's term included), the
        per-state losses, RDFs, final states and overflow flags; .grad
        holds the summed gradient."""
        total, (losses, gs, finals, overflow) = loss_fn(
            states, comps["cell_lens"], comps["kTs"], targets, comps["rhos"])
        total = total.item()
        if depth_guard is not None:
            total += depth_guard()
        return total, losses, gs, finals, overflow

    # the stacked initial states: one Maxwell-Boltzmann draw per system
    proto_state = integ.initial_state()
    kw = {"dtype": proto_state.q.dtype, "device": proto_state.q.device}
    states = [proto_state._replace(
        q=torch.as_tensor(s.get_positions(), **kw),
        v=torch.as_tensor(s.get_velocities(), **kw))
        for s in comps["systems"]]

    ckpt = FitCheckpointer(model_path, every=sys_params.get("ckpt_every", 10))
    resume = ckpt.restore()
    loss_log, js_log = [], []
    start_epoch = 0
    if resume is not None:
        net.load_state_dict(resume["params"])
        update.load_state_dict(resume["opt_state"])
        states = from_plain(states, resume["md_states"])
        loss_log = list(resume["logs"].get("loss_log", []))
        js_log = list(resume["logs"].get("js_log", []))
        start_epoch = resume["epoch"] + 1
        log(f"resumed from checkpoint at epoch {resume['epoch']}")

    # overflow_policy: 'warn' logs; 'skip' also drops the update; 'regrow'
    # grows the shared capacity, restores the epoch's entry and retries it
    overflow_policy = sys_params.get("overflow_policy", "warn")
    regrow_factor = float(sys_params.get("regrow_factor", 1.5))
    step_scale = 1.0
    bailed_at = None
    snap_every = max(int(sys_params.get("backtrack_every", 10)), 1)
    backtrack_after = int(sys_params.get("backtrack_after", 2))
    max_backtracks = int(sys_params.get("max_backtracks", 8))
    # the ring holds one snapshot per backtrack the budget allows
    ring = max(max_backtracks, 1)
    snaps = []          # (epoch, net state, optimizer state, states)
    fails = backtracks = 0
    dt_backoff = bool(sys_params.get("dt_backoff", False))
    dt_hold = int(sys_params.get("dt_hold", 20))
    dt_scale_now, dt_clean = 1.0, 0
    # live best-iterate selection on an EMA (weight 0.6 on the past) of the
    # loss: one epoch's loss is one noisy trajectory draw
    ema = None
    best = {"loss": float("inf"), "params": None, "states": None,
            "epoch": -1}
    last_good = (_net_state(net), update.state_dict(), list(states))

    def restore(snapshot):
        net_state, opt_state, snap_states = snapshot
        net.load_state_dict(net_state)
        update.load_state_dict(opt_state)
        return list(snap_states)

    epoch = start_epoch
    while epoch < n_epochs:
        entry = (_net_state(net), update.state_dict(), list(states))
        update.zero_grad()
        total, losses, gs, finals, overflow = epoch_losses(states)
        if not _states_finite(finals):
            update.zero_grad()
            fails += 1
            step_scale *= 0.5
            if ((fails >= backtrack_after or step_scale < 0.1)
                    and backtracks < max_backtracks and not snaps):
                log(f"epoch {epoch}: backtrack skipped -- the snapshot "
                    "ring is empty")
            if ((fails >= backtrack_after or step_scale < 0.1)
                    and snaps and backtracks < max_backtracks):
                sn_epoch, *snapshot = snaps.pop()
                states = _rethermalize_stack(restore(snapshot), comps, rng)
                last_good = (_net_state(net), update.state_dict(),
                             list(states))
                backtracks += 1
                step_scale, fails = 0.25, 0
                if dt_backoff:
                    if dt_scale_now == 1.0:
                        dt_scale_now = 0.5
                        loss_fn = build_loss(dt_scale_now)
                        log(f"epoch {epoch}: dt-backoff engaged -- training "
                            f"dt halved for the next {dt_hold} clean epochs")
                    else:
                        log(f"epoch {epoch}: dt-backoff hold restarted")
                    dt_clean = 0
                log(f"epoch {epoch}: non-finite persists; BACKTRACK to "
                    f"the epoch-{sn_epoch} snapshot (params + opt state "
                    f"reverted, momenta rethermalized; {len(snaps)} "
                    f"snapshots left, {max_backtracks - backtracks} "
                    "backtracks left)")
                continue
            if step_scale < 1 / 64:
                log(f"NaN bailout at epoch {epoch} (step_scale "
                    "exhausted); salvaging inference from last-good")
                states = restore(last_good)
                bailed_at = epoch
                break
            states = _rethermalize_stack(restore(last_good), comps, rng)
            log(f"epoch {epoch}: non-finite state; restored last-good "
                f"+ rethermalized, step_scale -> {step_scale:g}")
            continue
        apply_update = True
        over_js = [j for j, o in enumerate(overflow) if o]
        if over_js:
            log(f"WARNING: neighbor capacity overflow at epoch {epoch} "
                f"(states {over_js}) -- raise capacity_slack")
            if overflow_policy == "regrow":
                if integ.model.grow_capacity(regrow_factor):
                    update.zero_grad()
                    states = restore(entry)
                    log(f"regrow: shared neighbor capacity grown; epoch "
                        f"{epoch} entry restored and retried")
                    continue
                log("regrow: already at maximum capacity -- overflow "
                    "is unrecoverable here")
            elif overflow_policy == "skip":
                log(f"epoch {epoch}: parameter update skipped "
                    "(overflow_policy='skip')")
                apply_update = False
        # the EMA and the best iterate move on full-dt epochs only
        if dt_scale_now == 1.0:
            ema = total if ema is None \
                else 0.6 * ema + 0.4 * total
            if ema < best["loss"]:
                best = {"loss": ema, "params": entry[0], "states": finals,
                        "epoch": epoch}
                ckpt.save_best(epoch, ema, entry[0])
        fails = 0
        if dt_scale_now < 1.0:
            dt_clean += 1
            if dt_clean >= dt_hold:
                dt_scale_now = 1.0
                loss_fn = build_loss(1.0)
                log(f"epoch {epoch}: dt-backoff released -- full "
                    "training dt restored")
        if epoch % snap_every == 0:
            # this verified epoch's entry parameters with its final states
            snaps.append((epoch, entry[0], entry[1], list(finals)))
            del snaps[:-ring]
        if apply_update:
            update(total, step_scale)
        else:
            update.zero_grad()
        states = finals
        last_good = (_net_state(net), update.state_dict(), list(states))
        step_scale = min(1.0, step_scale * 1.26)
        loss_log.append(total)
        js_log.append([JS_rdf(targets[j], gs[j]).item() for j in range(S)])
        log(f"epoch {epoch} | loss: {total:.5f} | per-state: "
            + " ".join(f"{v:.4f}" for v in losses.tolist()))
        ckpt.maybe_save(epoch, net.state_dict(), update.state_dict(), states,
                        {"loss_log": loss_log, "js_log": js_log})
        epoch += 1

    final_params, final_states = _net_state(net), list(states)
    params = final_params
    if best["params"] is not None:
        fin = f"{loss_log[-1]:.5f}" if loss_log else "n/a"
        log(f"inference from LIVE-selected best iterate: epoch "
            f"{best['epoch']} (ema loss {best['loss']:.5f}); final-epoch "
            f"loss was {fin}")
        params, states = best["params"], best["states"]
    results = {"loss_log": loss_log, "js_log": js_log, "final": {},
               "params": params, "best_epoch": best["epoch"],
               "best_ema_loss": best["loss"],
               "selected": "best" if best["params"] is not None
               else "final"}
    if bailed_at is not None:
        results["nan_bailout"] = True
        results["bailout_epoch"] = bailed_at
    test_nbins = sys_params.get("test_nbins", 800)
    n_sim = sys_params.get("n_sim", 2)
    val_list = list(sys_params.get("val") or [])
    val_systems = {t: get_system(t, sys_params["size"], registry, rng=rng)
                   for t in val_list}
    cutoff = assignments["cutoff"]

    def infer_all(net_state, states):
        """Rollout inference of every tag with the net at ``net_state``:
        (per-tag results, the training tags' summed MSE, whether every tag
        gave a finite frame).  A tag whose rollouts all diverge gets a NaN
        MSE."""
        net.load_state_dict(net_state)
        final, total, all_ok = {}, 0.0, True
        for j, tag in enumerate(train_list + val_list):
            held_out = tag in val_systems
            system = val_systems[tag] if held_out else comps["systems"][j]
            T = registry_T_kelvin(registry[tag])
            prior_int = PairPotentials(system, comps["prior"], cutoff=cutoff,
                                       device=device)
            if tflag:
                nn_int = TPairPotentials(system, net, T, cutoff=cutoff,
                                         device=device)
            elif sys_params.get("pair_flag"):
                nn_int = PairPotentials(system, net, cutoff=cutoff,
                                        device=device)
            else:
                nn_int = GNNPotentials(system, net, cutoff=cutoff,
                                       device=device)
            integ_j = NoseHooverChain(Stack({"nn": nn_int, "pair": prior_int}),
                                      system, T=T, Q=50.0, num_chains=5,
                                      adjoint=False, device=device)
            sim = Simulation(system, integ_j)
            if not held_out:
                sim.state = states[j]
                sim.aux = integ_j.aux_init(states[j].q)
                frames = [states[j].q]
            else:
                # a held-out state equilibrates from the lattice first,
                # retried from a fresh lattice if it diverges
                for attempt in range(3):
                    sim.simulate(steps=300, dt=dt, frequency=100)
                    if bool(torch.isfinite(sim.state.q).all()):
                        break
                    log(f"held-out equilibration diverged for {tag} "
                        f"(attempt {attempt}); rebuilding from the "
                        "lattice with fresh momenta")
                    system = get_system(tag, sys_params["size"], registry,
                                        rng=rng)
                    sim = Simulation(system, integ_j)
                frames = []
            good = (sim.state, sim.aux)
            for _ in range(n_sim):
                traj = sim.simulate(steps=100, dt=dt, frequency=25)
                f = traj.q[-1]
                if bool(torch.isfinite(f).all()):
                    frames.append(f)
                    good = (sim.state, sim.aux)
                else:
                    log(f"inference rollout diverged for {tag}; frame "
                        "skipped, restarting from last good state")
                    sim.state, sim.aux = good
            x, g_obs, obs = get_observer(system, tag, test_nbins, registry,
                                         device=device)
            g_obs = g_obs.cpu().numpy()
            if frames:
                with torch.no_grad():
                    g_sim = np.mean([obs(f)[2].cpu().numpy()
                                     for f in frames], axis=0)
                mse = float(((g_obs - g_sim) ** 2).mean())
            else:
                log(f"inference produced NO finite frames for {tag}; "
                    "mse recorded as nan")
                g_sim = np.full_like(g_obs, np.nan)
                mse = float("nan")
                all_ok = False
            final[tag] = {"r": x, "g_sim": g_sim, "g_obs": g_obs,
                          "mse": mse, "held_out": held_out}
            if not held_out:
                total += mse
        return final, total, all_ok

    final, total, all_ok = infer_all(params, states)
    if not all_ok and results["selected"] == "best":
        log("selected best iterate diverged at inference; falling back "
            "to the final-epoch iterate")
        final_f, total_f, ok_f = infer_all(final_params, final_states)
        if ok_f:
            final, total = final_f, total_f
            results["selected"] = "final-fallback"
            results["params"] = final_params
        else:
            log("final-epoch iterate also diverged at inference; "
                "keeping the best-iterate results")
    results["params"] = {k: v.cpu() for k, v in results["params"].items()}
    results["final"] = final
    results["objective"] = total
    for tag, fin in final.items():
        if fin["held_out"]:
            results.setdefault("val_mse", {})[tag] = fin["mse"]
    if model_path:
        for tag, fin in final.items():
            np.savetxt(os.path.join(model_path, f"rdf_{tag}.csv"),
                       np.vstack([fin["r"], fin["g_sim"]]), delimiter=",")
        np.savetxt(os.path.join(model_path, "loss.csv"),
                   np.asarray(loss_log))
        from .plots import plot_loss, plot_rdfs
        plot_loss(loss_log, model_path)
        for tag, fin in final.items():
            plot_rdfs(fin["r"], fin["g_obs"], fin["g_sim"],
                      f"rdf_{tag}_final", model_path, pname="final")
    return results
