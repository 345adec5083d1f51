"""Pair-potential fitting to target RDFs (and VACFs and pressures): the
LJ, Yukawa and Morse workloads (port of ``mdgrad_tpu/train/fit_rdf_pair.py``).

:func:`fit_lj` trains a ``PairMLP`` plus a frozen prior (the LJ family
4 eps ((s/r)^6 - (s/r)^3) at eps = 2, or with ``prior`` 'repulsive' an
ExcludedVolume, or 'gauss' a GaussianCore) on one Nose-Hoover chain (Q =
50, 5 chains) per state point.  Targets come from the registry's files or
are generated by simulating the ground-truth potential
(:func:`get_target_obs`), which also gives the mean virial pressure.  An
epoch's loss is ``rdf_weight`` times the MSE of the per-frame-averaged
g(r), plus ``vacf_weight`` times the VACF's MSE (``train_vacf``), plus
``pressure_weight`` times (P - P_target)^2, P the mean virial pressure
over every ``pressure_frame_skip``-th frame, differentiated through the
trajectory (the replay adjoint).  The training state points' gradients
are summed, clipped to a global norm and fed to Adam with
reduce-on-plateau on the MLP only.

Around that: Boltzmann-inversion pretraining, an ``init_pkl`` warm start,
burn-in epochs, a periodic reset to the post-burn-in states, an
equilibrated evaluation for best-model selection, the NaN bail-out,
checkpoints and resume, and the recovered u(r) on a grid.  As in the
port's ``fit_rdf``, ``.grad`` is cleared at every epoch start, a state
point that trains nothing (burn-in, evaluation, validation) runs without
backward, and the neighbor overflow flag is ORed over every refresh.
"""

import functools
import json
import os

import numpy as np
import torch
import torch.utils.checkpoint

from .. import potentials as pot_zoo
from .. import thermo
from .._device import resolve_device
from ..data.registry import get_exp_rdf, load_target, pair_data_dict
from ..interface import PairPotentials, Stack
from ..md import NoseHooverChain, Simulation
from ..nn import PairMLP
from ..observables import rdf as rdf_obs_cls, vacf as vacf_obs_cls
from .checkpoint import FitCheckpointer, from_plain, pair_mlp_state
from .fit_rdf import get_system, registry_T_kelvin
from .optim import FitUpdate, ReduceOnPlateau
from .pretrain import boltzmann_inversion_pretrain

TARGET_POT_CLASSES = {
    "LennardJones": pot_zoo.LennardJones,
    "ExcludedVolume": pot_zoo.ExcludedVolume,
    "Yukawa": pot_zoo.Yukawa,
    "Morse": pot_zoo.Morse,
    "LJFamily": pot_zoo.LJFamily,
}


def resolve_target_pot(spec):
    """A registry entry's ('ClassName', kwargs) spec as a potential."""
    if spec is None:
        return None
    if isinstance(spec, tuple):
        name, kw = spec
        if name == "SplineOverlap":
            return pot_zoo.spline_overlap(**kw)
        return TARGET_POT_CLASSES[name](**kw)
    return spec


def get_target_obs(system, entry, n_sim, rdf_range, nbins, t_range, dt,
                   skip=None, steps_per_sim=100, rng=None, device="cuda"):
    """(g (nbins,), vacf (t_range,), mean pressure) of the ground-truth
    potential: ``n_sim`` runs of ``steps_per_sim`` steps under a
    Nose-Hoover chain (dense pairs, cutoff 2.5), the first ``skip``
    (default max(2, n_sim // 3)) discarded as equilibration; g from each
    kept run's last frame, the VACF from its velocities, the virial
    pressure from every 10th frame."""
    if skip is None:
        skip = max(2, n_sim // 3)
    target_pot = resolve_target_pot(entry["target_pot"])
    pot_int = PairPotentials(system, target_pot, cutoff=2.5, device=device)
    integ = NoseHooverChain(pot_int, system, T=registry_T_kelvin(entry),
                            Q=50.0, num_chains=5, adjoint=False,
                            device=device)
    sim = Simulation(system, integ)
    robs = rdf_obs_cls(system, nbins=nbins, r_range=rdf_range, device=device)
    vobs = vacf_obs_cls(system, t_range=t_range)
    masses, cell = system.get_masses(), system.get_cell()
    gs, vacfs, ps = [], [], []
    for i in range(n_sim):
        traj = sim.simulate(steps_per_sim, dt=dt, frequency=steps_per_sim)
        if i >= skip:
            with torch.no_grad():
                gs.append(robs(traj.q[-1])[2].cpu().numpy())
                vacfs.append(vobs(traj.v).cpu().numpy())
                p = [thermo.pressure(pot_int, q, (), v, masses, cell,
                                     dim=system.dim)
                     for q, v in zip(traj.q[::10], traj.v[::10])]
                ps.append(torch.stack(p).mean().item())
    return (np.mean(gs, axis=0), np.mean(vacfs, axis=0),
            float(np.mean(ps)))


def get_observer(system, data_tag, nbins, t_range, rdf_start, registry=None,
                 target_nsim=20, rng=None, want_pressure=False,
                 device="cuda", dtype=torch.float32):
    """(r_axis, g target (nbins,), rdf observable, VACF target or None,
    vacf observable, pressure target or None) of the state point
    ``data_tag``; targets are ``dtype`` tensors.

    The targets come from the entry's files, or when it has none from
    :func:`get_target_obs`.  The pressure target is the entry's
    ``pressure``, else the ground-truth simulation's -- run for that alone
    with ``want_pressure`` when the RDF comes from a file -- else None.
    A target file must hold an r row beside g: the Morse and LJ-family
    files hold g alone, and raise ``ValueError`` (no grid is assumed).
    """
    registry = pair_data_dict if registry is None else registry
    entry = registry[data_tag]
    dt = entry.get("dt", 0.01)
    rdf_range = (rdf_start, entry["end"])
    robs = rdf_obs_cls(system, nbins, rdf_range, device=device)
    vobs = vacf_obs_cls(system, t_range=t_range)
    fn = entry.get("rdf_fn") or entry.get("fn")
    p_target = entry.get("pressure")
    if fn and os.path.exists(fn):
        rdf_data = load_target(fn)
        if rdf_data.ndim != 2 or 2 not in rdf_data.shape:
            raise ValueError(
                f"{fn}: {rdf_data.size} values of g and no r column -- a "
                "target needs [r, g] rows, and no grid is assumed for it")
        vacf_target = None
        if entry.get("vacf_fn") and os.path.exists(entry["vacf_fn"]):
            vacf_target = load_target(entry["vacf_fn"])[:t_range]
        if want_pressure and p_target is None and entry.get("target_pot"):
            _, _, p_target = get_target_obs(
                system, entry, target_nsim, rdf_range, nbins, t_range, dt,
                rng=rng, device=device)
    else:
        g, vacf_target, p_gen = get_target_obs(
            system, entry, target_nsim, rdf_range, nbins, t_range, dt,
            rng=rng, device=device)
        rdf_data = np.vstack([np.linspace(*rdf_range, nbins), g])
        if p_target is None:
            p_target = p_gen
    x, rdf_target = get_exp_rdf(rdf_data, nbins, rdf_range,
                                dim=entry.get("dim", 3))
    kw = {"dtype": dtype, "device": robs.bins.device}
    return (x, torch.tensor(rdf_target, **kw), robs,
            None if vacf_target is None else torch.tensor(vacf_target, **kw),
            vobs, p_target)


def _prior(assignments):
    kind = assignments.get("prior", "ljfamily")
    if kind == "repulsive":
        return pot_zoo.ExcludedVolume(
            epsilon=assignments.get("prior_epsilon", 1.0),
            sigma=assignments["sigma"],
            power=assignments.get("prior_power", 12))
    if kind == "gauss":
        # a bounded soft core for bounded target families (2-D stripes)
        return pot_zoo.GaussianCore(
            epsilon=assignments.get("prior_epsilon", 2.0),
            sigma=assignments["sigma"])
    return pot_zoo.LJFamily(epsilon=2.0, sigma=assignments["sigma"],
                            rep_pow=6, attr_pow=3)


def build_lj(assignments, sys_params, registry=None, rng=None,
             device="cuda", dtype=torch.float32):
    """The pieces of :func:`fit_lj`: a dict of ``net`` (the PairMLP every
    state point shares), ``prior`` (frozen), ``systems``, ``sims`` and
    ``observers`` (:func:`get_observer`'s tuples), one each per tag of
    ``all_sys`` (the training tags ``train_list`` first, then
    ``sys_params['val']``), and ``registry``.  ``dtype``: the MD's and
    the models' (float64 for parity checks)."""
    registry = pair_data_dict if registry is None else registry
    device = resolve_device(device)
    cutoff = sys_params["cutoff"]
    train_list = list(sys_params["data"])
    all_sys = train_list + list(sys_params.get("val") or [])
    net = PairMLP(n_gauss=int(cutoff // assignments["gaussian_width"]),
                  r_start=0.0, r_end=cutoff,
                  n_width=assignments["n_width"],
                  n_layers=assignments["n_layers"],
                  nonlinear=assignments["nonlinear"], device=device)
    prior = _prior(assignments)
    prior.requires_grad_(False)
    systems, sims, observers = [], [], []
    for tag in all_sys:
        system = get_system(tag, sys_params["size"], registry, rng=rng)
        # the MLP on the (N, K) table, the closed-form prior dense; low
        # density (gas-branch) states need more table slack
        stack = Stack({
            "pairnn": PairPotentials(
                system, net, cutoff=cutoff, mode="table",
                capacity_slack=float(sys_params.get("capacity_slack", 1.6)),
                device=device),
            "pair": PairPotentials(system, prior, cutoff=2.5,
                                   device=device)})
        if dtype != torch.float32:
            stack.to(dtype)
        integ = NoseHooverChain(
            stack, system, T=registry_T_kelvin(registry[tag]), Q=50.0,
            num_chains=5, adjoint=True,
            topology_update_freq=sys_params.get("topology_update_freq", 1),
            device=device, dtype=dtype)
        observers.append(get_observer(
            system, tag, assignments["nbins"], sys_params["t_range"],
            registry[tag].get("start", 0.75), registry,
            target_nsim=sys_params.get("target_nsim", 8), rng=rng,
            want_pressure=float(assignments.get("pressure_weight", 0.0)) > 0,
            device=device, dtype=dtype))
        systems.append(system)
        sims.append(Simulation(system, integ))
    return {"net": net, "prior": prior, "systems": systems, "sims": sims,
            "observers": observers, "train_list": train_list,
            "all_sys": all_sys, "registry": registry}


def make_lj_epoch_loss(sim, observer, assignments, sys_params, dt):
    """One state point's epoch objective for :func:`fit_lj`:
    ``loss_fn(state, aux, ctrl, backward) -> (loss, (g, vacf, p, last,
    final_aux))``.  It runs ``opt_freq - 1`` steps, averages the g(r) of
    every ``frame_skip``-th frame, adds the VACF and pressure terms that
    ``assignments`` switch on, and with ``backward`` backpropagates the
    loss into ``.grad`` (else it runs under ``torch.no_grad()``).  The
    returned tensors are detached; ``p`` is 0 without a pressure term."""
    ode = sim.epoch_fn(dt, assignments["opt_freq"])
    _, g_t, robs, vacf_t, vobs, p_t = observer
    t_range = sys_params["t_range"]
    frame_skip = sys_params.get("frame_skip", 5)
    rdf_w = assignments.get("rdf_weight", 1.0)
    vacf_w = assignments.get("vacf_weight", 0.0)
    use_vacf = (str(assignments.get("train_vacf", "False")) == "True"
                and vacf_t is not None)
    press_w = float(assignments.get("pressure_weight", 0.0))
    press_skip = int(assignments.get("pressure_frame_skip", 10))
    use_press = press_w > 0.0 and p_t is not None
    stack, system = sim.integrator.model, sim.system
    masses, cell = system.get_masses(), system.get_cell()

    def loss_fn(state, aux, ctrl, backward=True):
        with torch.set_grad_enabled(backward):
            traj, final_aux = ode(state, aux, ctrl)
            g = torch.stack([robs(q)[2]
                             for q in traj.q[::frame_skip]]).mean(0)
            loss = rdf_w * ((g - g_t) ** 2).mean()
            vacf_sim = vobs(traj.v)
            if use_vacf:
                loss = loss + vacf_w * (
                    (vacf_sim - vacf_t[:t_range]) ** 2).mean()
            if use_press:
                # each frame's own neighbor state: the entry aux is up to
                # an epoch stale, and a stale table drops migrated pairs
                def frame_pressure(q, v):
                    return thermo.pressure(stack, q, stack.aux_update(q, aux),
                                           v, masses, cell, dim=system.dim)

                # with backward, each frame's virial graph (N K x hidden
                # activations, twice over for the double backward) is
                # recomputed in the backward pass instead of kept for it,
                # as the JAX driver's jax.checkpoint does
                frame = (functools.partial(torch.utils.checkpoint.checkpoint,
                                           frame_pressure,
                                           use_reentrant=False)
                         if backward else frame_pressure)
                p_sim = torch.stack([
                    frame(q, v) for q, v in zip(traj.q[::press_skip],
                                                traj.v[::press_skip])]).mean()
                loss = loss + press_w * (p_sim - p_t) ** 2
            else:
                p_sim = torch.zeros((), dtype=g.dtype, device=g.device)
            if backward:
                loss.backward()
        last = traj._replace(**{
            k: getattr(traj, k)[-1].detach() for k in traj._fields
            if torch.is_tensor(getattr(traj, k))})
        return loss.detach(), (g.detach(), vacf_sim.detach(),
                               p_sim.detach(), last, final_aux)

    return loss_fn


def _obs_plain(obs_log):
    """``obs_log`` with numpy arrays as lists, for a checkpoint."""
    return {tag: {k: [np.asarray(a).tolist() for a in v]
                  for k, v in d.items()} for tag, d in obs_log.items()}


def _obs_numpy(obs_log):
    return {tag: {k: [np.asarray(a) if k != "pressure" else a for a in v]
                  for k, v in d.items()} for tag, d in obs_log.items()}


def fit_lj(assignments, sys_params, model_path=None, log=print,
           registry=None, rng=None, device="cuda"):
    """Train a PairMLP plus a frozen prior against target RDFs (and VACFs
    and pressures); returns a dict with ``loss_log``, ``obs_log``,
    ``params`` (the MLP's final state_dict on the CPU), the recovered
    potential ``u_fit`` (MLP plus prior, shifted to 0 at the cutoff) on
    ``r_grid`` beside ``u_target`` (the truth, where the entry names it)
    and the best epochs' ``u_best`` / ``u_best_eval``, ``eval_log``, and
    ``objective`` (the last epoch's loss), or a NaN bail-out dict.
    ``device``: "cuda" unless "cpu" is asked for."""
    registry = pair_data_dict if registry is None else registry
    rng = np.random.default_rng(0) if rng is None else rng
    n_epochs = sys_params["n_epochs"]
    cutoff = sys_params["cutoff"]
    t_range = sys_params["t_range"]
    if model_path:
        os.makedirs(model_path, exist_ok=True)
        with open(os.path.join(model_path, "paramset.json"), "w") as f:
            json.dump({**{k: str(v) for k, v in sys_params.items()},
                       **{k: str(v) for k, v in assignments.items()}}, f,
                      indent=2)

    comps = build_lj(assignments, sys_params, registry, rng=rng,
                     device=device)
    net, prior = comps["net"], comps["prior"]
    sims, observers = comps["sims"], comps["observers"]
    all_sys, train_list = comps["all_sys"], comps["train_list"]

    ckpt = FitCheckpointer(model_path, every=sys_params.get("ckpt_every", 10))
    resume = ckpt.restore()

    # a warm start replaces the pretraining
    init_pkl = sys_params.get("init_pkl")
    if resume is None and init_pkl:
        net.load_state_dict(pair_mlp_state(init_pkl))
        log(f"warm start from {init_pkl}")

    prior_kind = assignments.get("prior", "ljfamily")
    if (resume is None and not init_pkl
            and sys_params.get("pretrain_iters", 0)):
        T_list = [registry_T_kelvin(registry[t]) for t in all_sys]
        r_lo = min(registry[t].get("start", 0.75) for t in all_sys)
        # a bounded (gauss) prior has no wall below the data: regress
        # further into the core, on the slope-continued targets
        pre_lo = (0.5 * r_lo if prior_kind == "gauss"
                  else max(r_lo, 0.8 * assignments["sigma"]))
        boltzmann_inversion_pretrain(
            net, prior, [o[0] for o in observers], [o[1] for o in observers],
            T_list, rrange=np.linspace(pre_lo, cutoff, 400),
            n_iters=sys_params["pretrain_iters"])

    # Adam with reduce-on-plateau on the MLP only (the prior is frozen)
    update = FitUpdate(net.parameters(), assignments["lr"],
                       assignments.get("grad_clip", 10.0),
                       ReduceOnPlateau(factor=0.5, patience=20,
                                       min_scale=1e-3, atol=5e-5))

    loss_fns, md_states = [], []
    for tag, sim, obs in zip(all_sys, sims, observers):
        dt = sys_params.get("dt") or registry[tag].get("dt", 0.01)
        loss_fns.append(make_lj_epoch_loss(sim, obs, assignments,
                                           sys_params, dt))
        md_states.append(sim.initial_state())

    def ctrl(j):
        return sims[j].integrator.default_ctrl()

    # burn-in: run the MD with the pretrained potential, no updates, so
    # that the first gradients come from its own equilibrium
    burnin = int(sys_params.get("burnin_epochs", 0))
    if resume is None and burnin:
        for j in range(len(all_sys)):
            state, aux = md_states[j]
            for _ in range(burnin):
                _, (_, _, _, state, aux) = loss_fns[j](state, aux, ctrl(j),
                                                       backward=False)
            md_states[j] = (state, aux)
        log(f"burn-in: {burnin} epochs x {len(all_sys)} states equilibrated")

    # every reset_every epochs the states go back to the post-burn-in ones
    # (keeps metastable low-density states on their targets' branch)
    reset_every = int(sys_params.get("state_reset_every", 0))

    # the equilibrated evaluation: branch the states, run eval_eq epochs
    # with the parameters frozen, average the observables over eval_samp
    # more, and score those (the training loss is biased by state drift)
    eval_every = int(sys_params.get("eval_every", 0))
    eval_eq = int(sys_params.get("eval_eq_epochs", 4))
    eval_samp = int(sys_params.get("eval_sample_epochs", 8))
    rdf_w = assignments.get("rdf_weight", 1.0)
    vacf_w = assignments.get("vacf_weight", 0.0)
    press_w = float(assignments.get("pressure_weight", 0.0))
    use_vacf = [str(assignments.get("train_vacf", "False")) == "True"
                and o[3] is not None for o in observers]
    use_press = [press_w > 0.0 and o[5] is not None for o in observers]

    def equilibrated_eval():
        total, detail = 0.0, {}
        for j, tag in enumerate(all_sys):
            _, g_t, _, vacf_t, _, p_t = observers[j]
            state, aux = md_states[j]
            gs, vls, pls = [], [], []
            for i in range(eval_eq + eval_samp):
                _, (g, vacf_sim, p_sim, state, aux) = loss_fns[j](
                    state, aux, ctrl(j), backward=False)
                if i >= eval_eq:
                    gs.append(g.cpu().numpy())
                    vls.append(vacf_sim.cpu().numpy())
                    pls.append(p_sim.item())
            loss = rdf_w * float(((np.mean(gs, axis=0)
                                   - g_t.cpu().numpy()) ** 2).mean())
            if use_vacf[j]:
                loss += vacf_w * float(((np.mean(vls, axis=0)
                                         - vacf_t[:t_range].cpu().numpy())
                                        ** 2).mean())
            if use_press[j]:
                loss += press_w * float((np.mean(pls) - p_t) ** 2)
            detail[tag] = loss
            if tag in train_list:
                total += loss
        return total, detail

    eval_log = []
    loss_log = []
    obs_log = {t: {"rdf": [], "vacf": []} for t in all_sys}
    start_epoch = 0
    if resume is not None:
        net.load_state_dict(resume["params"])
        update.load_state_dict(resume["opt_state"])
        md_states = from_plain(md_states, resume["md_states"])
        loss_log = list(resume["logs"].get("loss_log", []))
        obs_log = _obs_numpy(resume["logs"].get("obs_log", obs_log))
        start_epoch = resume["epoch"] + 1
        log(f"resumed from checkpoint at epoch {resume['epoch']}")
    eq_states = list(md_states) if reset_every else None
    for epoch in range(start_epoch, n_epochs):
        if (reset_every and epoch > start_epoch
                and (epoch - start_epoch) % reset_every == 0):
            md_states = list(eq_states)
        total = 0.0
        update.zero_grad()
        for j, tag in enumerate(all_sys):
            state, aux = md_states[j]
            loss, (g, vacf_sim, p_sim, last, faux) = loss_fns[j](
                state, aux, ctrl(j), backward=tag in train_list)
            overflowed, _ = sims[j].check_flags()
            if not bool(torch.isfinite(last.q).all()):
                log(f"NaN bailout at epoch {epoch} ({tag})")
                return {"objective": 5 - (epoch / n_epochs) * 5,
                        "nan_bailout": True, "loss_log": loss_log}
            if overflowed:
                log(f"WARNING: neighbor capacity overflow ({tag}, epoch "
                    f"{epoch}) -- raise capacity/capacity_slack")
            md_states[j] = (last, faux)
            obs_log[tag]["rdf"].append(g.cpu().numpy())
            obs_log[tag]["vacf"].append(vacf_sim.cpu().numpy())
            obs_log[tag].setdefault("pressure", []).append(p_sim.item())
            if tag in train_list:
                total += loss.item()
        # the best-model files take the parameters this epoch's loss was
        # computed with, before the update
        ckpt.save_best(epoch, total, net.state_dict())
        if eval_every and ((epoch - start_epoch) % eval_every == 0
                           or epoch == n_epochs - 1):
            e_loss, e_detail = equilibrated_eval()
            eval_log.append({"epoch": epoch, "loss": e_loss,
                             "detail": e_detail})
            log(f"epoch {epoch} | eval(eq) loss: {e_loss:.6f}")
            ckpt.save_best(epoch, e_loss, net.state_dict(),
                           fname="best_eval.pt")
        update(total)
        loss_log.append(total)
        log(f"epoch {epoch} | loss: {total:.6f}")
        ckpt.maybe_save(epoch, net.state_dict(), update.state_dict(),
                        md_states, {"loss_log": loss_log,
                                    "obs_log": _obs_plain(obs_log)})

    # the recovered potential on a grid, shifted to 0 at the cutoff
    p0 = next(net.parameters())
    r_grid = np.linspace(0.3, cutoff, 250)
    r_t = torch.tensor(r_grid, dtype=p0.dtype, device=p0.device)[:, None]

    def u_of(state):
        if state is not None:
            net.load_state_dict(state)
        with torch.no_grad():
            u = (net(r_t) + prior(r_t)).squeeze(-1).cpu().numpy()
        return u - u[-1]

    final = {k: v.detach().clone() for k, v in net.state_dict().items()}
    u_fit = u_of(None)
    target_spec = registry[train_list[0]].get("target_pot")
    u_target = None
    if target_spec is not None:
        tp = resolve_target_pot(target_spec).to(p0.device)
        with torch.no_grad():
            u_t = tp(r_t.float()).squeeze(-1).cpu().numpy()
        u_target = u_t - u_t[-1]
    best = {fname: ckpt.load_best(fname)
            for fname in ("best.pt", "best_eval.pt")}
    u_best, u_best_eval = (None if best[f] is None else u_of(best[f]["params"])
                           for f in ("best.pt", "best_eval.pt"))
    net.load_state_dict(final)

    def info(fname, key):
        return None if best[fname] is None else best[fname][key]

    results = {"loss_log": loss_log, "obs_log": obs_log,
               "params": {k: v.cpu() for k, v in final.items()},
               "r_grid": r_grid, "u_fit": u_fit, "u_target": u_target,
               "u_best": u_best, "u_best_eval": u_best_eval,
               "best_epoch": info("best.pt", "epoch"),
               "best_loss": info("best.pt", "loss"),
               "best_eval_epoch": info("best_eval.pt", "epoch"),
               "best_eval_loss": info("best_eval.pt", "loss"),
               "eval_log": eval_log,
               "objective": loss_log[-1] if loss_log else float("nan")}
    if model_path:
        np.savetxt(os.path.join(model_path, "loss.txt"),
                   np.asarray(loss_log))
        np.savetxt(os.path.join(model_path, "potential.txt"),
                   np.vstack([r_grid, u_fit]))
        if u_best is not None:
            np.savetxt(os.path.join(model_path, "potential_best.txt"),
                       np.vstack([r_grid, u_best]))
        if eval_log:
            with open(os.path.join(model_path, "eval_log.json"), "w") as f:
                json.dump(eval_log, f, indent=2)
        if u_best_eval is not None:
            np.savetxt(os.path.join(model_path, "potential_best_eval.txt"),
                       np.vstack([r_grid, u_best_eval]))
        from .plots import plot_loss, plot_pair
        plot_pair(r_grid, u_fit, u_target, "final", model_path)
        if u_best is not None:
            plot_pair(r_grid, u_best, u_target, "best", model_path)
        if u_best_eval is not None:
            plot_pair(r_grid, u_best_eval, u_target, "best_eval",
                      model_path)
        plot_loss(loss_log, model_path)
    return results
