"""Differentiable Trajectory Reweighting (DiffTRe): fit a potential to
ensemble observables without differentiating through the trajectory.

Port of ``mdgrad_tpu/train/difftre.py`` (Thaler & Zavadlav, Nat. Commun.
12, 6884 (2021)).  F decorrelated frames x_i are sampled once from the
ensemble of the current potential U_ref; any ensemble average under the
perturbed potential U_theta is then the importance-weighted sum

    <O>_theta = sum_i w_i O_i,   w = softmax(-(U_theta(x_i) - U_ref(x_i)) / kT),

valid while the effective sample size stays near F (the ``ess_min``
guard resamples).  Per-frame RDFs do not depend on theta and are computed
once a sampling; a gradient step then costs F energy evaluations, no
adjoint.  The virial pressure depends on theta and is recomputed and
reweighted.

The parameters are those of the interactions' modules (the JAX package
passes a params pytree); the optimizer is a
:class:`~mdgrad_tpu_torch.train.optim.FitUpdate` over the trainable ones
(Adam with optax's defaults).  Per-frame maps run in chunks of
``FRAME_CHUNK`` frames, each under ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint`` over ``lax.map`` chunks): live memory is one
chunk's, and the backward recomputes each chunk -- the all-frames batch
of the per-frame virial ran out of memory at workload scale in the JAX
package.  The auxes of the frames are a list, one per frame.
"""

import copy

import numpy as np
import torch
import torch.utils.checkpoint

from ..md import rethermalize

FRAME_CHUNK = 8


def _map_frames(fn, frames, auxs, frame_chunk=FRAME_CHUNK):
    """``fn(q, aux)`` over the frames, stacked; chunks of ``frame_chunk``
    frames, each checkpointed while gradients are recorded."""
    chunk = max(min(int(frame_chunk), frames.shape[0]), 1)
    outs = []
    for start in range(0, frames.shape[0], chunk):
        part = auxs[start:start + chunk]

        def body(fr, part=part):
            return torch.stack([fn(q, a) for q, a in zip(fr, part)])

        fr = frames[start:start + chunk]
        outs.append(torch.utils.checkpoint.checkpoint(
            body, fr, use_reentrant=False) if torch.is_grad_enabled()
            else body(fr))
    return torch.cat(outs)


def log_weights(interaction, kT, frames, auxs, u_ref,
                frame_chunk=FRAME_CHUNK):
    """Unnormalized log importance weights -(U_theta - U_ref) / kT, U_theta
    the interaction's energy at its current parameters."""
    u = _map_frames(lambda q, a: interaction.energy(q, a), frames, auxs,
                    frame_chunk)
    return -(u - u_ref) / kT


def ess_fraction(w):
    """Effective-sample-size fraction ESS / F = 1 / (F sum w^2), in
    (0, 1]."""
    return 1.0 / (w.shape[0] * torch.sum(w ** 2))


def config_pressures(interaction, kT, dim, cell_len, frames, auxs,
                     frame_chunk=FRAME_CHUNK):
    """Per-frame configurational pressure with the canonical kinetic part:
    P_i = (N_dof kT + W_i) / (dim V), W_i = -dU/d(strain) through the
    interaction's ``cell=`` override.  Differentiable in the interaction's
    parameters (the virial's graph is kept while gradients are recorded,
    chunk by chunk)."""
    cell_len = torch.as_tensor(cell_len, dtype=frames.dtype,
                               device=frames.device)
    volume = torch.abs(torch.prod(cell_len))
    n_dof = frames.shape[-2] * dim
    create_graph = torch.is_grad_enabled()

    def virial(q, a):
        with torch.enable_grad():
            eps = torch.zeros((), dtype=q.dtype, device=q.device,
                              requires_grad=True)
            u = interaction.energy((1.0 + eps) * q, a,
                                   cell=(1.0 + eps) * cell_len)
            (du,) = torch.autograd.grad(u, eps, create_graph=create_graph)
        return -du

    w = _map_frames(virial, frames, auxs, frame_chunk)
    return (n_dof * kT + w) / (dim * volume)


def sample_frames(sim, n_frames, steps_between, dt, equil_steps=0,
                  ctrl=None):
    """(n_frames, N, 3) frames of ``sim`` at the current parameters, one
    every ``steps_between`` steps after ``equil_steps`` of equilibration,
    through ``Simulation.simulate`` (no gradient reaches them)."""
    if equil_steps:
        sim.simulate(steps=equil_steps, dt=dt, frequency=equil_steps,
                     ctrl=ctrl)
    frames = []
    for _ in range(int(n_frames)):
        traj = sim.simulate(steps=steps_between, dt=dt,
                            frequency=steps_between, ctrl=ctrl)
        frames.append(traj.q[-1])
    return torch.stack(frames)


def make_bundle(interaction, frames, obs=None):
    """The per-sampling arrays: the frames, each frame's neighbor aux, the
    reference energies at the current parameters and, with ``obs``, each
    frame's g(r); a dict (the JAX package's ``make_bundle`` with its
    ``params_ref`` the module's current parameters)."""
    with torch.no_grad():
        aux0 = interaction.aux_init(frames[0])
        auxs = [interaction.aux_update(q, aux0) for q in frames]
        u_ref = _map_frames(lambda q, a: interaction.energy(q, a), frames,
                            auxs)
        bundle = {"frames": frames, "auxs": auxs, "u_ref": u_ref}
        if obs is not None:
            bundle["g_frames"] = torch.stack([obs(q)[2] for q in frames])
    return bundle


class ReweightEstimator:
    """One frame set and one interaction: :meth:`weights` and
    :meth:`frame_pressures` at the interaction's current parameters,
    against the reference energies taken at construction."""

    def __init__(self, interaction, frames, kT, dim=3, cell=None):
        self.interaction = interaction
        self.kT = float(kT)
        self.dim = int(dim)
        if cell is not None:
            cell = torch.as_tensor(np.asarray(cell), dtype=frames.dtype,
                                   device=frames.device)
            cell = torch.diagonal(cell) if cell.dim() == 2 else cell
        self.cell_len = cell
        b = make_bundle(interaction, frames)
        self.frames, self.auxs, self.u_ref = (b["frames"], b["auxs"],
                                              b["u_ref"])

    def weights(self):
        w = torch.softmax(log_weights(self.interaction, self.kT,
                                      self.frames, self.auxs, self.u_ref),
                          dim=0)
        return w, ess_fraction(w)

    def frame_pressures(self):
        if self.cell_len is None:
            raise ValueError("pass cell= to ReweightEstimator for "
                             "pressure reweighting")
        return config_pressures(self.interaction, self.kT, self.dim,
                                self.cell_len, self.frames, self.auxs)


def make_rdf_loss(est, g_frames, g_target, pressure_target=None,
                  pressure_weight=0.0):
    """``loss_fn() -> (loss, {'ess', 'g_hat'[, 'p_hat']})`` at the current
    parameters: the MSE of the reweighted g(r) against ``g_target``, plus
    ``pressure_weight`` times the squared error of the reweighted
    configurational pressure (the same weights)."""
    g_target = torch.as_tensor(g_target, dtype=g_frames.dtype,
                               device=g_frames.device)

    def loss_fn():
        w, ess = est.weights()
        g_hat = w @ g_frames
        loss = ((g_hat - g_target) ** 2).mean()
        out = {"ess": ess, "g_hat": g_hat}
        if pressure_weight and pressure_target is not None:
            p_hat = torch.dot(w, est.frame_pressures())
            loss = loss + pressure_weight * (p_hat - pressure_target) ** 2
            out["p_hat"] = p_hat
        return loss, out

    return loss_fn


def _states(modules):
    return [copy.deepcopy(m.state_dict()) for m in modules]


def difftre_fit(sims, observers, targets, kTs, cells, opt, dt, n_outer=20,
                inner_steps=50, n_frames=40, steps_between=20,
                equil_steps=200, ess_min=0.9, pressure_targets=None,
                pressure_weight=0.0, dim=3, frame_chunk=FRAME_CHUNK,
                log=print, on_outer=None, on_best=None, rng=None):
    """Multi-state DiffTRe: sample with the current parameters, then take
    up to ``inner_steps`` deterministic steps of ``opt`` (a
    :class:`~mdgrad_tpu_torch.train.optim.FitUpdate` over the trainable
    parameters) on the summed reweighted loss, resampling when any state's
    ESS fraction drops below ``ess_min``.

    ``sims``, ``observers``, ``targets``, ``kTs`` and ``cells`` are
    per-state lists; the states' interactions share the trained modules.
    Returns the history: per outer, ``loss`` (the uniform-weight loss on
    the fresh frames, an unbiased estimate of the entry parameters' loss),
    ``loss_rw`` (the last inner iterate's reweighted loss), the smallest
    ``ess``, the ``inner`` steps taken, ``step_scale`` and ``p_hat``.
    ``on_best(outer, loss0, entry_state)`` fires at each new lowest
    ``loss``, with the outer's entry state dicts of the interactions;
    ``on_outer(outer, history)`` after every clean outer.

    A non-finite sampling, loss or ESS reverts the parameters, the
    optimizer and the MD states to the last good snapshot, rethermalizes
    (fresh Maxwell-Boltzmann momenta from ``rng``; a state never sampled
    cleanly restarts from the lattice), halves the step scale (applied to
    Adam's step) and re-equilibrates; below 1/64 the fit stops.  The step
    scale grows back by 1.26 a clean outer.
    """
    if inner_steps < 1:
        raise ValueError("inner_steps must be >= 1")
    interactions = [sim.integrator.model for sim in sims]
    modules = list({id(m): m for m in interactions}.values())
    kT_l = [float(k) for k in kTs]
    like = next(interactions[0].parameters())
    cl_l = []
    for c in cells:
        if c is not None:
            c = np.asarray(c, dtype=np.float64)
            c = torch.tensor(np.diag(c) if c.ndim == 2 else c,
                             dtype=like.dtype, device=like.device)
        cl_l.append(c)
    tgt_l = [torch.as_tensor(t, dtype=like.dtype, device=like.device)
             for t in targets]
    p_tgt = pressure_targets

    def total_loss(bundles):
        losses, esss, p_hats = [], [], []
        for i, b in enumerate(bundles):
            w = torch.softmax(log_weights(interactions[i], kT_l[i],
                                          b["frames"], b["auxs"],
                                          b["u_ref"], frame_chunk), dim=0)
            esss.append(ess_fraction(w))
            loss = ((w @ b["g_frames"] - tgt_l[i]) ** 2).mean()
            if pressure_weight and p_tgt is not None:
                p_i = config_pressures(interactions[i], kT_l[i], dim,
                                       cl_l[i], b["frames"], b["auxs"],
                                       frame_chunk)
                p_hat = torch.dot(w, p_i)
                p_hats.append(p_hat)
                loss = loss + pressure_weight * (p_hat - p_tgt[i]) ** 2
            losses.append(loss)
        return (torch.stack(losses).sum(), torch.stack(esss).min(),
                torch.stack(p_hats).detach() if p_hats else None)

    history = []
    rng = np.random.default_rng(0) if rng is None else rng
    step_scale, step_scale_min = 1.0, 1.0 / 64
    best_loss0 = float("inf")
    last_good = (_states(modules), opt.state_dict(), [None] * len(sims))
    need_equil = False

    def revert(outer, why):
        nonlocal step_scale, need_equil
        states, opt_state, good_states = last_good
        for m, st in zip(modules, states):
            m.load_state_dict(st)
        opt.load_state_dict(opt_state)
        opt.zero_grad()
        step_scale *= 0.5
        need_equil = True
        for i, (sim, st) in enumerate(zip(sims, good_states)):
            if st is None:
                # never sampled cleanly: the lattice, with FRESH momenta (a
                # replay of the system's own velocities fails alike)
                st, sim.aux = sim.initial_state()
            sim.state = rethermalize(st, kT_l[i], sim.system.get_masses(),
                                     rng=rng, dim=getattr(sim.system, "dim",
                                                          3))
        log(f"outer {outer:3d} | {why}; reverted params+opt, "
            f"rethermalized, step_scale -> {step_scale:g}")
        return step_scale < step_scale_min

    for outer in range(int(n_outer)):
        bundles, bad = [], None
        for sim, obs in zip(sims, observers):
            frames = sample_frames(
                sim, n_frames, steps_between, dt,
                equil_steps if (outer == 0 or need_equil) else 0)
            if not bool(torch.isfinite(frames).all()):
                bad = "non-finite sampling"
                break
            bundles.append(make_bundle(sim.integrator.model, frames,
                                       obs=obs))
        if bad:
            if revert(outer, bad):
                log("step_scale exhausted; stopping")
                break
            continue
        need_equil = False
        last_good = (_states(modules), opt.state_dict(),
                     [sim.state for sim in sims])
        entry_state = last_good[0]

        inner_done = 0
        loss0 = None
        for _ in range(int(inner_steps)):
            opt.zero_grad()
            loss, ess_t, p_hat = total_loss(bundles)
            value, ess = loss.item(), ess_t.item()
            if loss0 is None:
                # the uniform-weight loss at the sampling parameters
                loss0 = value
            if not (np.isfinite(value) and np.isfinite(ess)):
                bad = f"non-finite loss ({value}) or ESS ({ess})"
                break
            if ess < ess_min:
                break
            loss.backward()
            opt(step_scale=step_scale)
            inner_done += 1
        opt.zero_grad()
        if bad:
            if revert(outer, bad):
                log("step_scale exhausted; stopping")
                break
            continue
        step_scale = min(1.0, step_scale * 1.26)
        if on_best is not None and loss0 < best_loss0:
            best_loss0 = loss0
            on_best(outer, loss0, entry_state)
        row = {"outer": outer, "loss": loss0, "loss_rw": value, "ess": ess,
               "inner": inner_done, "step_scale": step_scale}
        if p_hat is not None:
            row["p_hat"] = p_hat.cpu().numpy().tolist()
        history.append(row)
        log(f"outer {outer:3d} | loss {loss0:.6f} (rw {value:.6f})"
            f" | min ESS/F {ess:.3f} | inner steps {inner_done}")
        if on_outer is not None:
            on_outer(outer, history)
    return history
