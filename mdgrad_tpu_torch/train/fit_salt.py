"""Molten-salt charge recovery: fit the magnitude of the charges of a
two-species melt from its partial radial distribution functions, through
the trajectory with Ewald forces (port of ``mdgrad_tpu/train/fit_salt.py``).

The ground truth is simulated at the charge magnitude ``q_true``; the
fit starts at ``q0`` and follows the like-pair and unlike-pair g(r),
whose split the long-range Coulomb ordering drives.  The model is a
frozen ExcludedVolume(sigma, eps, 9) core plus :class:`ScaledChargeEwald`,
q_i = qscale * (+1 for Na, -1 for Cl), with ``qscale`` its one parameter.

The optimizer clips the gradient to global norm 1 and takes Adam steps
whose rate follows a cosine decay to 0.05 of ``lr`` over the epochs (the
JAX ``fit_salt``'s ``clip_by_global_norm(1.0)`` then ``adam(cosine_decay)``).
The result keeps the ``qscale`` that made the lowest exponential moving
average of the epoch loss (decay 0.8, after 10 warm-up epochs), since one
epoch's loss is noisy.  The partial RDFs are the dense ``'xla'`` ones:
the pallas backend takes no ``index_tuple``, as in the JAX package.  No
kernel of ``csrc/`` runs on this path.
"""

import json
import os

import numpy as np
import torch
from torch import nn

from .. import potentials as pot_zoo, units
from .._device import resolve_device
from ..interface import EwaldElectrostatics, PairPotentials, Stack
from ..md import NoseHooverChain, Simulation
from ..observables import rdf as rdf_obs_cls
from ..system import System
from .optim import FitUpdate, cosine_decay


class ScaledChargeEwald(EwaldElectrostatics):
    """Ewald over the fixed +-1 ``pattern`` times the parameter
    ``qscale`` (float32, from ``qscale0``); U scales as qscale^2.  Its
    real sum is the dense one in any mode, as the JAX package's."""

    def __init__(self, system, pattern, qscale0, **kw):
        super().__init__(system, pattern, learn_charges=False, **kw)
        self.qscale0 = float(qscale0)
        self.qscale = nn.Parameter(torch.tensor(
            self.qscale0, dtype=torch.float32, device=self.cell0.device))

    def energy(self, xyz, aux, cell=None):
        q = self.qscale * self.charges0.to(xyz.dtype)
        return self._ewald.ewald_energy(
            q, xyz, self._cell0(xyz, cell), self.nvecs, self.alpha,
            self.r_cut, extra_mask=self.extra_mask, ex_pairs=self.ex_pairs)


def rocksalt_melt(n_cells=3, a=6.2, T_kelvin=2500.0, rng=None):
    """NaCl rock salt of ``n_cells``^3 conventional cells of side ``a``
    (expanded: the expansion and the high temperature melt it in the
    burn-in), velocities at ``T_kelvin`` drawn from ``rng``."""
    frac_na = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                        [0, 0.5, 0.5]])
    frac_cl = (frac_na + 0.5) % 1.0
    xyz, nums = [], []
    for i in range(n_cells):
        for j in range(n_cells):
            for k in range(n_cells):
                off = np.array([i, j, k])
                xyz.append((frac_na + off) * a)
                nums += [11] * 4
                xyz.append((frac_cl + off) * a)
                nums += [17] * 4
    system = System(np.concatenate(xyz), cell=np.eye(3) * a * n_cells,
                    numbers=nums)
    system.set_temperature(T_kelvin, rng=rng)
    return system


def build_sim(system, qscale0, q_truth_mode=False, r_cut=None,
              T_kelvin=2500.0, sigma=2.3, eps=0.1, accuracy=3.2,
              device="cuda", dtype=torch.float32):
    """(Simulation, NoseHooverChain) of Stack{core, coul} at ``T_kelvin``
    (Q 50, 5 chains): the core's cutoff is ``r_cut`` or 0.98 of half the
    box, and the Ewald real sum shares it.  ``q_truth_mode``: no adjoint
    (the target run)."""
    device = resolve_device(device)
    z = np.asarray(system.get_atomic_numbers())
    pattern = np.where(z == 11, 1.0, -1.0)
    core = PairPotentials(
        system, pot_zoo.ExcludedVolume(sigma=sigma, epsilon=eps, power=9),
        cutoff=min(r_cut or 1e9, float(np.diag(np.asarray(
            system.get_cell())).min()) / 2 * 0.98), device=device)
    coul = ScaledChargeEwald(system, pattern, qscale0, r_cut=core.cutoff,
                             accuracy=accuracy, device=device)
    stack = Stack({"core": core, "coul": coul}).to(dtype)
    integ = NoseHooverChain(stack, system, T=T_kelvin, Q=50.0,
                            num_chains=5, adjoint=not q_truth_mode,
                            device=device, dtype=dtype)
    return Simulation(system, integ), integ


def partial_rdf_observers(system, nbins=64, r_range=(1.6, 7.8),
                          device="cuda"):
    """(g_like, g_unlike): the Na-Na and Na-Cl soft-histogram RDFs, the
    range cut at 0.98 of half the box."""
    z = np.asarray(system.get_atomic_numbers())
    na = np.nonzero(z == 11)[0]
    cl = np.nonzero(z == 17)[0]
    half = float(np.diag(np.asarray(system.get_cell())).min()) / 2
    r_range = (r_range[0], min(r_range[1], half * 0.98))
    g_like = rdf_obs_cls(system, nbins, r_range, index_tuple=(na, na),
                         device=device)
    g_unlike = rdf_obs_cls(system, nbins, r_range, index_tuple=(na, cl),
                           device=device)
    return g_like, g_unlike


def _mean_g(obs, frames):
    """The mean over ``frames`` of each frame's own g(r)."""
    return torch.stack([obs(q)[2] for q in frames]).mean(0)


def _last(traj):
    """The last frame of a trajectory of states, detached."""
    return traj._replace(**{k: getattr(traj, k)[-1].detach()
                            for k in traj._fields
                            if torch.is_tensor(getattr(traj, k))})


def generate_targets(system, q_true, n_sim=16, steps=80, dt=None, burn=6,
                     T_kelvin=2500.0, log=print, device="cuda",
                     dtype=torch.float32, **build_kw):
    """Simulate the charge magnitude ``q_true``: ``burn`` epochs of
    ``steps`` frames, then ``n_sim`` more whose every 4th frame's partial
    RDFs are averaged.  Returns (g_like, g_unlike) as numpy and the last
    state."""
    dt = dt or 1.0 * units.fs
    sim, integ = build_sim(system, q_true, q_truth_mode=True,
                           T_kelvin=T_kelvin, device=device, dtype=dtype,
                           **build_kw)
    g_like, g_unlike = partial_rdf_observers(system, device=device)
    run = sim.epoch_fn(dt, steps)
    state, aux = sim.initial_state()
    ctrl = integ.default_ctrl()
    acc_l, acc_u = 0.0, 0.0
    with torch.no_grad():
        for i in range(burn + n_sim):
            traj, aux = run(state, aux, ctrl)
            state = _last(traj)
            if i >= burn:
                frames = traj.q[::4]
                acc_l = acc_l + _mean_g(g_like, frames)
                acc_u = acc_u + _mean_g(g_unlike, frames)
    g_l = (acc_l / n_sim).cpu().numpy()
    g_u = (acc_u / n_sim).cpu().numpy()
    log(f"targets: like peak {g_l.max():.2f}, unlike peak {g_u.max():.2f}")
    return g_l, g_u, state


def make_salt_epoch_loss(sim, observers, targets, dt, tau, frame_skip=3):
    """``loss_fn(state, aux, ctrl, backward) -> (loss, (last,
    final_aux))``: one epoch of ``tau - 1`` steps, the MSE of the mean
    like and unlike g(r) of every ``frame_skip``-th frame against
    ``targets``; with ``backward`` the loss is backpropagated through the
    replay adjoint into ``.grad``.  The returned values are detached."""
    ode = sim.epoch_fn(dt, tau)
    g_like, g_unlike = observers
    like = sim.integrator.masses
    g_l_t, g_u_t = (torch.as_tensor(np.asarray(t), dtype=like.dtype,
                                    device=like.device) for t in targets)

    def loss_fn(state, aux, ctrl, backward=True):
        with torch.set_grad_enabled(backward):
            traj, final_aux = ode(state, aux, ctrl)
            frames = traj.q[::frame_skip]
            loss = (((_mean_g(g_like, frames) - g_l_t) ** 2).mean()
                    + ((_mean_g(g_unlike, frames) - g_u_t) ** 2).mean())
            if backward:
                loss.backward()
        return loss.detach(), (_last(traj), final_aux)

    return loss_fn


def fit_salt(model_path=None, n_cells=3, a=6.2, T_kelvin=2500.0,
             q_true=0.8, q0=0.4, n_epochs=200, tau=60, dt=None,
             frame_skip=3, lr=2e-2, target_nsim=16, log=print, rng=None,
             device="cuda", dtype=torch.float32, **build_kw):
    """Recover the charge magnitude from the partial RDFs; returns the
    result dict (``q_final``, ``q_best`` and ``best_epoch`` of the
    smoothed loss, the history), also written to
    ``model_path/result.json``."""
    device = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    dt = dt or 1.0 * units.fs
    system = rocksalt_melt(n_cells, a, T_kelvin, rng=rng)
    g_l_t, g_u_t, warm_state = generate_targets(
        system, q_true, n_sim=target_nsim, T_kelvin=T_kelvin, dt=dt,
        log=log, device=device, dtype=dtype, **build_kw)

    sim, integ = build_sim(system, q0, T_kelvin=T_kelvin, device=device,
                           dtype=dtype, **build_kw)
    stack = integ.model
    stack.models["core"].requires_grad_(False)
    coul = stack.models["coul"]
    loss_fn = make_salt_epoch_loss(
        sim, partial_rdf_observers(system, device=device), (g_l_t, g_u_t),
        dt, tau, frame_skip)
    # start from the truth run's final state: the melt is a fine initial
    # condition for any q
    _, aux = sim.initial_state()
    state = warm_state
    ctrl = integ.default_ctrl()
    # cosine decay: at a constant lr of 2e-2 the JAX run overshot q* and
    # rang around it (the energy is quadratic in qscale)
    update = FitUpdate([coul.qscale], lr, grad_clip=1.0,
                       schedule=cosine_decay(max(int(n_epochs), 1), 0.05))

    history = []
    ema = None
    best = None  # (ema_loss, qscale, epoch)
    ema_decay, warmup = 0.8, 10
    for ep in range(n_epochs):
        loss, (last, aux) = loss_fn(state, aux, ctrl)
        loss = float(loss)
        if not np.isfinite(loss):
            log(f"epoch {ep}: NaN loss, stopping")
            update.zero_grad()
            break
        qs_pre = coul.qscale.item()  # the parameter that made `loss`
        ema = loss if ema is None else ema_decay * ema + (1 - ema_decay) * loss
        if ep >= warmup and (best is None or ema < best[0]):
            best = (ema, qs_pre, ep)
        state = last
        update()
        qs = coul.qscale.item()
        history.append({"epoch": ep, "loss": loss, "qscale": qs,
                        "ema_loss": ema})
        if ep % 10 == 0 or ep == n_epochs - 1:
            log(f"epoch {ep:4d} | loss {loss:.5f} | qscale {qs:.4f}"
                f" (truth {q_true})")

    result = {"q_true": q_true, "q0": q0,
              "q_final": history[-1]["qscale"] if history else q0,
              "loss_final": history[-1]["loss"] if history else None,
              "q_best": best[1] if best else
              (history[-1]["qscale"] if history else q0),
              "best_epoch": best[2] if best else None,
              "best_ema_loss": best[0] if best else None,
              "history": history}
    if best:
        log(f"best (EMA-selected): qscale {best[1]:.4f} at epoch {best[2]}"
            f" (truth {q_true})")
    if model_path:
        os.makedirs(model_path, exist_ok=True)
        with open(os.path.join(model_path, "result.json"), "w") as f:
            json.dump(result, f, indent=2)
    return result
