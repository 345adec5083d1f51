"""NVE and Nose-Hoover chain NVT integration with a cached force.

Port of ``mdgrad_tpu/md/integrators.py``: the ``_MDIntegrator`` force
dispatch, ``prime_state`` and the cached symplectic step, ``NVE``,
``NoseHooverChain`` with ``update_T``, and ``rethermalize``.  An
interaction with a ``force`` method (the fused
pair kernels' :class:`~mdgrad_tpu_torch.ops.pair.PallasLJPair`) supplies
the force itself; for any other, forces are ``-dU/dq`` from
``torch.autograd.grad``.  With ``create_graph=False`` (the sampling path)
either comes without a graph; with ``create_graph=True``, where a loss
differentiates through the trajectory, it stays on the graph to ``q`` and
to the potential's parameters -- differentiable to any order through
autograd of the energy, as ``-jax.grad`` of the energy is in the JAX
package, and to first order through a ``force`` method's own backward,
as its JAX ``custom_vjp`` is.

The end-of-step force equals the next step's start force, so each step
evaluates the potential once; ``prime_state`` fills the cache at epoch
entry.  ``fv`` (force valid) is a Python bool here, so checking it never
waits for the device.
"""

import typing

import numpy as np
import torch

from .. import units
from .._device import resolve_device
from ..system import check_system, maxwell_boltzmann_velocities


class NVEStateF(typing.NamedTuple):
    v: torch.Tensor
    q: torch.Tensor
    f: torch.Tensor    # cached force at q
    fv: bool           # the cached force is valid


class NVTStateF(typing.NamedTuple):
    v: torch.Tensor
    q: torch.Tensor
    pv: torch.Tensor   # Nose-Hoover chain bath momenta
    f: torch.Tensor    # cached force at q
    fv: bool           # the cached force is valid


class _MDIntegrator:
    """Force evaluation and the cached velocity-Verlet-family step."""

    def __init__(self, potentials, system, adjoint=True,
                 topology_update_freq=1, device="cuda", dtype=torch.float32):
        check_system(system)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = potentials
        self.system = system
        self.masses = torch.as_tensor(system.get_masses(), dtype=dtype,
                                      device=self.device)[:, None]
        self.n_dof = system.get_number_of_atoms() * system.dim
        # True: epochs differentiate through the replay adjoint (per-step
        # states stored, steps re-run in reverse); False: plain autograd
        # through the step loop (see md/adjoint.py)
        self.adjoint = adjoint
        self.topology_update_freq = topology_update_freq

    def aux_init(self, q):
        return self.model.aux_init(q)

    def aux_update(self, q, aux):
        return self.model.aux_update(q, aux)

    def default_ctrl(self):
        return {}

    def force(self, q, aux, create_graph=False):
        """The force at ``q``: the interaction's own ``force`` when it has
        one, else -dU/dq.  ``create_graph=False``: no graph kept.
        ``create_graph=True``: on the graph to ``q`` (when ``q`` requires
        grad) and to the potential's parameters."""
        if hasattr(self.model, "force"):
            if create_graph:
                return self.model.force(q, aux)
            with torch.no_grad():
                return self.model.force(q.detach(), aux)
        with torch.enable_grad():
            if not (create_graph and q.requires_grad):
                q = q.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.model.energy(q, aux), q,
                                       create_graph=create_graph)
        return -g

    def prime_state(self, state, aux, create_graph=False):
        """Refresh ``aux`` at ``state.q`` and fill the force cache; returns
        ``(state, aux)``."""
        aux = self.model.aux_update(state.q.detach(), aux)
        f = self.force(state.q, aux, create_graph)
        return state._replace(f=f, fv=True), aux

    def step(self, state, aux, ctrl, dt, create_graph=False):
        """One step with ONE potential evaluation: the start-of-step force
        is the cached end-of-step force of the previous step.  The bath
        half-kicks run only for an integrator with a bath
        (``derivs_from_force`` returns its derivative, not None)."""
        f0 = state.f if state.fv else self.force(state.q, aux, create_graph)
        dv0, dbath0 = self.derivs_from_force(state, ctrl, f0)
        v_half = state.v + 0.5 * dt * dv0
        q_new = state.q + v_half * dt
        mid = state._replace(v=v_half, q=q_new)
        if dbath0 is not None:
            mid = mid._replace(pv=state.pv + 0.5 * dt * dbath0)
        f1 = self.force(q_new, aux, create_graph)
        dv1, dbath1 = self.derivs_from_force(mid, ctrl, f1)
        new = mid._replace(v=v_half + 0.5 * dt * dv1, f=f1, fv=True)
        if dbath1 is not None:
            new = new._replace(pv=mid.pv + 0.5 * dt * dbath1)
        return new


class NVE(_MDIntegrator):
    """Constant-energy velocity Verlet with the cached force."""

    state_keys = ["velocities", "positions"]

    def initial_state(self, wrap=True):
        kw = {"dtype": self.dtype, "device": self.device}
        q = torch.as_tensor(self.system.get_positions(wrap=wrap), **kw)
        return NVEStateF(
            v=torch.as_tensor(self.system.get_velocities(), **kw), q=q,
            f=torch.zeros_like(q), fv=False)

    def derivs_from_force(self, state, ctrl, f):
        """(dv/dt, None): no bath."""
        return f / self.masses, None


class NoseHooverChain(_MDIntegrator):
    """NVT through a Nose-Hoover chain; T in Kelvin, bath masses
    [Q, Q/N, ..., Q/N], or the Martyna-Tuckerman-Klein masses from ``tau``.
    """

    state_keys = ["velocities", "positions", "baths"]

    def __init__(self, potentials, system, T, num_chains=2, Q=1.0,
                 adjoint=True, topology_update_freq=1, tau=None,
                 device="cuda", dtype=torch.float32):
        super().__init__(potentials, system, adjoint, topology_update_freq,
                         device=device, dtype=dtype)
        if num_chains < 2:
            raise ValueError("NoseHooverChain needs num_chains >= 2")
        self.T = T
        self.num_chains = num_chains
        n = system.get_number_of_atoms()
        if tau is not None:
            kT0 = T * units.kB
            q = [self.n_dof * kT0 * tau ** 2] + [kT0 * tau ** 2] * (
                num_chains - 1)
        else:
            q = [Q] + [Q / n] * (num_chains - 1)
        self.Q = torch.tensor(q, dtype=dtype, device=self.device)

    def update_T(self, T):
        """Set the bath temperature ``T`` (Kelvin) and return the new
        ``default_ctrl()``, for annealing; the chain masses keep their
        construction temperature."""
        self.T = T
        return self.default_ctrl()

    def default_ctrl(self):
        return {"kT": torch.tensor(self.T * units.kB, dtype=self.dtype,
                                   device=self.device)}

    def initial_state(self, wrap=True):
        kw = {"dtype": self.dtype, "device": self.device}
        q = torch.as_tensor(self.system.get_positions(wrap=wrap), **kw)
        return NVTStateF(
            v=torch.as_tensor(self.system.get_velocities(), **kw), q=q,
            pv=torch.zeros(self.num_chains, **kw), f=torch.zeros_like(q),
            fv=False)

    def derivs_from_force(self, state, ctrl, f):
        """Chain equations of motion given the force: (dv/dt, dpv/dt)."""
        kT = ctrl["kT"]
        v, pv, m, Q = state.v, state.pv, self.masses, self.Q
        p = v * m
        sys_ke = 0.5 * (p ** 2 / m).sum()
        dvdt = (f - pv[0] * p / Q[0]) / m
        dpv0 = 2 * (sys_ke - kT * self.n_dof * 0.5) - pv[0] * pv[1] / Q[1]
        dpv_mid = ((pv[:-2] ** 2 / Q[:-2] - kT)
                   - pv[2:] * pv[1:-1] / Q[2:])
        dpv_last = pv[-2] ** 2 / Q[-2] - kT
        return dvdt, torch.cat([dpv0[None], dpv_mid, dpv_last[None]])


def rethermalize(state, kT, masses, rng=None, dim=3):
    """``state`` with fresh Maxwell-Boltzmann velocities at ``kT`` (energy
    units) drawn from the numpy Generator ``rng``, the bath momenta zeroed
    and the force cache marked stale; positions are kept.

    The fit's NaN recovery restores a finite snapshot and retries: a Nose-
    Hoover trajectory is deterministic, so a blowup driven by the state
    would otherwise recur on every retry.  The draws are the JAX
    package's, so the same ``rng`` gives the same velocities.
    """
    v = maxwell_boltzmann_velocities(np.asarray(masses), float(kT), rng=rng)
    if dim < 3:
        v[:, dim:] = 0.0
    upd = {"v": torch.as_tensor(v, dtype=state.v.dtype,
                                device=state.v.device)}
    if hasattr(state, "pv"):
        upd["pv"] = torch.zeros_like(state.pv)
    if hasattr(state, "fv"):
        upd["fv"] = False    # prime_state refills the cache
    return state._replace(**upd)
