"""Epoch-chunked MD runner (port of ``mdgrad_tpu/md/simulation.py``).

:meth:`Simulation.epoch_fn` builds ``ode(state, aux, ctrl) -> (traj,
final_aux)``, one epoch of ``frequency - 1`` steps through
:func:`~mdgrad_tpu_torch.md.adjoint.make_odeint`: it wraps positions,
refreshes the neighbor state and primes the force cache at entry, then
per step wraps, refreshes and steps.  With grad enabled the epoch is
differentiable -- through the replay adjoint, or through plain autograd
when the integrator has ``adjoint=False`` -- and the entry force stays on
the graph.  ``simulate(steps, dt, frequency)`` runs ``steps // frequency``
such epochs under ``torch.no_grad()``, logs the last frame of each and
restarts from it, wrapped, as the JAX package does.  The epoch is a Python
loop over launches (the JAX package compiles it into one ``lax.scan``).
Neighbor overflow and drift flags are ORed on the device over every
refresh and read once per epoch (:meth:`Simulation.check_flags`), so the
loop never waits for the device mid-epoch.

A barostatted integrator (``NPTBerendsenNHC``, ``NPTMTKNHC``) carries its
cell in the state: its ``aux_update_state`` refreshes the topology
against ``state.cell``, and the wrap takes the state's own cell (the
integrator has ``cell_len0``).  ``integrator.adjoint == "reverse"`` runs
the reverse-time adjoint (the step at -dt reconstructs the states).  An
integrator with ``advance_ctrl`` (Langevin) moves its controls on by each
epoch's steps in :meth:`simulate`.

``method`` (default the integrator's ``default_method``) is passed to
every step: ``'verlet'``, ``'NH_verlet'`` and ``'langevin'`` prime the
force cache at entry; any other (``'rk4'``) only refreshes the neighbor
state there and leaves the cache alone, as the JAX package's
``can_prime``.
"""

import warnings

import numpy as np
import torch

from .. import topology, units
from .adjoint import make_odeint


def _wrap_shift(q, cell):
    """Lattice shift taking ``q`` into the primary cell; a 1-D ``cell``
    (diagonal lengths) goes elementwise."""
    if cell.dim() == 1:
        return -torch.floor(q / cell) * cell
    frac = torch.matmul(q, torch.linalg.inv(cell))
    return -torch.matmul(torch.floor(frac), cell)


def wrap_state(state, cell):
    """Periodic wrap of ``state.q``, gradient-safe: the lattice shift is
    computed from ``q.detach()``, so the Jacobian is the identity
    (``wrap_state_grad_safe`` in the JAX package)."""
    return state._replace(q=state.q + _wrap_shift(state.q.detach(), cell))


def _or(acc, flag):
    if flag is None:
        return acc
    return flag if acc is None else acc | flag


class Simulation:
    """Runs an integrator's epochs and keeps the host-side log.

    ``overflowed`` / ``drifted`` become True after an epoch whose neighbor
    tables overflowed (neighbors were dropped) or were built from drifted
    positions; each also warns once.
    """

    def __init__(self, system, integrator, wrap=True, method=None):
        self.system = system
        self.integrator = integrator
        self.wrap = wrap
        self.method = method or integrator.default_method
        self.keys = integrator.state_keys
        self.log = {k: [] for k in self.keys}
        self.state = None
        self.aux = None
        self.overflowed = False
        self.drifted = False
        self._flags = [None, None]      # (overflow, drift) device ORs
        cell = np.asarray(system.get_cell(), dtype=np.float64)
        if topology._is_diagonal(cell):
            cell = np.diag(cell)
        self.cell = torch.tensor(cell, dtype=integrator.dtype,
                                    device=integrator.device)

    def initial_state(self):
        state = self.integrator.initial_state(self.wrap)
        return state, self.integrator.aux_init(state.q)

    def _note_flags(self, aux):
        """OR ``aux``'s overflow and drift flags into this epoch's (on the
        device, no sync); returns ``aux``."""
        self._flags = [_or(acc, topology.aux_flag(aux, field))
                       for acc, field in zip(self._flags,
                                             ("overflow", "drift"))]
        return aux

    def epoch_fn(self, dt, frequency):
        """``ode(state, aux, ctrl) -> (traj, final_aux)``: one epoch of
        ``frequency - 1`` steps; ``traj`` stacks the ``frequency`` frames
        (frame 0 is the primed entry state) field by field.

        With grad enabled, gradients flow from ``traj`` to the potential's
        parameters that require grad, to ``state`` and to ``ctrl``: through
        the replay adjoint when ``integrator.adjoint`` is True, else
        through plain autograd; the entry force is primed on the graph.
        """
        integ = self.integrator
        method = self.method
        can_prime = method in ("verlet", "NH_verlet", "langevin")
        wrap = None
        if self.wrap:
            def wrap(state, aux=None):
                return wrap_state(state, self._wrap_cell(state))

        def step_fn(state, aux, ctrl, i, create_graph):
            return integ.step(state, aux, ctrl, dt, create_graph,
                              method=method, t=i * dt)

        def aux_update(state, aux):
            # a barostat rebuilds the topology against the state's cell
            if hasattr(integ, "aux_update_state"):
                return self._note_flags(integ.aux_update_state(state, aux))
            return self._note_flags(integ.aux_update(state.q.detach(), aux))

        reverse_step = None
        if integ.adjoint == "reverse":
            def reverse_step(state, aux, ctrl, i):
                return integ.step(state, aux, ctrl, -dt, False,
                                  method=method, t=i * dt)

        # the entry prime (or refresh) builds aux at the wrapped entry
        # state, so the step-0 table is that same build (skip_first_refresh)
        odeint = make_odeint(step_fn, aux_update,
                             max(int(frequency) - 1, 1),
                             update_freq=integ.topology_update_freq,
                             adjoint=bool(integ.adjoint),
                             skip_first_refresh=True, wrap_fn=wrap,
                             reverse_step_fn=reverse_step)

        def ode(state, aux, ctrl):
            if wrap is not None:
                state = wrap(state)
            if can_prime:
                state, aux = integ.prime_state(
                    state, aux, create_graph=torch.is_grad_enabled())
                self._note_flags(aux)
            else:
                aux = aux_update(state, aux)
            params = [p for p in integ.model.parameters() if p.requires_grad]
            return odeint(params, state, aux, ctrl)

        return ode

    def _wrap_cell(self, state):
        """The cell positions wrap into: the state's own (detached) for a
        barostat, else the system's."""
        if hasattr(self.integrator, "cell_len0"):
            return state.cell.detach()
        return self.cell

    def update_log(self, traj):
        for key, field in zip(self.keys, traj):
            self.log[key].append(field[-1])

    def update_states(self):
        self.system.set_positions(
            self.log["positions"][-1].cpu().double().numpy())
        self.system.set_velocities(
            self.log["velocities"][-1].cpu().double().numpy())

    def get_check_point(self):
        """Restart state: the last frame, wrapped if ``wrap``."""
        if not self.wrap:
            return self.state
        return wrap_state(self.state, self._wrap_cell(self.state))

    def check_flags(self):
        """Read (one host sync) and reset the flags ORed since the last
        call; sets ``overflowed`` / ``drifted`` and warns once each.
        Returns ``(overflow, drift)``, the bools of the epochs since the
        last call."""
        overflow, drift = (flag is not None and bool(flag)
                           for flag in self._flags)
        self._flags = [None, None]
        if overflow:
            if not self.overflowed:
                warnings.warn(
                    "neighbor capacity overflow in a simulated epoch: "
                    "neighbors were dropped and forces are incomplete -- "
                    "raise k_max/capacity_slack on the interaction",
                    stacklevel=3)
            self.overflowed = True
        if drift:
            if not self.drifted:
                warnings.warn(
                    "positions drifted outside single-image minimum-image "
                    "validity in a simulated epoch: distances may be "
                    "wrong -- run with wrap=True", stacklevel=3)
            self.drifted = True
        return overflow, drift

    def simulate(self, steps=1, dt=1.0 * units.fs, frequency=1, ctrl=None):
        """Run ``steps // frequency`` epochs; returns the final epoch's
        trajectory (fields stacked over ``frequency`` frames)."""
        if self.state is None:
            self.state, self.aux = self.initial_state()
        else:
            self.state = self.get_check_point()
        ctrl = self.integrator.default_ctrl() if ctrl is None else ctrl
        ode = self.epoch_fn(dt, frequency)
        traj = None
        with torch.no_grad():
            for _ in range(max(int(steps // frequency), 1)):
                traj, self.aux = ode(self.state, self.aux, ctrl)
                self.check_flags()
                if hasattr(self.integrator, "advance_ctrl"):
                    ctrl = self.integrator.advance_ctrl(
                        ctrl, max(int(frequency) - 1, 1))
                self.state = traj._replace(**{
                    k: getattr(traj, k)[-1] for k in traj._fields
                    if torch.is_tensor(getattr(traj, k))})
                self.update_log(traj)
                self.update_states()
                self.state = self.get_check_point()
        return traj

