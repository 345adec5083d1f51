"""Epoch-chunked MD driver (port of ``mdgrad_tpu/md/simulation.py``,
forward only).

``simulate(steps, dt, frequency)`` runs ``steps // frequency`` epochs of
``frequency - 1`` steps each, as the JAX package does: each epoch wraps
positions, primes the force cache, then per step wraps, refreshes the
neighbor state and steps; it logs the last frame and restarts from it,
wrapped.  The epoch is a Python loop over launches (the JAX package
compiles it into one ``lax.scan``).  Neighbor overflow and drift flags
are ORed on the device over every refresh of an epoch and read once at
its end, so the loop never waits for the device mid-epoch.
"""

import warnings

import numpy as np
import torch

from .. import topology, units


def _wrap_shift(q, cell):
    """Lattice shift taking ``q`` into the primary cell; a 1-D ``cell``
    (diagonal lengths) goes elementwise."""
    if cell.dim() == 1:
        return -torch.floor(q / cell) * cell
    frac = torch.matmul(q, torch.linalg.inv(cell))
    return -torch.matmul(torch.floor(frac), cell)


def wrap_state(state, cell):
    return state._replace(q=state.q + _wrap_shift(state.q, cell))


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

    def __init__(self, system, integrator, wrap=True):
        self.system = system
        self.integrator = integrator
        self.wrap = wrap
        self.keys = integrator.state_keys
        self.log = {k: [] for k in self.keys}
        self.state = None
        self.aux = None
        self.overflowed = False
        self.drifted = False
        cell = np.asarray(system.get_cell(), dtype=np.float64)
        if topology._is_diagonal(cell):
            cell = np.diag(cell)
        self.cell = torch.tensor(cell, dtype=integrator.dtype,
                                    device=integrator.device)

    def initial_state(self):
        state = self.integrator.initial_state(self.wrap)
        return state, self.integrator.aux_init(state.q)

    def epoch(self, state, aux, ctrl, dt, frequency):
        """One epoch of ``frequency - 1`` steps.

        Returns ``(traj, aux, overflow, drift)``: ``traj`` stacks the
        ``frequency`` frames (frame 0 is the primed entry state) field by
        field, and the two flags are device bools ORed over every neighbor
        refresh of the epoch (None when the interaction has none).
        """
        integ = self.integrator
        freq = integ.topology_update_freq
        if self.wrap:
            state = wrap_state(state, self.cell)
        state, aux = integ.prime_state(state, aux)
        overflow = topology.aux_flag(aux, "overflow")
        drift = topology.aux_flag(aux, "drift")
        frames = [state]
        for i in range(max(int(frequency) - 1, 1)):
            # the entry refresh above is step 0's when the table is not
            # rebuilt every step
            if freq == 1 or (i > 0 and i % freq == 0):
                if self.wrap:
                    state = wrap_state(state, self.cell)
                aux = integ.aux_update(state.q, aux)
                overflow = _or(overflow, topology.aux_flag(aux, "overflow"))
                drift = _or(drift, topology.aux_flag(aux, "drift"))
            state = integ.step(state, aux, ctrl, dt)
            frames.append(state)
        traj = state._replace(**{
            k: torch.stack([getattr(s, k) for s in frames])
            for k in state._fields if torch.is_tensor(getattr(state, k))})
        return traj, aux, overflow, drift

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
        return wrap_state(self.state, self.cell) if self.wrap else self.state

    def _check_flags(self, overflow, drift):
        if overflow is not None and bool(overflow):
            if not self.overflowed:
                warnings.warn(
                    "neighbor capacity overflow during Simulation.simulate: "
                    "neighbors were dropped and forces are incomplete -- "
                    "raise k_max/capacity_slack on the interaction",
                    stacklevel=3)
            self.overflowed = True
        if drift is not None and bool(drift):
            if not self.drifted:
                warnings.warn(
                    "positions drifted outside single-image minimum-image "
                    "validity during Simulation.simulate: distances may be "
                    "wrong -- run with wrap=True", stacklevel=3)
            self.drifted = True

    def simulate(self, steps=1, dt=1.0 * units.fs, frequency=1, ctrl=None):
        """Run ``steps // frequency`` epochs; returns the final epoch's
        trajectory (fields stacked over ``frequency`` frames)."""
        if self.state is None:
            self.state, self.aux = self.initial_state()
        else:
            self.state = self.get_check_point()
        ctrl = self.integrator.default_ctrl() if ctrl is None else ctrl
        traj = None
        for _ in range(max(int(steps // frequency), 1)):
            traj, self.aux, overflow, drift = self.epoch(
                self.state, self.aux, ctrl, dt, frequency)
            self._check_flags(overflow, drift)
            self.state = traj._replace(**{
                k: getattr(traj, k)[-1] for k in traj._fields
                if torch.is_tensor(getattr(traj, k))})
            self.update_log(traj)
            self.update_states()
            self.state = self.get_check_point()
        return traj

