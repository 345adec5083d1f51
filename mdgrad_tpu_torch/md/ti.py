"""Thermodynamic integration: lambda-ramped GNN aggregation weights.

Port of ``mdgrad_tpu/md/ti.py``: a ``GraphConvIntegration`` force field
whose per-atom ``aggr_wgt`` ramps linearly from ``init_aggr`` to
``final_aggr`` over the run (e.g. switching one atom's interactions off),
integrated with BAOAB Langevin dynamics, with a thermodynamic log, an
optional trajectory dump, and dU/dlambda at the end of every ramp segment
-- the integrand, whose trapezoidal integral is the free-energy
difference.

Each segment is ``nbr_list_update_freq`` steps at one lambda, with the
neighbor structure refreshed before every step and two force
evaluations a step (no force cache), as the JAX package's scan.  Two
deviations, both forced by the port's tools:

* the step's noise comes from ``noise_fn(index, shape)``, by default the
  seeded generator of ``md/integrators.py``'s ``Langevin``, not JAX's
  threefry draws (a test passes those in);
* dU/dlambda is the reverse-mode gradient of U in ``aggr_wgt`` dotted
  with ``final_aggr - init_aggr``, the number JAX's ``jax.jvp`` gives:
  the gather kernels (K1, K2a, K2b) have no forward-mode rule.
"""

import math

import numpy as np
import torch

from ..interface import GNNPotentials
from .integrators import Langevin
from .utils import NeuralMDLogger, write_xyz


class AggrGNNInteraction(GNNPotentials):
    """``GNNPotentials`` (modes 'table' and 'sparse') whose energy takes
    the per-atom ``aggr_wgt``."""

    def __init__(self, system, gnn, cutoff, capacity=None, nbr_mode="table",
                 device="cuda"):
        if nbr_mode not in ("table", "sparse"):
            raise ValueError(f"nbr_mode {nbr_mode!r} not in ('table', "
                             "'sparse')")
        super().__init__(system, gnn, cutoff, capacity=capacity,
                         nbr_mode=nbr_mode, device=device)


class TI:
    """Run Langevin MD while ramping ``aggr_wgt``; collect dU/dlambda.

    Defaults follow the JAX package's (``T_init`` Kelvin, ``friction``,
    ``dt`` = 0.5 fs, ``cutoff``, ``steps``, ``nbr_list_update_freq``).
    The model's parameters live in ``gnn``; ``dtype`` is the dynamics'
    (a float64 run needs a float64 ``gnn``).
    """

    def __init__(self, system, gnn, init_aggr, final_aggr, T_init=120.0,
                 friction=0.002, dt=0.5 * 0.0982269, cutoff=5.0, steps=3000,
                 nbr_list_update_freq=20, thermo_filename=None,
                 traj_filename=None, seed=0, noise_fn=None, device="cuda",
                 dtype=torch.float32):
        self.system = system
        self.interaction = AggrGNNInteraction(system, gnn, cutoff,
                                              device=device).to(dtype)
        self.integrator = Langevin(self.interaction, system, T=T_init,
                                   friction=friction, adjoint=False,
                                   seed=seed, noise_fn=noise_fn,
                                   device=device, dtype=dtype)
        kw = {"dtype": dtype, "device": self.integrator.device}
        self.init_aggr = torch.as_tensor(np.asarray(init_aggr), **kw)
        self.final_aggr = torch.as_tensor(np.asarray(final_aggr), **kw)
        self.steps = steps
        self.update_freq = nbr_list_update_freq
        self.dt = dt
        self.thermo_filename = thermo_filename
        self.traj_filename = traj_filename

    def force(self, q, aux, aggr):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(
                self.interaction.energy(x, aux, aggr_wgt=aggr), x)
        return -g

    def step(self, v, q, aux, ctrl, i, aggr):
        """One BAOAB step at ``aggr``; the noise of global step
        ``noise_step0 + i``."""
        integ, dt = self.integrator, self.dt
        m = integ.masses
        index = (ctrl["noise_step0"] + i) % (1 << 32)
        v = v + 0.5 * dt * self.force(q, aux, aggr) / m
        q = q + 0.5 * dt * v
        c1 = math.exp(-integ.friction * dt)
        c2 = torch.sqrt(ctrl["kT"] * (1 - c1 ** 2) / m)
        v = c1 * v + c2 * integ.noise_fn(index, tuple(v.shape)).to(v)
        q = q + 0.5 * dt * v
        v = v + 0.5 * dt * self.force(q, aux, aggr) / m
        return v, q

    def du_dlambda(self, q, aux, aggr, direction):
        """dU/dlambda along ``direction`` at ``q`` (a 0-d tensor)."""
        with torch.enable_grad():
            a = aggr.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(
                self.interaction.energy(q.detach(), aux, aggr_wgt=a), a)
        return (g * direction).sum()

    def run(self, log=print):
        """The ramp: returns ``{'du_dlambda': (epochs,), 'delta_f',
        'thermo': the logger's rows, 'final_state'}``; ``log`` takes a
        line at the end of each segment."""
        integ = self.integrator
        epochs = int(self.steps // self.update_freq)
        direction = self.final_aggr - self.init_aggr
        dlam = direction / max(epochs, 1)
        aggr = self.init_aggr

        state = integ.initial_state()
        v, q = state.v, state.q
        aux = integ.aux_init(q)
        ctrl = integ.default_ctrl()
        logger = NeuralMDLogger(self.system, logfile=self.thermo_filename)
        du_dlam, frames = [], []
        with torch.no_grad():
            for ep in range(epochs):
                for i in range(self.update_freq):
                    aux = self.interaction.aux_update(q, aux)
                    v, q = self.step(v, q, aux, ctrl, i, aggr)
                ctrl = integ.advance_ctrl(ctrl, self.update_freq)
                # the energy and dU/dlambda at the segment's last state,
                # on the table its last step used, as the JAX package
                u = float(self.interaction.energy(q, aux, aggr_wgt=aggr))
                logger((ep + 1) * self.update_freq * self.dt / 0.0982269,
                       v, u)
                du_dlam.append(float(self.du_dlambda(q, aux, aggr,
                                                     direction)))
                frames.append(q.cpu().numpy())
                log(f"TI epoch {ep}: U {u:.6f}, dU/dlambda "
                    f"{du_dlam[-1]:.6f}")
                aggr = aggr + dlam
        if self.traj_filename:
            write_xyz(self.traj_filename, np.stack(frames),
                      numbers=self.system.get_atomic_numbers())
        delta_f = float(np.trapezoid(du_dlam, dx=1.0 / max(epochs - 1, 1))) \
            if len(du_dlam) > 1 else float(du_dlam[0])
        return {"du_dlambda": np.asarray(du_dlam), "delta_f": delta_f,
                "thermo": logger.rows,
                "final_state": state._replace(v=v, q=q)}
