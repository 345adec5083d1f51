"""Quantum isomerization: Schroedinger dynamics under a trainable field.

Port of ``mdgrad_tpu/md/isomerization.py``.  The wavefunction is one
stacked real/imaginary vector; the control is a piecewise-constant field
E(t) on a uniform grid, the ``nn.Parameter`` ``e_field`` (the JAX
``{"e_field": (M,)}``), switched off from ``max_e_t`` on; the effective
Hamiltonian is H - mu E(t), and d/dt (psi_R, psi_I) = (H_eff psi_I,
-H_eff psi_R).  A step is one RK4 "3/8 rule" step.

The field's index is the closed-form nearest sample on the uniform grid,
computed on the host in the module's dtype exactly as the JAX package
computes it in its own (float32 unless x64 is on): ``t`` is a 0-d CPU
tensor (:meth:`Isomerization.time`), so the index and the on/off flag
land on the same sample as JAX's at every stage time, and reading them
never waits for the card.  The products are plain ``torch`` matmuls, as
the JAX package runs them as plain ``jnp`` products.
"""

import typing

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from .tinydiffeq import rk4_step


class PsiState(typing.NamedTuple):
    psi: torch.Tensor  # (2 D,) stacked [real, imag]


class Isomerization(nn.Module):
    """The equations of motion of a wavefunction under ``ham`` (D, D) and
    the dipole ``dipole`` (D, D) in the field ``e_field_init`` (M,) on the
    uniform grid ``e_field_times`` (M,), zero from ``max_e_t`` on.

    ``device`` defaults to "cuda"; ``dtype`` is the operators', the
    field's and the time arithmetic's (float32 as the JAX package's
    default, float64 for parity checks).
    """

    def __init__(self, ham, dipole, e_field_times, e_field_init, max_e_t,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = {"dtype": dtype, "device": device}
        self.register_buffer("ham", torch.as_tensor(np.asarray(ham), **kw),
                             persistent=False)
        self.register_buffer("dipole",
                             torch.as_tensor(np.asarray(dipole), **kw),
                             persistent=False)
        self.dim = self.ham.shape[0]
        self.e_field = nn.Parameter(
            torch.as_tensor(np.asarray(e_field_init), **kw))
        # the grid's origin and step on the host, rounded to ``dtype``
        # before the subtraction, as jnp.asarray rounds the grid
        t = torch.as_tensor(np.asarray(e_field_times), dtype=dtype)
        self.t0, self.dt_field = t[0], t[1] - t[0]
        self.n_field = t.shape[0]
        self.max_e_t = max_e_t
        self.dtype = dtype

    def time(self, i, dt):
        """Step ``i``'s time ``i * dt`` as the JAX epoch computes it: the
        step index converted to the module's dtype, times ``dt`` rounded
        to it (a 0-d CPU tensor)."""
        return torch.tensor(i, dtype=self.dtype) * dt

    def field_index(self, t):
        """(nearest grid index, field on) at the times ``t`` (a CPU tensor
        of the module's dtype): round half to even, clipped to the grid;
        on while ``t < max_e_t``."""
        idx = torch.clamp(torch.round((t - self.t0) / self.dt_field), 0,
                          self.n_field - 1).to(torch.int64)
        return idx, t < self.max_e_t

    def field_at(self, t):
        """E(t), a 0-d tensor on the field's device, or None while the
        field is off."""
        idx, on = self.field_index(t)
        return self.e_field[int(idx)] if bool(on) else None

    def initial_state(self):
        psi = torch.zeros(2 * self.dim, dtype=self.ham.dtype,
                          device=self.ham.device)
        psi[0] = 1.0
        return PsiState(psi=psi)

    def derivs(self, state, t):
        psi_r, psi_i = state.psi[:self.dim], state.psi[self.dim:]
        e = self.field_at(t)
        h_eff = self.ham if e is None else self.ham - self.dipole * e
        return PsiState(psi=torch.cat([h_eff @ psi_i, -(h_eff @ psi_r)]))

    def step(self, state, t, dt):
        """One RK4 step of ``dt`` from time ``t`` (a 0-d CPU tensor,
        :meth:`time`)."""
        return rk4_step(self.derivs, state, t, dt)


def quantum_yield(psi_traj, op, dim):
    """<psi| op |psi> per frame of the stacked real/imaginary ``psi_traj``
    for a symmetric ``op``."""
    psi_r, psi_i = psi_traj[..., :dim], psi_traj[..., dim:]
    return ((psi_r @ op) * psi_r).sum(-1) + ((psi_i @ op) * psi_i).sum(-1)
