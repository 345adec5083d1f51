"""Bulk thermodynamic observables: temperature and pressure (port of
``mdgrad_tpu/thermo.py``).

The virial comes from an isotropic strain derivative of the potential
energy through the interaction contract's dynamic ``cell=`` override, so
``pressure`` works for any ``PairPotentials``, ``GNNPotentials`` (table
mode) or ``Stack`` of them, and is differentiable in the potential's
parameters, the positions and the velocities: it can sit at the end of a
trajectory as a loss term.
"""

import torch

from . import units


def kinetic_energy(velocities, masses):
    m = torch.as_tensor(masses, dtype=velocities.dtype,
                        device=velocities.device).reshape(-1, 1)
    return 0.5 * (m * velocities ** 2).sum()


def temperature(velocities, masses, dim=3):
    """Instantaneous kinetic temperature in energy units, 2 KE / N_dof;
    divide by ``units.kB`` for Kelvin."""
    n_dof = velocities.shape[-2] * dim
    return 2 * kinetic_energy(velocities, masses) / n_dof


def temperature_kelvin(velocities, masses, dim=3):
    return temperature(velocities, masses, dim) / units.kB


def pressure(interaction, xyz, aux, velocities, masses, cell, dim=3):
    """P = (2 KE + W) / (dim V), W = -dU/d(strain) = sum_i f_i . r_i.

    The strain scales positions and the diagonal cell together, U(eps) =
    U((1 + eps) q; (1 + eps) cell), and W = -dU/deps at 0, taken with
    ``torch.autograd.grad``.  While the caller records gradients the
    derivative keeps its graph (``create_graph=True``), so the pressure is
    differentiable in the interaction's parameters, ``xyz`` and
    ``velocities``; under ``torch.no_grad()`` it is a plain value.
    """
    create_graph = torch.is_grad_enabled()
    cell = torch.as_tensor(cell, dtype=xyz.dtype, device=xyz.device)
    cell_len = torch.diagonal(cell) if cell.dim() == 2 else cell
    volume = torch.abs(torch.prod(cell_len))
    with torch.enable_grad():
        eps = torch.zeros((), dtype=xyz.dtype, device=xyz.device,
                          requires_grad=True)
        u = interaction.energy((1.0 + eps) * xyz, aux,
                               cell=(1.0 + eps) * cell_len)
        (du,) = torch.autograd.grad(u, eps, create_graph=create_graph)
    ke = kinetic_energy(velocities, masses)
    return (2 * ke - du) / (dim * volume)
