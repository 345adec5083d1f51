"""Gradient, Jacobian and Hessian utilities for force-field analysis.

Port of ``mdgrad_tpu/nn/tensorgrad.py``.  Every derivative is reverse
mode (``torch.autograd.grad`` and ``torch.autograd.functional``'s
``jacobian`` / ``hessian``, reverse over reverse): the gather kernels'
``autograd.Function``s have no forward-mode rule, so ``torch.func.jacfwd``
fails wherever they are on the path.
"""

import torch
from torch.autograd import functional


def compute_grad(fn, inputs):
    """d fn / d inputs for a scalar-valued ``fn``."""
    with torch.enable_grad():
        x = inputs.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x), x)
    return g


def compute_jacobian(fn, inputs):
    """Jacobian of ``fn`` at ``inputs``, shape out.shape + in.shape."""
    return functional.jacobian(fn, inputs.detach())


def compute_hess(fn, inputs):
    """Hessian of a scalar ``fn``, shape in.shape + in.shape."""
    return functional.hessian(fn, inputs.detach())


def get_schnet_hessians(gnn, z, xyz, idx, mask, **kw):
    """Hessian of the SchNet energy in the positions, (N, 3, N, 3);
    ``kw`` as ``SchNet.energy``'s edge arguments."""
    return compute_hess(lambda x: gnn.energy(z, x, idx, mask, **kw), xyz)


def vibrational_frequencies(hessian, masses):
    """Harmonic frequencies from the mass-weighted Hessian (sign of the
    eigenvalue times the square root of its magnitude)."""
    n = hessian.shape[0]
    h = hessian.reshape(3 * n, 3 * n)
    m = torch.as_tensor(masses, dtype=h.dtype,
                        device=h.device).repeat_interleave(3)
    evals = torch.linalg.eigvalsh(h / torch.sqrt(m[:, None] * m[None, :]))
    return torch.sign(evals) * torch.sqrt(evals.abs())
