"""Shared layers: the shifted softplus, the activations by name and the
Gaussian basis (port of ``mdgrad_tpu/nn/layers.py``).  The Gaussian basis
is the SchNet edge featurizer, the pair MLPs' featurizer and the soft
histogram of the RDF.  ``pad_rows`` and ``segment_sum`` are the padded
edge lists' gather row and sum (the JAX package's ``segment_sum``)."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device


class _NarrowSoftplus(torch.autograd.Function):
    """``jax.nn.softplus`` (``jnp.logaddexp(x, 0)``) in a dtype narrower
    than f32, rounded after each op as the JAX package rounds it:
    max(x, 0) + log1p(exp(-|x|)), and its ``custom_jvp``, the cotangent
    times exp(x - softplus(x)), itself differentiable the same way.
    ``F.softplus`` rounds once and differs in ~15% of bf16 results;
    autograd through the formula differs from JAX's rule likewise."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x - _NarrowSoftplus.apply(x))


def pad_rows(x, fill=0.0):
    """``x`` with one more row of ``fill``, which padded indices (== N)
    gather."""
    return torch.cat([x, torch.full_like(x[:1], fill)])


def segment_sum(values, index, n):
    """Sum of the rows of ``values`` into ``n`` segments by ``index``;
    rows with index ``n`` (padding) are dropped."""
    out = values.new_zeros((n + 1,) + values.shape[1:])
    return out.index_add(0, index, values)[:-1]


def shifted_softplus(x):
    """softplus(x) - log(2); in bf16 as the JAX package rounds it
    (:class:`_NarrowSoftplus`), log(2) included: JAX subtracts a weakly
    typed scalar, so log(2) rounded to bf16.  A Python float would be
    rounded so on the CPU but kept in f32 on the card, 0.0017 apart in
    every output; a 0-dim bf16 tensor is the same value on both."""
    if x.element_size() < 4:
        return _NarrowSoftplus.apply(x) - torch.tensor(math.log(2.0),
                                                        dtype=x.dtype)
    return F.softplus(x) - math.log(2.0)


def _tanhshrink(x):
    return x - torch.tanh(x)


# the JAX package's ACTIVATIONS by name, with jax.nn's constants: SELU's
# alpha 1.6732632423543772 and scale 1.0507009873554805 (torch's are the
# same), ELU's and CELU's alpha 1, LeakyReLU's slope 0.01
ACTIVATIONS = {
    "ReLU": F.relu,
    "ELU": F.elu,
    "Tanh": torch.tanh,
    "LeakyReLU": F.leaky_relu,
    "ReLU6": F.relu6,
    "SELU": F.selu,
    "CELU": F.celu,
    "Tanhshrink": _tanhshrink,
    "shifted_softplus": shifted_softplus,
    "relu": F.relu,
}


def gaussian_smearing(distances, offsets, widths, centered=False):
    """Expand distances (..., 1) on a Gaussian basis (G,) -> (..., G)."""
    if not centered:
        coeff = -0.5 / widths ** 2
        diff = distances - offsets
    else:
        coeff = -0.5 / offsets ** 2
        diff = distances
    return torch.exp(coeff * diff ** 2)


class GaussianSmearing:
    """Fixed Gaussian basis: ``n_gaussians`` centres evenly from ``start``
    to ``stop``, each as wide as the spacing unless ``width`` is given;
    float32, like the JAX package's."""

    def __init__(self, start, stop, n_gaussians, width=None, centered=False,
                 device="cuda"):
        device = resolve_device(device)
        offsets = np.linspace(start, stop, n_gaussians)
        if width is None:
            widths = np.full(n_gaussians, offsets[1] - offsets[0])
        else:
            widths = np.full(n_gaussians, width)
        self.offsets = torch.tensor(offsets, dtype=torch.float32,
                                    device=device)
        self.widths = torch.tensor(widths, dtype=torch.float32,
                                   device=device)
        self.centered = centered

    def __call__(self, distances):
        return gaussian_smearing(distances, self.offsets, self.widths,
                                 centered=self.centered)
