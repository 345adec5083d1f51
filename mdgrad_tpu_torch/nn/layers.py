"""Shared layers: the shifted softplus and the Gaussian basis (port of
``mdgrad_tpu/nn/layers.py``).  The Gaussian basis is the SchNet edge
featurizer and the soft histogram of the RDF."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device


def shifted_softplus(x):
    """softplus(x) - log(2)."""
    return F.softplus(x) - math.log(2.0)


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
