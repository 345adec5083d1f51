"""Pair potentials as ``nn.Module``s (port of the part of
``mdgrad_tpu/potentials.py`` that the sampling slice runs).

A potential maps distances ``r`` of any shape to per-pair energies; its
learnable constants are ``nn.Parameter``s where the JAX package keeps them
in the params pytree.
"""

import torch
from torch import nn


class PairPotentialBase(nn.Module):
    """Per-pair energy ``forward(r) -> u`` broadcasting over ``r``."""

    def forward(self, r):
        raise NotImplementedError


class ExcludedVolume(PairPotentialBase):
    """Purely repulsive prior 4 eps (sigma / r)^power; the short-range
    prior under SchNet in the water RDF fit."""

    def __init__(self, sigma=1.0, epsilon=1.0, power=12):
        super().__init__()
        self.sigma = nn.Parameter(torch.tensor(sigma, dtype=torch.float32))
        self.epsilon = nn.Parameter(torch.tensor(epsilon,
                                                 dtype=torch.float32))
        self.power = power

    def forward(self, r):
        return 4 * self.epsilon * (self.sigma / r) ** self.power
