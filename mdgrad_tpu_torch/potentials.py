"""Pair potentials as ``nn.Module``s (port of the part of
``mdgrad_tpu/potentials.py`` that the water and LJ slices run).

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


class LJFamily(PairPotentialBase):
    """Generalised Mie / LJ 4 eps ((sigma / r)^rep_pow - (sigma /
    r)^attr_pow) with fixed integer powers."""

    def __init__(self, sigma=1.0, epsilon=1.0, attr_pow=6, rep_pow=12):
        super().__init__()
        self.sigma = nn.Parameter(torch.tensor(sigma, dtype=torch.float32))
        self.epsilon = nn.Parameter(torch.tensor(epsilon,
                                                 dtype=torch.float32))
        self.attr_pow, self.rep_pow = attr_pow, rep_pow

    def forward(self, r):
        sr = self.sigma / r
        return 4 * self.epsilon * (sr ** self.rep_pow - sr ** self.attr_pow)


class LennardJones(LJFamily):
    """4 eps ((sigma / r)^12 - (sigma / r)^6)."""

    def __init__(self, sigma=1.0, epsilon=1.0):
        super().__init__(sigma, epsilon, attr_pow=6, rep_pow=12)
