"""Neural-network force fields of the port: SchNet, the pair MLPs, the
models of ``models``, ``glue``, ``autopology`` and
``schnet_autopology``, ``tensorgrad`` and the converters of the JAX
weights (``convert``)."""

from .pair_mlp import MLP, MLP2d, PairMLP, TPairMLP
from .schnet import SchNet

__all__ = ["MLP", "MLP2d", "PairMLP", "SchNet", "TPairMLP"]
