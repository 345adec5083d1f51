"""Neural-network force fields of the port."""

from .pair_mlp import MLP, MLP2d, PairMLP, TPairMLP
from .schnet import SchNet

__all__ = ["MLP", "MLP2d", "PairMLP", "SchNet", "TPairMLP"]
