"""mdgrad_tpu_torch: the PyTorch/CUDA port of mdgrad_tpu.

It imports torch, numpy and the standard library only -- never JAX, flax,
optax or the ``mdgrad_tpu`` package -- and keeps the JAX package's module
names so that each counterpart is easy to find.  Its entry points take a
``device`` that defaults to ``"cuda"`` and raise when no card is present;
tests pass ``device="cpu"``.  Hand-written CUDA kernels live in ``csrc/``
and are built at their first launch (``ops/_build.py``).
"""

from . import observables, ops, potentials, thermo, topology, units
from .interface import (AnglePotentials, BondPotentials, Electrostatics,
                        EwaldElectrostatics, GNNPotentials, PairPotentials,
                        Stack, TPairPotentials, WithDynamicCell)
from .md import (Langevin, MTSNoseHooverChain, NPTBerendsenNHC, NPTMTKNHC,
                 NVE, NoseHooverChain, Simulation)
from .nn import MLP, MLP2d, PairMLP, SchNet, TPairMLP
from .system import System

__all__ = ["AnglePotentials", "BondPotentials", "Electrostatics",
           "EwaldElectrostatics", "GNNPotentials", "Langevin", "MLP",
           "MLP2d", "MTSNoseHooverChain", "NPTBerendsenNHC", "NPTMTKNHC",
           "NVE", "NoseHooverChain", "PairMLP", "PairPotentials", "SchNet",
           "Simulation", "Stack", "System", "TPairMLP", "TPairPotentials",
           "WithDynamicCell", "observables", "ops", "potentials", "thermo",
           "topology", "units"]
