"""Molecular dynamics of the port: integrators and the simulation loop."""

from .integrators import (NoseHooverChain, NVE, NVEStateF, NVTStateF,
                          rethermalize)
from .simulation import Simulation

__all__ = ["NVE", "NVEStateF", "NoseHooverChain", "NVTStateF", "Simulation",
           "rethermalize"]
