"""Molecular dynamics of the port: integrators and the simulation loop."""

from .integrators import NoseHooverChain, NVTStateF
from .simulation import Simulation

__all__ = ["NoseHooverChain", "NVTStateF", "Simulation"]
