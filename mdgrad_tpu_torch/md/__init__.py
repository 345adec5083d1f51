"""Molecular dynamics of the port: integrators, the simulation loop, the
fixed-grid ODE solvers, quantum isomerization, thermodynamic
integration (``ti``) and the xyz and thermo utilities (``utils``)."""

from .integrators import (Langevin, MTSNoseHooverChain, NoseHooverChain,
                          NPTBerendsenNHC, NPTMTKNHC, NPTMTKStateF,
                          NPTStateF, NVE, NVEState, NVEStateF, NVTState,
                          NVTStateF, rethermalize, rk4_step)
from .isomerization import Isomerization, PsiState
from .simulation import Simulation
from .tinydiffeq import odeint

__all__ = ["Isomerization", "Langevin", "MTSNoseHooverChain",
           "NPTBerendsenNHC", "NPTMTKNHC", "NPTMTKStateF", "NPTStateF", "NVE",
           "NVEState", "NVEStateF", "NoseHooverChain", "NVTState",
           "NVTStateF", "PsiState", "Simulation", "odeint", "rethermalize",
           "rk4_step"]
