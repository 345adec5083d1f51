"""Physical units and constants in the (Angstrom, eV, amu) system.

Port of ``mdgrad_tpu/units.py``: the same ASE-compatible CODATA 2014
constants, kept as a copy so that this package never imports the JAX one.
The induced time unit is ``Angstrom * sqrt(amu / eV)`` ~ 10.18 fs.
"""

import math

_e = 1.6021766208e-19        # elementary charge, C
_amu = 1.66053904e-27        # atomic mass unit, kg
_k = 1.38064852e-23          # Boltzmann constant, J/K

Ang = Angstrom = 1.0
eV = 1.0
amu = 1.0

second = 1e10 * math.sqrt(_e / _amu)
fs = 1e-15 * second          # ~0.09822694788464063
ps = 1e-12 * second

kB = _k / _e                 # Boltzmann constant in eV/K (~8.6173303e-5)

m = 1e10                     # metre in Angstrom
C = 1.0 / _e                 # Coulomb in units of the elementary charge

# pressure: 1 atm in eV / Angstrom^3 (101325 Pa * 6.241509e-12 eV A^-3 /
# Pa), for the registry's ``pressure`` metadata (atm)
atm = 101325.0 * 6.241509074460763e-12

# energy conversions of the supervised datasets (kcal/mol <-> atomic
# units), as the JAX package's
HARTREE_TO_EV = 27.211386024367243
EV_TO_KCAL_MOL = 23.060548012069496
AU_TO_KCAL = {"energy": 627.509, "_grad": 1.0 / 0.529177}
KCAL_TO_AU = {"energy": 1.0 / 627.509, "_grad": 0.529177}
BOHR_RADIUS = 0.529177
