"""Host-side simulation state (port of ``mdgrad_tpu/system.py``).

:class:`System` keeps positions, velocities, masses, atomic numbers and a
3x3 cell as float64 numpy arrays on the host, exactly as the JAX package
does; integrators copy them to the device.  Maxwell-Boltzmann velocities
come from a numpy ``Generator``, so the same seed gives the same
velocities in both packages, bit for bit.
"""

import numpy as np

from . import lattice, units

SYMBOL_TO_Z = {"H": 1, "He": 2, "C": 6, "N": 7, "O": 8, "Ar": 18,
               "Si": 14, "Ge": 32, "Cu": 29}
Z_TO_MASS = {1: 1.008, 2: 4.002602, 6: 12.011, 7: 14.007, 8: 15.999,
             11: 22.98977, 14: 28.085, 17: 35.453, 18: 39.948,
             29: 63.546, 32: 72.63, 55: 132.90545}


def wrap_positions(positions, cell):
    """Wrap positions into the periodic cell (general triclinic)."""
    positions = np.asarray(positions, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64)
    frac = positions @ np.linalg.inv(cell)
    return (frac % 1.0) @ cell


def maxwell_boltzmann_velocities(masses, temperature_ev, rng=None):
    """v_i ~ Normal(0, sqrt(T / m_i)) per component, T in energy units."""
    rng = np.random.default_rng() if rng is None else rng
    masses = np.asarray(masses, dtype=np.float64)
    sigma = np.sqrt(temperature_ev / masses)[:, None]
    return rng.standard_normal((len(masses), 3)) * sigma


class System:
    """Positions, velocities, masses, atomic numbers and cell on the host."""

    def __init__(self, positions, cell, numbers=None, masses=None,
                 velocities=None, dim=3, pbc=True):
        self.positions = np.array(positions, dtype=np.float64).reshape(-1, 3)
        n = len(self.positions)
        cell = np.asarray(cell, dtype=np.float64)
        self.cell = np.diag(cell) if cell.ndim == 1 else cell
        if numbers is None:
            numbers = np.ones(n, dtype=np.int32)
        self.numbers = np.asarray(numbers, dtype=np.int32)
        if masses is None:
            masses = np.array([Z_TO_MASS.get(int(z), 1.0)
                               for z in self.numbers])
        self.masses = np.asarray(masses, dtype=np.float64)
        self.velocities = (np.zeros((n, 3)) if velocities is None
                           else np.array(velocities, dtype=np.float64))
        self.dim = dim
        self.pbc = pbc

    @classmethod
    def from_lattice(cls, kind, size, latticeconstant, symbol="H", **kw):
        positions, cell = lattice.cubic_lattice(kind, size, latticeconstant)
        z = SYMBOL_TO_Z.get(symbol, 1)
        return cls(positions, cell,
                   numbers=np.full(len(positions), z, dtype=np.int32), **kw)

    def get_number_of_atoms(self):
        return len(self.positions)

    def get_cell(self):
        return self.cell

    def get_volume(self):
        return float(abs(np.linalg.det(self.cell)))

    def get_masses(self):
        return self.masses

    def get_atomic_numbers(self):
        return self.numbers

    def get_positions(self, wrap=False):
        if wrap and self.pbc:
            return wrap_positions(self.positions, self.cell)
        return self.positions

    def set_positions(self, positions):
        self.positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)

    def get_velocities(self):
        return self.velocities

    def set_velocities(self, velocities):
        self.velocities = np.asarray(velocities, dtype=np.float64)

    def set_temperature(self, T_kelvin, rng=None):
        """Maxwell-Boltzmann velocities at ``T_kelvin``; 2-D systems get
        their third velocity column zeroed."""
        self.velocities = maxwell_boltzmann_velocities(
            self.masses, T_kelvin * units.kB, rng=rng)
        if self.dim < 3:
            self.velocities[:, self.dim:] = 0.0

    def temperature(self):
        """Instantaneous kinetic temperature in Kelvin."""
        ke = 0.5 * (self.masses[:, None] * self.velocities ** 2).sum()
        n_dof = self.get_number_of_atoms() * self.dim
        return 2.0 * ke / (n_dof * units.kB)


def check_system(obj):
    if not isinstance(obj, System):
        raise TypeError("input should be a mdgrad_tpu_torch.system.System")
