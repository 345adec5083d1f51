"""Crystal lattices and chain geometries (port of ``cubic_lattice``,
``square_lattice_2d``, ``helix`` and ``straight_chain`` from
``mdgrad_tpu/lattice.py``).

Each but ``helix`` returns ``(positions (N, 3) float64, cell (3, 3)
float64)``; ``helix`` returns the positions alone.  The atom order is the
JAX package's, so that systems built from the same arguments agree bit
for bit.
"""

import numpy as np

_BASES = {
    "sc": np.array([[0.0, 0.0, 0.0]]),
    "bcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    "fcc": np.array([
        [0.0, 0.0, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5], [0.5, 0.5, 0.0],
    ]),
}
_BASES["diamond"] = np.concatenate(
    [_BASES["fcc"], _BASES["fcc"] + 0.25], axis=0
)


def cubic_lattice(kind, size, latticeconstant):
    """Replicate a conventional cubic unit cell ``size`` times per axis.

    kind: 'sc' | 'bcc' | 'fcc' (4 atoms/cell) | 'diamond' (8 atoms/cell).
    """
    if isinstance(size, int):
        size = (size, size, size)
    basis = _BASES[kind]
    cells = np.stack(np.meshgrid(
        np.arange(size[0]), np.arange(size[1]), np.arange(size[2]),
        indexing="ij"), axis=-1).reshape(-1, 3)
    frac = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3)
    positions = frac * latticeconstant
    cell = np.diag(np.asarray(size, dtype=np.float64) * latticeconstant)
    return positions, cell



def square_lattice_2d(rho, size):
    """2-D square lattice of size x size sites at number density ``rho``,
    in the z = 0 plane of a cubic box of side ``size * L``, ``L =
    sqrt(size^2 / rho) / size``."""
    L = np.sqrt(size ** 2 / rho) / size
    i, j = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    positions = np.stack(
        [j.ravel() * L, i.ravel() * L, np.zeros(size * size)], axis=-1)
    cell = np.diag([L * size] * 3)
    return positions, cell


def helix(n_spirals, n_atoms, a, dz):
    """(n_atoms, 3) helix of radius ``a`` turning through ``n_spirals``
    half turns, rising ``dz`` per atom: the polymer fold's target."""
    t = np.linspace(0, np.pi * n_spirals, n_atoms)
    z = np.arange(n_atoms) * dz
    return np.stack([np.cos(t) * a, np.sin(t) * a, z], axis=-1)


def straight_chain(n_atoms, bond_len, origin=(50.0, 50.0, 50.0),
                   box=100.0):
    """Straight chain along x from ``origin``, ``bond_len`` apart, in a
    cubic box of side ``box``: the polymer fold's start."""
    origin = np.asarray(origin, dtype=np.float64)
    positions = origin[None, :] + np.outer(
        np.arange(n_atoms), np.array([bond_len, 0.0, 0.0]))
    cell = np.diag([box] * 3)
    return positions, cell
