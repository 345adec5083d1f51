"""Lattice constants from densities (port of the part of
``mdgrad_tpu/data/registry.py`` that the sampling slice needs).

Target RDF files stay under ``mdgrad_tpu/data/targets/`` and are read in
place by later slices; nothing here reads them.
"""


def get_unit_len(rho, mass, N_unitcell):
    """Lattice constant (Angstrom) of a cubic cell holding ``N_unitcell``
    molecules of molar mass ``mass`` (g/mol) at mass density ``rho``
    (g/cm^3)."""
    Na = 6.02214086e23
    N = (rho * 1e6 / mass) * Na          # molecules per m^3
    n_dens = N / 1e30                    # per A^3
    return (N_unitcell / n_dens) ** (1 / 3)
