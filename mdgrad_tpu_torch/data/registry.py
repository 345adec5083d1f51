"""Lattice constants and the water RDF targets (port of the part of
``mdgrad_tpu/data/registry.py`` that the water SchNet fit reads).

The target files are read in place from the JAX package's vendored copy,
``mdgrad_tpu/data/targets/``, by file path: they are never copied, and
nothing of that package is imported.
"""

import pathlib

import numpy as np

from ..observables import generate_vol_bins

DATA_DIR = (pathlib.Path(__file__).resolve().parents[2] / "mdgrad_tpu"
            / "data" / "targets")


def get_unit_len(rho, mass, N_unitcell):
    """Lattice constant (Angstrom) of a cubic cell holding ``N_unitcell``
    molecules of molar mass ``mass`` (g/mol) at mass density ``rho``
    (g/cm^3)."""
    Na = 6.02214086e23
    N = (rho * 1e6 / mass) * Na          # molecules per m^3
    n_dens = N / 1e30                    # per A^3
    return (N_unitcell / n_dens) ** (1 / 3)


def get_exp_rdf(data, nbins, r_range, dim=3):
    """Interpolate a target RDF onto the fitting grid and re-normalise it
    by shell volumes.  ``data``: (2, M) or (M, 2) [r, g(r)].  Returns
    (r_axis, g_obs), float64 numpy."""
    data = np.asarray(data)
    if data.shape[0] == 2:
        r_raw, g_raw = data[0], data[1]
    else:
        r_raw, g_raw = data[:, 0], data[:, 1]
    start, end = r_range
    xnew = np.linspace(start, end, nbins)
    g = np.interp(xnew, r_raw, g_raw, left=0.0)
    V, vol_bins, _ = generate_vol_bins(start, end, nbins, dim=dim)
    g_obs = g * (V / (g * vol_bins).sum())
    return xnew, g_obs


def _water(sub, fn, rho, T, **kw):
    e = {"fn": str(DATA_DIR / sub / fn), "rho": rho, "T": T,
         "start": 1.8, "end": 7.5, "element": "O", "mass": 18.01528,
         "N_unitcell": 8, "cell": "diamond"}
    e.update(kw)
    return e


# the water O-O entries of the JAX package's exp_rdf_data_dict
exp_rdf_data_dict = {
    "H20_0.997_298K": _water("water_exp", "water_exp_pccp.csv",
                             0.997, 298.0, pressure=1.0),
    "H20_0.978_342K": _water("water_exp",
                             "water_exp_skinner_342K_0.978.csv",
                             0.978, 342.0, pressure=1.0),
    "H20_0.921_423K_soper": _water("water_exp",
                                   "water_exp_Soper_423K_0.9213.csv",
                                   0.9213, 423.0, pressure=10.0),
    "H20_0.999_423K_soper": _water("water_exp",
                                   "water_exp_Soper_423K_0.999.csv",
                                   0.999, 423.0, pressure=190.0),
    "H20_298K_redd": _water("water_exp", "water_exp_298K_redd.csv",
                            0.99749, 298.0, pressure=1.0),
    "H20_308K_redd": _water("water_exp", "water_exp_308K_redd.csv",
                            0.99448, 308.0, pressure=1.0),
    "H20_338K_redd": _water("water_exp", "water_exp_338K_redd.csv",
                            0.98103, 338.0, pressure=1.0),
    "H20_368K_redd": _water("water_exp", "water_exp_368K_redd.csv",
                            0.96241, 368.0, pressure=1.0),
    "H20_288K_wu": _water("water_sim", "H2O_288K_wu.csv", 0.999, 288.0),
    "H20_338K_wu": _water("water_sim", "H2O_338K_wu.csv", 0.98103, 338.0),
    "H20_388K_wu": _water("water_sim", "H2O_388K_wu.csv", 0.94508, 388.0),
    "H20_288K_spce": _water("water_sim", "H2O_288K_spce.csv", 0.999, 288.0),
    "H20_338K_spce": _water("water_sim", "H2O_338K_spce.csv",
                            0.98103, 338.0),
    "H20_388K_spce": _water("water_sim", "H2O_388K_spce.csv",
                            0.94508, 388.0),
}
