"""Lattice constants and the targets of the fitting workloads (port of
``mdgrad_tpu/data/registry.py``: ``exp_rdf_data_dict`` -- a-Si, water O-O
and argon -- the lazily scanned ``pair_data_dict`` of simulated pair
targets, and the water angle-distribution targets ``angle_data_dict`` with
their loader ``exp_angle_data``).

The target files are read in place from the JAX package's vendored copy,
``mdgrad_tpu/data/targets/``, by file path: they are never copied, and
nothing of that package is imported.
"""

import functools
import os
import pathlib
import re

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


def number_density_unit_len(rho, N_unitcell):
    """Lattice constant of a cubic cell holding ``N_unitcell`` particles
    at *number* density ``rho`` (LJ reduced units)."""
    return (N_unitcell / rho) ** (1 / 3)


def load_target(fn):
    """The rows of a target file, comma-delimited or, as the argon target
    is, whitespace-delimited."""
    with open(fn) as f:
        first = f.readline()
    return np.loadtxt(fn, delimiter="," if "," in first else None)


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


# ---------------------------------------------------------------------------
# pair_data_dict: simulated pair targets, discovered from the data files
# ---------------------------------------------------------------------------

# directory -> (key prefix, r_range, target potential (name, kwargs))
_FAMILY_SPECS = {
    "LJ_data": ("lj", (0.75, 3.3), ("LennardJones", {})),
    "softsphere_data": ("softsphere", (0.75, 3.3),
                        ("ExcludedVolume", {"power": 12})),
    "Yukawa_data": ("yukawa", (0.5, 3.0), ("Yukawa", {})),
    "Morse_data": ("morse", (0.5, 3.0), ("Morse", {})),
    "LJfam_data": ("ljfam", (0.75, 3.3), ("LJFamily", {})),
}

_RDF_RE = re.compile(r"rdf_(?P<extra>.*?)rho(?P<rho>[\d.]+)_T(?P<T>[\d.]+)"
                     r"_dt[\d.]+\.csv$")
_STRIPE_RE = re.compile(r"overalp_(?P<rho>[\d.]+)_k(?P<k>[\d.]+)"
                        r"_V0(?P<v0>[\d.]+)_(?P<T>[\d.]+)"
                        r"(?:_cutoff(?P<cut>[\d.]+))?\.csv$")


def exp_angle_data(nbins, angle_range, fn=None):
    """An experimental angle distribution (``fn``, default the water
    O-O-O target ``water_angle_pccp.csv``: rows of degrees and density)
    interpolated onto ``nbins`` points over ``angle_range`` (radians) and
    normalised to sum 1; float64 numpy."""
    fn = fn or str(DATA_DIR / "water_angle_pccp.csv")
    angle_data = np.loadtxt(fn, delimiter=",")
    theta = angle_data[:, 0] * np.pi / 180
    xnew = np.linspace(angle_range[0], angle_range[1], nbins)
    d = np.interp(xnew, theta, angle_data[:, 1])
    return d / d.sum()


def _scan_family(dirname, prefix, r_range, target_pot):
    d = DATA_DIR / dirname
    entries = {}
    if not d.is_dir():
        return entries
    for fn in sorted(os.listdir(d)):
        m = _RDF_RE.match(fn)
        if not m:
            continue
        rho, T = float(m.group("rho")), float(m.group("T"))
        extra = m.group("extra").strip("_")
        key = f"{prefix}_{rho:g}_{T:g}" + (f"_{extra}" if extra else "")
        vacf = d / fn.replace("rdf_", "vacf_")
        entries[key] = {
            "rdf_fn": str(d / fn),
            "vacf_fn": str(vacf) if vacf.exists() else None,
            "rho": rho, "T": T, "start": r_range[0], "end": r_range[1],
            "element": "H", "mass": 1.0, "N_unitcell": 4, "cell": "fcc",
            "reduced_units": True,
            "target_pot": (target_pot[0], dict(target_pot[1])),
        }
    return entries


def _scan_stripes():
    """The 2-D stripe-phase systems: size-25 square lattice, RDF over
    (0.5, 7.5), fit cutoff 8; the cutoff-12 variant size 24, (0.6, 9.75)."""
    d = DATA_DIR / "stripe_data"
    entries = {}
    if not d.is_dir():
        return entries
    for fn in sorted(os.listdir(d)):
        m = _STRIPE_RE.match(fn)
        if not m:
            continue
        rho, T, cut = float(m.group("rho")), float(m.group("T")), \
            m.group("cut")
        key = (f"overlap_{rho:g}_T{T:g}"
               + (f"_cut{float(cut):g}" if cut else ""))
        entries[key] = {
            "rdf_fn": str(d / fn), "vacf_fn": None,
            "rho": rho, "T": T, "dim": 2, "size": 24 if cut else 25,
            "start": 0.6 if cut else 0.5, "end": 9.75 if cut else 7.5,
            "cutoff": float(cut) if cut else 8.0,
            "element": "H", "mass": 1.0, "reduced_units": True,
            "target_pot": ("SplineOverlap", {"K": float(m.group("k")),
                                             "V0": float(m.group("v0"))}),
        }
    return entries


@functools.cache
def _pair_data_dict():
    out = {}
    for dirname, spec in _FAMILY_SPECS.items():
        out.update(_scan_family(dirname, *spec))
    out.update(_scan_stripes())
    return out


class _LazyDict(dict):
    """A dict filled by ``loader`` on its first read, so that importing the
    registry scans no directory."""

    def __init__(self, loader):
        super().__init__()
        self._loader = loader
        self._loaded = False

    def _ensure(self):
        if not self._loaded:
            self.update(self._loader())
            self._loaded = True

    def __getitem__(self, k):
        self._ensure()
        return super().__getitem__(k)

    def __contains__(self, k):
        self._ensure()
        return super().__contains__(k)

    def keys(self):
        self._ensure()
        return super().keys()

    def items(self):
        self._ensure()
        return super().items()

    def __iter__(self):
        self._ensure()
        return super().__iter__()

    def __len__(self):
        self._ensure()
        return super().__len__()


pair_data_dict = _LazyDict(_pair_data_dict)


# ---------------------------------------------------------------------------
# exp_rdf_data_dict: experimental and published-simulation targets
# ---------------------------------------------------------------------------

def _si(fn, rho, T, end=7.9, **kw):
    e = {"fn": str(DATA_DIR / "a-Si" / fn), "rho": rho, "T": T,
         "start": 1.8, "end": end, "element": "Si", "mass": 28.0855,
         "N_unitcell": 8, "cell": "diamond"}
    e.update(kw)
    return e


def _water(sub, fn, rho, T, **kw):
    e = {"fn": str(DATA_DIR / sub / fn), "rho": rho, "T": T,
         "start": 1.8, "end": 7.5, "element": "O", "mass": 18.01528,
         "N_unitcell": 8, "cell": "diamond"}
    e.update(kw)
    return e


exp_rdf_data_dict = {
    "Si_2.293_100K": _si("100K_2.293.csv", 2.293, 100.0),
    "Si_2.287_83K": _si("83K_2.287_exp.csv", 2.287, 83.0, end=10.0),
    "Si_2.327_102K_cry": _si("102K_2.327_exp.csv", 2.3267, 102.0, end=8.0,
                             anneal_flag=True),
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
    "Argon_1.417_298k": {
        "fn": str(DATA_DIR / "argon_exp" / "argon_exp.csv"),
        "rho": 1.417, "T": 298.0, "start": 2.0, "end": 9.0,
        "element": "Ar", "mass": 39.948, "N_unitcell": 4, "cell": "fcc"},
}

# the water O-O-O angle targets by angle cutoff (Angstrom)
angle_data_dict = {
    "water": {
        2.7: str(DATA_DIR / "water_angle_deepcg_2.7.csv"),
        3.7: str(DATA_DIR / "water_angle_deepcg_3.7.csv"),
    }
}
