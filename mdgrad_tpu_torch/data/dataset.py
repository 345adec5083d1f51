"""Dataset for supervised force-field training (energies and forces).

Port of ``mdgrad_tpu/data/dataset.py``, numpy only and kept as a copy: a
dict of lists ``props`` keyed on per-geometry ``nxyz`` arrays ([Z | x y
z]), with validation, neighbor-list generation, unit conversion
(kcal/mol <-> atomic units, the port's ``units``), train / validation /
test splitting, concatenation and outlier removal, saved as ``.npz`` in
the JAX package's layout (``<key>__<i>`` arrays beside ``__len__`` and
``__units__``), so a file written by either package loads in the other.
Batching lives in :mod:`mdgrad_tpu_torch.data.loader`.
"""

import os

import numpy as np

from .. import units


class Dataset:
    """props: dict of lists, one entry per geometry; must contain 'nxyz'.

    Optional standard keys: 'energy', 'energy_grad' (= -force),
    'num_atoms', 'nbr_list', 'offsets'.
    """

    def __init__(self, props, units_name="kcal/mol", check=True):
        if check:
            self._check(props)
        self.props = props
        self.units = units_name

    @staticmethod
    def _check(props):
        if "nxyz" not in props:
            raise ValueError("props must contain 'nxyz'")
        n = len(props["nxyz"])
        for k, v in props.items():
            if len(v) != n:
                raise ValueError(
                    f"props[{k!r}] has {len(v)} entries, expected {n}")

    def __len__(self):
        return len(self.props["nxyz"])

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.props.items()}

    # --- neighbor lists -----------------------------------------------------
    def generate_neighbor_list(self, cutoff):
        """Non-PBC (i < j) neighbor list per geometry, zero offsets."""
        nbrs, offs = [], []
        for nxyz in self.props["nxyz"]:
            xyz = np.asarray(nxyz)[:, 1:4]
            d = np.linalg.norm(xyz[:, None] - xyz[None, :], axis=-1)
            iu = np.triu(np.ones_like(d, dtype=bool), k=1)
            i, j = np.nonzero(iu & (d < cutoff))
            nbrs.append(np.stack([i, j], axis=-1).astype(np.int32))
            offs.append(np.zeros((len(i), 3), dtype=np.float32))
        self.props["nbr_list"] = nbrs
        self.props["offsets"] = offs
        return nbrs

    # --- unit conversion ----------------------------------------------------
    def to_units(self, target):
        if target == self.units:
            return self
        key_map = {("kcal/mol", "atomic"): units.KCAL_TO_AU,
                   ("atomic", "kcal/mol"): units.AU_TO_KCAL}
        conv = key_map.get((self.units, target))
        if conv is None:
            raise ValueError(f"cannot convert {self.units} -> {target}")
        for k in list(self.props):
            if k == "energy" or k.endswith("energy"):
                fac = conv["energy"]
            elif k.endswith("_grad"):
                fac = conv["_grad"]
            else:
                continue
            self.props[k] = [np.asarray(v) * fac for v in self.props[k]]
        self.units = target
        return self

    # --- persistence ---------------------------------------------------------
    def save(self, path):
        flat = {}
        for k, v in self.props.items():
            for i, item in enumerate(v):
                flat[f"{k}__{i}"] = np.asarray(item)
        np.savez_compressed(path, __len__=len(self), __units__=self.units,
                            **flat)

    @classmethod
    def load(cls, path):
        z = np.load(path, allow_pickle=False)
        n = int(z["__len__"])
        units_name = str(z["__units__"])
        props = {}
        for key in z.files:
            if key.startswith("__"):
                continue
            k, i = key.rsplit("__", 1)
            props.setdefault(k, [None] * n)[int(i)] = z[key]
        return cls(props, units_name=units_name, check=False)


def concatenate_dict(*dicts):
    """Merge prop dicts, broadcasting scalars to lists."""
    keys = set().union(*[d.keys() for d in dicts])
    out = {k: [] for k in keys}
    for d in dicts:
        n = len(d["nxyz"]) if "nxyz" in d and isinstance(d["nxyz"], list) \
            else 1
        for k in keys:
            v = d.get(k)
            if isinstance(v, list):
                out[k].extend(v)
            else:
                out[k].extend([v] * n)
    return out


def split_train_validation_test(dataset, val_size=0.2, test_size=0.2,
                                seed=0):
    """Random (train, validation, test) split from ``seed``."""
    n = len(dataset)
    idx = np.random.default_rng(seed).permutation(n)
    n_test = int(n * test_size)
    n_val = int(n * val_size)
    parts = (idx[n_test + n_val:], idx[n_test:n_test + n_val],
             idx[:n_test])

    def subset(ids):
        return Dataset({k: [v[i] for i in ids]
                        for k, v in dataset.props.items()},
                       units_name=dataset.units, check=False)
    return tuple(subset(p) for p in parts)


def remove_outliers(dataset, key="energy", std_away=3.0, max_value=None):
    """Drop geometries whose scalar ``key`` lies more than ``std_away``
    standard deviations from the mean (or above ``max_value``)."""
    vals = np.array([float(np.asarray(v).reshape(-1)[0])
                     for v in dataset.props[key]])
    mask = np.abs(vals - vals.mean()) <= std_away * vals.std()
    if max_value is not None:
        mask &= np.abs(vals) <= max_value
    ids = np.nonzero(mask)[0]
    return Dataset({k: [v[i] for i in ids]
                    for k, v in dataset.props.items()},
                   units_name=dataset.units, check=False), ids
