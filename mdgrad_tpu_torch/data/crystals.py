"""Crystal-structure interop.

Port of ``mdgrad_tpu/data/crystals.py``: pymatgen ``Structure`` objects
(an optional dependency, imported only when called) or plain dicts of
numbers and positions to [Z | x y z] arrays, and the periodic neighbor
graph of a crystal through the port's ``topology.generate_nbr_list``.
"""

import numpy as np
import torch


def structure_to_nxyz(structure):
    """pymatgen Structure -> [Z | x y z] (gated import)."""
    try:
        from pymatgen.core import Structure  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "pymatgen is not installed; use dict_to_nxyz for plain "
            "lattice dicts") from e
    z = np.asarray([site.specie.Z for site in structure], dtype=np.float64)
    xyz = np.asarray([site.coords for site in structure])
    return np.concatenate([z[:, None], xyz], axis=1)


def dict_to_nxyz(d):
    """{'numbers': (N,), 'positions': (N, 3)} -> [Z | x y z]."""
    z = np.asarray(d["numbers"], dtype=np.float64)
    xyz = np.asarray(d["positions"], dtype=np.float64)
    return np.concatenate([z[:, None], xyz], axis=1)


def get_crystal_graph(nxyz, cell, cutoff, device="cuda"):
    """Periodic neighbor graph of a crystal: the padded (i < j)
    ``NeighborList`` within ``cutoff`` (float32, on ``device``: the card
    unless the caller asks for the CPU; no card raises), its capacity the
    estimate of ``topology.estimate_capacity``."""
    from .. import topology
    from .._device import resolve_device
    kw = {"dtype": torch.float32, "device": resolve_device(device)}
    xyz = torch.as_tensor(np.asarray(nxyz)[:, 1:4], **kw)
    cell = torch.as_tensor(np.asarray(cell), **kw)
    cap = topology.estimate_capacity(xyz, cutoff, cell)
    return topology.generate_nbr_list(xyz, cutoff, cell, cap)
