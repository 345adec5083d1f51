"""Interactions: potential models adapted to the integrators.

Port of ``mdgrad_tpu/interface.py`` for the sampling slice: the
:class:`Interaction` contract, :class:`PairPotentials` in dense mode,
:class:`GNNPotentials` over an (N, K) neighbor table, and :class:`Stack`.

The JAX contract passes a params pytree into pure functions; here every
interaction is an ``nn.Module`` that owns its parameters:

    ``aux_init(xyz)          -> aux``     neighbor state (or ())
    ``aux_update(xyz, aux)   -> aux``     refresh of that state
    ``energy(xyz, aux)       -> scalar``  differentiable in xyz and the
                                          module's parameters
    ``grow_capacity(factor)  -> bool``    enlarge a fixed neighbor capacity
                                          after an overflow

Each interaction takes ``device`` (default ``"cuda"``; a CUDA device
without a card raises) and moves itself there.
"""

import warnings

import numpy as np
import torch
from torch import nn

from . import topology
from ._device import resolve_device
from .system import check_system


class Interaction(nn.Module):
    """Base of the interaction contract."""

    def aux_init(self, xyz):
        return ()

    def aux_update(self, xyz, aux):
        return aux

    def energy(self, xyz, aux):
        raise NotImplementedError

    def grow_capacity(self, factor=1.5):
        """Enlarge the fixed neighbor capacity in place after an overflow;
        True if it grew.  The caller rebuilds aux with ``aux_init``, whose
        tables then take the new size.  An interaction with no capacity
        (dense mode) returns False."""
        return False

    def _register_cell(self, name, system):
        """Register the cell as (3,) lengths when diagonal (the elementwise
        minimum image, no host check per call), else the 3x3 matrix: buffer
        ``name`` in float32, as the JAX package rounds it, and
        ``name + "_f64"`` exact, for float64 runs (``.double()`` would only
        widen the rounded one)."""
        cell = np.asarray(system.get_cell(), dtype=np.float64)
        if topology._is_diagonal(cell):
            cell = np.diag(cell)
        for suffix, dtype in (("", torch.float32), ("_f64", torch.float64)):
            self.register_buffer(name + suffix,
                                 torch.tensor(cell, dtype=dtype),
                                 persistent=False)

    def _cell(self, name, xyz):
        """Buffer ``name`` for ``xyz``'s dtype, with no cast per call."""
        return getattr(self, name + "_f64" if xyz.dtype == torch.float64
                       else name)


class PairPotentials(Interaction):
    """Sum of an isotropic pair potential over pairs within ``cutoff``.

    Only ``mode='dense'`` is ported (masked N x N evaluation, no neighbor
    state); ``'auto'`` resolves to it for N^2 <= 2^20 as in the JAX
    package.  The 'sparse' and 'table' modes come with the pair slice.
    """

    def __init__(self, system, pair_model, cutoff=2.5, index_tuple=None,
                 ex_pairs=None, mode="auto", device="cuda"):
        super().__init__()
        check_system(system)
        device = resolve_device(device)
        self.model = pair_model
        self.cutoff = cutoff
        half_box = float(np.abs(np.diag(system.get_cell())).min()) / 2
        if cutoff > half_box:
            warnings.warn(
                f"cutoff {cutoff} exceeds half the box ({half_box:.3f}); "
                "minimum-image pair selection is ambiguous -- enlarge the "
                "box or reduce the cutoff", stacklevel=2)
        n = system.get_number_of_atoms()
        if mode == "auto":
            mode = "dense" if n * n <= (1 << 20) else "sparse"
        if mode != "dense":
            raise NotImplementedError(f"PairPotentials mode {mode!r}: only "
                                      "'dense' is ported so far")
        self.mode = mode
        self._register_cell("cell", system)
        self.register_buffer(
            "select_mask", topology.pair_index_mask(n, index_tuple, ex_pairs),
            persistent=False)
        self.to(device)

    def energy(self, xyz, aux):
        dist, valid = topology.distance_matrix(xyz, self._cell("cell", xyz))
        mask = valid & torch.triu(torch.ones_like(valid), diagonal=1)
        mask = mask & (dist < self.cutoff)
        if self.select_mask is not None:
            mask = mask & self.select_mask
        safe = torch.where(mask, dist, torch.ones_like(dist))
        u = self.model(safe[..., None]).squeeze(-1)
        return torch.where(mask, u, torch.zeros_like(u)).sum()


class GNNPotentials(Interaction):
    """GNN force field over an (N, K) neighbor table refreshed by
    ``aux_update`` (``nbr_mode='table'``, diagonal cells).

    ``k_max`` defaults to the largest in-cutoff neighbor count at the
    system's current positions times ``capacity_slack``, rounded up to a
    multiple of 8, as in the JAX package.
    """

    def __init__(self, system, gnn, cutoff, ex_pairs=None,
                 capacity_slack=1.6, nbr_mode="table", k_max=None,
                 device="cuda"):
        super().__init__()
        check_system(system)
        device = resolve_device(device)
        if nbr_mode != "table":
            raise NotImplementedError(f"nbr_mode {nbr_mode!r}: only 'table' "
                                      "is ported so far")
        self._register_cell("cell_len", system)
        if self.cell_len.dim() != 1:
            raise NotImplementedError("GNNPotentials needs a diagonal cell "
                                      "in this port")
        self.gnn = gnn
        self.cutoff = cutoff
        self.nbr_mode = nbr_mode
        n = system.get_number_of_atoms()
        self.register_buffer(
            "z", torch.as_tensor(system.get_atomic_numbers(),
                                 dtype=torch.long), persistent=False)
        self.register_buffer("select_mask",
                             topology.pair_index_mask(n, None, ex_pairs),
                             persistent=False)
        if k_max is None:
            xyz0 = torch.as_tensor(system.get_positions(),
                                   dtype=torch.float32)
            k0 = topology.max_neighbors(xyz0, cutoff, self.cell_len,
                                        self.select_mask)
            k_max = int(np.ceil(max(k0, 1) * capacity_slack / 8) * 8)
        self.k_max = min(k_max, n)
        self.to(device)

    def grow_capacity(self, factor=1.5):
        """``k_max`` times ``factor``, rounded up to a multiple of 8 and
        capped at N; True if it grew."""
        n = int(self.z.shape[0])
        new_k = min(int(np.ceil(self.k_max * factor / 8) * 8), n)
        if new_k > self.k_max:
            self.k_max = new_k
            return True
        return False

    def aux_init(self, xyz):
        return topology.generate_neighbor_table(
            xyz, self.cutoff, self._cell("cell_len", xyz), self.k_max,
            self.select_mask)

    def aux_update(self, xyz, aux):
        return self.aux_init(xyz)

    def energy(self, xyz, aux):
        return self.gnn.energy(self.z, xyz, aux.table, aux.mask,
                               self._cell("cell_len", xyz))


class Stack(Interaction):
    """Sum of named interactions; params and aux are keyed like
    ``model_dict`` (``share_aux`` is not ported yet)."""

    def __init__(self, model_dict):
        super().__init__()
        self.models = nn.ModuleDict(model_dict)

    def aux_init(self, xyz):
        return {k: m.aux_init(xyz) for k, m in self.models.items()}

    def aux_update(self, xyz, aux):
        return {k: m.aux_update(xyz, aux[k]) for k, m in self.models.items()}

    def grow_capacity(self, factor=1.5):
        """Grow every child's capacity; True if any grew."""
        return any([m.grow_capacity(factor) for m in self.models.values()])

    def energy(self, xyz, aux):
        total = 0.0
        for k, m in self.models.items():
            total = total + m.energy(xyz, aux[k])
        return total
