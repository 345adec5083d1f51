"""Interactions: potential models adapted to the integrators.

Port of ``mdgrad_tpu/interface.py`` for the sampling slice: the
:class:`Interaction` contract, :class:`PairPotentials` in dense mode,
:class:`GNNPotentials` over an (N, K) neighbor table or an edge list,
and :class:`Stack`.

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
    """GNN force field over a neighbor structure refreshed by
    ``aux_update``.

    ``nbr_mode``: ``'table'`` (the (N, K) table), ``'topk'`` (the directed
    edge list of each atom's K nearest, ``topology.generate_nbr_list_topk``)
    or ``'sparse'`` (the (i < j) edge list of fixed ``capacity``,
    ``topology.generate_nbr_list``; the JAX package takes any other value
    for it).  ``'cells'`` is not ported (ROADMAP Queue 1, Slice E).

    ``k_max`` defaults to the largest neighbor count inside ``cutoff +
    skin`` at the system's current positions times ``capacity_slack``,
    rounded up to a multiple of 8; ``capacity`` to the pair count times
    ``capacity_slack``, rounded up to 128; as in the JAX package.

    ``skin`` (the Verlet skin, table mode only): the table is built at
    ``cutoff + skin`` and SchNet masks each edge by its current length, so
    a table refreshed every ``topology_update_freq`` steps stays exact
    while no atom moves more than skin / 2 between refreshes.

    A triclinic cell stores each table edge's offsets
    (``store_offsets``); energy turns them into real space in full f32.
    """

    def __init__(self, system, gnn, cutoff, ex_pairs=None, capacity=None,
                 capacity_slack=1.6, nbr_mode="table", k_max=None, skin=0.0,
                 device="cuda"):
        super().__init__()
        check_system(system)
        device = resolve_device(device)
        if nbr_mode == "cells":
            raise NotImplementedError(
                "nbr_mode 'cells' is not ported yet (ROADMAP Queue 1, "
                "Slice E: large N)")
        if nbr_mode not in ("table", "topk", "sparse"):
            raise ValueError(f"nbr_mode {nbr_mode!r} not in ('table', "
                             "'topk', 'sparse')")
        if skin > 0 and nbr_mode != "table":
            raise ValueError("skin > 0 requires nbr_mode='table' (the mode "
                             "with runtime cutoff re-masking)")
        self._register_cell("cell", system)
        self.store_offsets = self.cell.dim() != 1
        self.gnn = gnn
        self.cutoff = cutoff
        self.skin = skin
        self.build_cutoff = cutoff + skin
        self.nbr_mode = nbr_mode
        n = system.get_number_of_atoms()
        self.register_buffer(
            "z", torch.as_tensor(system.get_atomic_numbers(),
                                 dtype=torch.long), persistent=False)
        self.register_buffer("select_mask",
                             topology.pair_index_mask(n, None, ex_pairs),
                             persistent=False)
        xyz0 = torch.as_tensor(system.get_positions(), dtype=torch.float32)
        if nbr_mode == "sparse":
            self.capacity = capacity or topology.estimate_capacity(
                xyz0, cutoff, self.cell, self.select_mask,
                slack=capacity_slack)
        else:
            if k_max is None:
                k0 = topology.max_neighbors(xyz0, self.build_cutoff,
                                            self.cell, self.select_mask)
                k_max = int(np.ceil(max(k0, 1) * capacity_slack / 8) * 8)
            self.k_max = min(k_max, n)
        self.to(device)

    def grow_capacity(self, factor=1.5):
        """``k_max`` times ``factor``, rounded up to a multiple of 8 and
        capped at N (the edge list: ``capacity`` times ``factor``, capped
        at N (N - 1) / 2); True if it grew."""
        n = int(self.z.shape[0])
        if self.nbr_mode == "sparse":
            new_c = min(int(np.ceil(self.capacity * factor)),
                        n * (n - 1) // 2)
            if new_c > self.capacity:
                self.capacity = new_c
                return True
            return False
        new_k = min(int(np.ceil(self.k_max * factor / 8) * 8), n)
        if new_k > self.k_max:
            self.k_max = new_k
            return True
        return False

    def aux_init(self, xyz):
        cell = self._cell("cell", xyz)
        if self.nbr_mode == "table":
            return topology.generate_neighbor_table(
                xyz, self.build_cutoff, cell, self.k_max, self.select_mask,
                store_offsets=self.store_offsets)
        if self.nbr_mode == "topk":
            return topology.generate_nbr_list_topk(
                xyz, self.cutoff, cell, self.k_max, self.select_mask,
                directed=True)
        return topology.generate_nbr_list(xyz, self.cutoff, cell,
                                          self.capacity, self.select_mask)

    def aux_update(self, xyz, aux):
        return self.aux_init(xyz)

    def _real(self, offsets, cell):
        """Fractional offsets in real space, in full f32 (TF32 is off)."""
        if cell.dim() == 1:
            return offsets * cell
        return torch.matmul(offsets, cell)

    def energy(self, xyz, aux):
        cell = self._cell("cell", xyz)
        if self.nbr_mode == "table":
            return self.gnn.energy(
                self.z, xyz, aux.table, aux.mask,
                cell_len=None if self.store_offsets else cell,
                offsets_real=(self._real(aux.offsets, cell)
                              if self.store_offsets else None),
                runtime_cutoff=self.cutoff if self.skin > 0 else None)
        return self.gnn.energy(
            self.z, xyz, aux.idx, aux.mask,
            offsets_real=self._real(aux.offsets, cell), edge_format="pairs",
            directed=self.nbr_mode == "topk")


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
