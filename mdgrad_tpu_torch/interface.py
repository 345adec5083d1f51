"""Interactions: potential models adapted to the integrators.

Port of ``mdgrad_tpu/interface.py``: the :class:`Interaction` contract,
:class:`PairPotentials` in modes 'dense', 'table' and 'sparse',
:class:`TPairPotentials`, :class:`GNNPotentials` over an (N, K) neighbor
table (built dense or through the cell list) or an edge list, the cutoff
:class:`Electrostatics` and :class:`EwaldElectrostatics`, the bonded
:class:`BondPotentials` and :class:`AnglePotentials`, :class:`Stack`
(with ``share_aux``) and :class:`WithDynamicCell`.

The JAX contract passes a params pytree into pure functions; here every
interaction is an ``nn.Module`` that owns its parameters:

    ``aux_init(xyz, cell=None)          -> aux``     neighbor state (or ())
    ``aux_update(xyz, aux, cell=None)   -> aux``     refresh of that state
    ``energy(xyz, aux, cell=None)       -> scalar``  differentiable in xyz,
                                                     the module's parameters
                                                     and ``cell``
    ``grow_capacity(factor)             -> bool``    enlarge a fixed neighbor
                                                     capacity after an
                                                     overflow

``cell`` overrides the system's cell with a dynamic one, as the JAX
contract's: a diagonal cell, given as its (3,) lengths (a 3x3 matrix
gives its diagonal), which gradients reach -- ``thermo.pressure`` scales
it with the positions to take the virial.  Each interaction takes
``device`` (default ``"cuda"``; a CUDA device without a card raises) and
moves itself there.
"""

import warnings

import numpy as np
import torch
from torch import nn

from . import topology, units
from ._device import resolve_device
from .system import check_system


def _lengths(cell):
    """(3,) lengths of an override cell given as lengths or a 3x3
    diagonal matrix."""
    cell = torch.as_tensor(cell)
    return torch.diagonal(cell) if cell.dim() == 2 else cell


class Interaction(nn.Module):
    """Base of the interaction contract."""

    def aux_init(self, xyz, cell=None):
        return ()

    def aux_update(self, xyz, aux, cell=None):
        return aux

    def energy(self, xyz, aux, cell=None):
        raise NotImplementedError

    def grow_capacity(self, factor=1.5):
        """Enlarge the fixed neighbor capacity in place after an overflow;
        True if it grew.  The caller rebuilds aux with ``aux_init``, whose
        tables then take the new size.  An interaction with no capacity
        (dense mode) returns False."""
        return False

    def _register_cell(self, name, system):
        """Register ``system``'s cell as (3,) lengths when diagonal (the
        elementwise minimum image, no host check per call), else the 3x3
        matrix: buffer ``name`` in float32, as the JAX package rounds it,
        and ``name + "_f64"`` exact, for float64 runs (``.double()`` would
        only widen the rounded one)."""
        cell = np.asarray(system.get_cell(), dtype=np.float64)
        if topology._is_diagonal(cell):
            cell = np.diag(cell)
        for suffix, dtype in (("", torch.float32), ("_f64", torch.float64)):
            self.register_buffer(name + suffix,
                                 torch.tensor(cell, dtype=dtype),
                                 persistent=False)

    def _register_top(self, system, top):
        """Buffers ``top`` (the bonded index tuples), ``cell_len`` (float32)
        and ``cell_len_f64``: the diagonal of the system's cell, as the JAX
        package's bonded terms take it."""
        self.register_buffer("top", torch.as_tensor(np.asarray(top),
                                                    dtype=torch.long),
                             persistent=False)
        lengths = np.diag(np.asarray(system.get_cell(), dtype=np.float64))
        for suffix, dtype in (("", torch.float32), ("_f64", torch.float64)):
            self.register_buffer("cell_len" + suffix,
                                 torch.tensor(lengths, dtype=dtype),
                                 persistent=False)

    def _cell(self, name, xyz, cell=None):
        """The override ``cell`` as lengths, else buffer ``name`` for
        ``xyz``'s dtype, with no cast per call."""
        if cell is not None:
            return _lengths(cell)
        return getattr(self, name + "_f64" if xyz.dtype == torch.float64
                       else name)


class PairPotentials(Interaction):
    """Sum of an isotropic pair potential over pairs within ``cutoff``,
    with ``index_tuple`` species selection and ``ex_pairs`` exclusions.

    ``mode``:

    * ``'dense'``: the masked N x N evaluation, no neighbor state;
    * ``'table'``: the pair model on each atom's (N, K) neighbor table,
      every pair seen from both rows and weighted 0.5 -- N K evaluations
      instead of N^2, the mode of the pair-MLP fits.  Diagonal cells only.
      ``k_max`` is the largest neighbor count at the system's positions
      times ``capacity_slack``, rounded up to 8.  The table's mask is
      re-applied at the current distances (a stale or shared table stays
      exact), the image offset is computed without gradient, and masked
      slots take distance 1 before the model sees them;
    * ``'sparse'``: a fixed-capacity (i < j) edge list
      (``topology.generate_nbr_list``, ``capacity`` from
      ``topology.estimate_capacity``), distances by
      ``topology.compute_dis``;
    * ``'auto'``: dense when N^2 <= 2^20, else sparse.
    """

    def __init__(self, system, pair_model, cutoff=2.5, index_tuple=None,
                 ex_pairs=None, mode="auto", capacity_slack=1.6,
                 device="cuda"):
        super().__init__()
        check_system(system)
        device = resolve_device(device)
        self.model = pair_model
        self.cutoff = cutoff
        self._register_cell("cell", system)
        lengths = self.cell if self.cell.dim() == 1 else \
            torch.diagonal(self.cell)
        half_box = float(lengths.abs().min()) / 2
        if cutoff > half_box:
            warnings.warn(
                f"cutoff {cutoff} exceeds half the box ({half_box:.3f}); "
                "minimum-image pair selection is ambiguous -- enlarge the "
                "box or reduce the cutoff", stacklevel=2)
        n = system.get_number_of_atoms()
        self.n_atoms = n
        self.register_buffer(
            "select_mask", topology.pair_index_mask(n, index_tuple, ex_pairs),
            persistent=False)
        if mode == "auto":
            mode = "dense" if n * n <= (1 << 20) else "sparse"
        if mode not in ("dense", "table", "sparse"):
            raise ValueError(f"mode {mode!r} not in ('dense', 'table', "
                             "'sparse', 'auto')")
        self.mode = mode
        xyz0 = torch.as_tensor(system.get_positions(), dtype=torch.float32)
        if mode == "sparse":
            self.capacity = topology.estimate_capacity(
                xyz0, cutoff, self.cell, self.select_mask)
        elif mode == "table":
            if self.cell.dim() != 1:
                raise ValueError("mode='table' requires a diagonal cell")
            k0 = topology.max_neighbors(xyz0, cutoff, self.cell,
                                        self.select_mask)
            self.k_max = min(
                int(np.ceil(max(k0, 1) * capacity_slack / 8) * 8), n)
        self.to(device)

    def grow_capacity(self, factor=1.5):
        """'table': ``k_max`` times ``factor``, rounded up to 8 and capped
        at N; 'sparse': ``capacity`` times ``factor``, capped at
        N (N - 1) / 2; True if it grew."""
        n = self.n_atoms
        if self.mode == "table":
            new_k = min(int(np.ceil(self.k_max * factor / 8) * 8), n)
            if new_k > self.k_max:
                self.k_max = new_k
                return True
        elif self.mode == "sparse":
            new_c = min(int(np.ceil(self.capacity * factor)),
                        n * (n - 1) // 2)
            if new_c > self.capacity:
                self.capacity = new_c
                return True
        return False

    def aux_init(self, xyz, cell=None):
        if self.mode == "dense":
            return ()
        cell = self._cell("cell", xyz, cell)
        if self.mode == "table":
            return topology.generate_neighbor_table(
                xyz, self.cutoff, cell, self.k_max, self.select_mask)
        return topology.generate_nbr_list(xyz, self.cutoff, cell,
                                          self.capacity, self.select_mask)

    def aux_update(self, xyz, aux, cell=None):
        return self.aux_init(xyz, cell)

    def _pair_energy(self, r):
        return self.model(r)

    def energy(self, xyz, aux, cell=None):
        cell = self._cell("cell", xyz, cell)
        if self.mode == "dense":
            dist, valid = topology.distance_matrix(xyz, cell)
            mask = valid & torch.triu(torch.ones_like(valid), diagonal=1)
            mask = mask & (dist < self.cutoff)
            if self.select_mask is not None:
                mask = mask & self.select_mask
            safe = torch.where(mask, dist, torch.ones_like(dist))
            u = self._pair_energy(safe[..., None]).squeeze(-1)
            return torch.where(mask, u, torch.zeros_like(u)).sum()
        if self.mode == "table":
            ext = torch.cat([xyz, torch.zeros_like(xyz[:1])])
            d_raw = xyz[:, None, :] - ext[aux.table.long()]
            # elementwise minimum image: the offset is piecewise constant
            with torch.no_grad():
                off = (-(d_raw > 0.5 * cell).to(d_raw.dtype)
                       + (d_raw < -0.5 * cell).to(d_raw.dtype))
            d = d_raw + off * cell
            dist_sq = (d ** 2).sum(-1)
            mask = aux.mask & (dist_sq < self.cutoff ** 2)
            safe = torch.sqrt(torch.where(mask, dist_sq,
                                          torch.ones_like(dist_sq)))
            u = self._pair_energy(safe[..., None]).squeeze(-1)
            # every pair lies in both of its atoms' rows
            return 0.5 * torch.where(mask, u, torch.zeros_like(u)).sum()
        r = topology.compute_dis(xyz, aux.idx, aux.offsets, cell)
        u = self._pair_energy(r).squeeze(-1)
        return torch.where(aux.mask, u, torch.zeros_like(u)).sum()


class TPairPotentials(PairPotentials):
    """Temperature-dependent pair potential u(r, kT) (a ``TPairMLP``).
    ``kT`` (energy units, from ``T_kelvin``) is a buffer, not a parameter:
    annealing sets it and no optimizer sees it."""

    def __init__(self, system, pair_model, T_kelvin, **kw):
        super().__init__(system, pair_model, **kw)
        # float64, cast at each call: float32 runs get the JAX package's
        # rounding, float64 runs the exact value
        self.register_buffer("kT", torch.tensor(
            T_kelvin * units.kB, dtype=torch.float64, device=self.cell.device))

    def _pair_energy(self, r):
        return self.model(r, self.kT.to(r.dtype))


class GNNPotentials(Interaction):
    """GNN force field over a neighbor structure refreshed by
    ``aux_update``.

    ``nbr_mode``: ``'table'`` (the (N, K) table), ``'cells'`` (the same
    table built through the fixed-capacity cell list of ``ops/cells.py``:
    each atom's K nearest among its 27 M cell-neighborhood candidates
    instead of all N -- the large-N path; diagonal cells, no
    ``ex_pairs``, no ``cell=`` override), ``'topk'`` (the directed edge
    list of each atom's K nearest, ``topology.generate_nbr_list_topk``) or
    ``'sparse'`` (the (i < j) edge list of fixed ``capacity``,
    ``topology.generate_nbr_list``; the JAX package takes any other value
    for it).

    ``k_max`` defaults to the largest neighbor count inside ``cutoff +
    skin`` at the system's current positions times ``capacity_slack``,
    rounded up to a multiple of 8; ``capacity`` to the pair count times
    ``capacity_slack``, rounded up to 128; as in the JAX package.

    ``skin`` (the Verlet skin, modes 'table' and 'cells'): the table is built at
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
        if nbr_mode not in ("table", "cells", "topk", "sparse"):
            raise ValueError(f"nbr_mode {nbr_mode!r} not in ('table', "
                             "'cells', 'topk', 'sparse')")
        if skin > 0 and nbr_mode not in ("table", "cells"):
            raise ValueError("skin > 0 requires nbr_mode='table'/'cells' "
                             "(the modes with runtime cutoff re-masking)")
        self._register_cell("cell", system)
        self.store_offsets = self.cell.dim() != 1
        if nbr_mode == "cells":
            if self.store_offsets:
                raise ValueError("nbr_mode='cells' needs a diagonal cell")
            if ex_pairs is not None:
                raise ValueError("nbr_mode='cells' does not support "
                                 "ex_pairs/index selections")
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
        if nbr_mode == "cells":
            self._cells_density = n / float(self.cell.prod())
            self._cells_slack = float(capacity_slack)
            self.register_buffer("_cell_nbrs", torch.zeros(0),
                                 persistent=False)
        self.to(device)
        if nbr_mode == "cells":
            self._make_cell_grid()

    def _make_cell_grid(self):
        """The cell grid at ``build_cutoff`` and the current slack, its
        neighbor table on the module's device."""
        from .ops import cells
        self._cell_dims, self._cell_widths, self._cell_M, nbrs = \
            cells.grid_geometry(self.cell.cpu().double().numpy(),
                                self.build_cutoff, self._cells_density,
                                slack=self._cells_slack)
        self._cell_nbrs = torch.as_tensor(nbrs, device=self.cell.device)

    @property
    def cell_grid(self):
        from .ops import cells
        return cells.CellGrid(self._cell_dims, self._cell_widths,
                              self._cell_M, self._cell_nbrs)

    def grow_capacity(self, factor=1.5):
        """``k_max`` times ``factor``, rounded up to a multiple of 8 and
        capped at N (the edge list: ``capacity`` times ``factor``, capped
        at N (N - 1) / 2); True if it grew.  'cells' also grows the cell
        capacity M (its slack times ``factor``), which overflows
        independently of K, and so always grows."""
        n = int(self.z.shape[0])
        if self.nbr_mode == "sparse":
            new_c = min(int(np.ceil(self.capacity * factor)),
                        n * (n - 1) // 2)
            if new_c > self.capacity:
                self.capacity = new_c
                return True
            return False
        new_k = min(int(np.ceil(self.k_max * factor / 8) * 8), n)
        grew = new_k > self.k_max
        self.k_max = max(new_k, self.k_max)
        if self.nbr_mode == "cells":
            self._cells_slack *= factor
            self._make_cell_grid()
            grew = True
        return grew

    def aux_init(self, xyz, cell=None):
        if cell is not None and self.nbr_mode != "table":
            raise ValueError("dynamic cell override requires "
                             "nbr_mode='table'")
        cell = self._cell("cell", xyz, cell)
        if self.nbr_mode == "cells":
            from .ops import cells
            grid = self.cell_grid
            clist = cells.build_cell_list(xyz, cell, grid)
            return cells.neighbor_table_from_cells(
                xyz, clist, grid, cell, self.build_cutoff, self.k_max)
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

    def aux_update(self, xyz, aux, cell=None):
        return self.aux_init(xyz, cell)

    def _real(self, offsets, cell):
        """Fractional offsets in real space, in full f32 (TF32 is off)."""
        if cell.dim() == 1:
            return offsets * cell
        return torch.matmul(offsets, cell)

    def energy(self, xyz, aux, cell=None, aggr_wgt=None, rows=None,
               senders=None):
        """The GNN's energy; ``aggr_wgt`` (N,), the per-atom weights of
        thermodynamic integration, goes to the GNN (``md/ti.py``).
        ``rows`` and ``senders`` (table and cells modes): the energy of
        those atoms alone, as ``SchNet.atomwise`` takes them."""
        if cell is not None and not (self.nbr_mode == "table"
                                     and not self.store_offsets):
            raise ValueError("dynamic cell override requires "
                             "nbr_mode='table' with a diagonal cell")
        cell = self._cell("cell", xyz, cell)
        if self.nbr_mode in ("table", "cells"):
            return self.gnn.energy(
                self.z, xyz, aux.table, aux.mask,
                cell_len=None if self.store_offsets else cell,
                offsets_real=(self._real(aux.offsets, cell)
                              if self.store_offsets else None),
                runtime_cutoff=self.cutoff if self.skin > 0 else None,
                aggr_wgt=aggr_wgt, rows=rows, senders=senders)
        if rows is not None:
            raise ValueError("rows needs nbr_mode 'table' or 'cells'")
        return self.gnn.energy(
            self.z, xyz, aux.idx, aux.mask,
            offsets_real=self._real(aux.offsets, cell), edge_format="pairs",
            directed=self.nbr_mode == "topk", aggr_wgt=aggr_wgt)


class Electrostatics(Interaction):
    """Cutoff Coulomb sum over the pairs i < j within ``cutoff``:
    conversion q_i q_j / r, with ``index_tuple`` / ``ex_pairs`` selection.
    The reference multiplies q_i by itself; this sum uses q_i q_j, as the
    JAX package's does."""

    def __init__(self, system, charges, cutoff=2.5, index_tuple=None,
                 ex_pairs=None, device="cuda"):
        super().__init__()
        check_system(system)
        device = resolve_device(device)
        charges = np.asarray(charges, dtype=np.float64)
        for suffix, dtype in (("", torch.float32), ("_f64", torch.float64)):
            self.register_buffer("charges" + suffix,
                                 torch.tensor(charges, dtype=dtype),
                                 persistent=False)
        self._register_cell("cell", system)
        self.cutoff = cutoff
        n = system.get_number_of_atoms()
        self.register_buffer(
            "select_mask", topology.pair_index_mask(n, index_tuple, ex_pairs),
            persistent=False)
        # k_e in eV Angstrom / e^2, from SI as the reference builds it
        k_e = 8.987551787e9
        EV_TO_J = 1.60210e-19
        self.conversion = k_e * units.C ** -2 * (1 / EV_TO_J) * units.m
        self.to(device)

    def energy(self, xyz, aux, cell=None):
        dist, valid = topology.distance_matrix(xyz,
                                               self._cell("cell", xyz, cell))
        mask = valid & torch.triu(torch.ones_like(valid), diagonal=1)
        mask = mask & (dist < self.cutoff)
        if self.select_mask is not None:
            mask = mask & self.select_mask
        q = (self.charges_f64 if xyz.dtype == torch.float64
             else self.charges)
        qq = q[:, None] * q[None, :]
        u = self.conversion * qq / torch.where(mask, dist,
                                               torch.ones_like(dist))
        return torch.where(mask, u, torch.zeros_like(u)).sum()


class EwaldElectrostatics(Interaction):
    """Ewald electrostatics (``ops/ewald.py``), differentiable in the
    positions, the charges and the cell.

    ``charges`` are rounded to float32, as the JAX package keeps them;
    ``learn_charges=True`` makes them the parameter ``charges``, else they
    are the buffer ``charges0``.  The cell, too, is float32 (``cell0``):
    its (3,) lengths when diagonal, else the (3, 3) matrix; ``cell=``
    overrides it.  ``r_cut`` defaults to 0.99 of half the smallest
    perpendicular width of the cell.  The k-vectors (``nvecs``) are fixed
    at construction from the system's cell and ``accuracy``.

    ``ex_pairs`` (diagonal cells only): the pairs leave the real sum and
    their reciprocal share is subtracted.  ``mode='table'`` (diagonal
    cells only): the real sum over an (N, K) table from
    ``topology.generate_neighbor_table`` with the exclusions at build
    time; ``k_max`` is the largest neighbor count at the system's
    positions times ``capacity_slack``, rounded up to 8 and capped at N.
    """

    def __init__(self, system, charges, r_cut=None, accuracy=3.2,
                 ex_pairs=None, learn_charges=False, mode="dense",
                 capacity_slack=1.6, device="cuda"):
        from .ops import ewald
        super().__init__()
        check_system(system)
        device = resolve_device(device)
        if mode not in ("dense", "table"):
            raise ValueError(f"mode {mode!r} not in ('dense', 'table')")
        q0 = torch.tensor(np.asarray(charges), dtype=torch.float32)
        self.learn_charges = learn_charges
        if learn_charges:
            self.charges = nn.Parameter(q0)
        else:
            self.register_buffer("charges0", q0, persistent=False)
        cell = np.asarray(system.get_cell(), dtype=np.float64)
        cm = np.diag(cell) if cell.ndim == 1 else cell
        diagonal = topology._is_diagonal(cm)
        self.register_buffer("cell0", torch.tensor(
            np.diag(cm) if diagonal else cm, dtype=torch.float32),
            persistent=False)
        if r_cut is None:
            # half the smallest perpendicular box width (min-image bound)
            V = abs(np.linalg.det(cm))
            widths = [V / np.linalg.norm(np.cross(cm[(i + 1) % 3],
                                                  cm[(i + 2) % 3]))
                      for i in range(3)]
            r_cut = float(min(widths)) / 2 * 0.99
        self.r_cut = r_cut
        self.alpha, k_cut = ewald.ewald_params(r_cut, accuracy)
        self.register_buffer("nvecs", ewald.build_kvectors(cm, k_cut),
                             persistent=False)
        n = system.get_number_of_atoms()
        self.n_atoms = n
        if ex_pairs is not None and not diagonal:
            raise ValueError("ex_pairs requires a diagonal cell "
                             "(elementwise bond re-wrap)")
        self.register_buffer("ex_pairs", None if ex_pairs is None else
                             torch.as_tensor(np.asarray(ex_pairs),
                                             dtype=torch.long),
                             persistent=False)
        self.register_buffer("extra_mask",
                             topology.pair_index_mask(n, None, ex_pairs),
                             persistent=False)
        if mode == "table" and not diagonal:
            raise ValueError("mode='table' requires a diagonal cell")
        self.mode = mode
        if mode == "table":
            xyz0 = torch.as_tensor(system.get_positions(),
                                   dtype=torch.float32)
            k0 = topology.max_neighbors(xyz0, self.r_cut, self.cell0,
                                        self.extra_mask)
            self.k_max = min(
                int(np.ceil(max(k0, 1) * capacity_slack / 8) * 8), n)
        self._ewald = ewald
        self.to(device)

    def grow_capacity(self, factor=1.5):
        """'table': ``k_max`` times ``factor``, rounded up to 8 and capped
        at N; True if it grew."""
        if self.mode != "table":
            return False
        new_k = min(int(np.ceil(self.k_max * factor / 8) * 8), self.n_atoms)
        if new_k > self.k_max:
            self.k_max = new_k
            return True
        return False

    def _cell0(self, xyz, cell):
        return (self.cell0.to(xyz.dtype) if cell is None
                else torch.as_tensor(cell))

    def aux_init(self, xyz, cell=None):
        if self.mode != "table":
            return ()
        return topology.generate_neighbor_table(
            xyz, self.r_cut, self._cell0(xyz, cell), self.k_max,
            self.extra_mask, store_offsets=False)

    def aux_update(self, xyz, aux, cell=None):
        return self.aux_init(xyz, cell=cell)

    def energy(self, xyz, aux, cell=None):
        q = self.charges if self.learn_charges else self.charges0
        return self._ewald.ewald_energy(
            q.to(xyz.dtype), xyz, self._cell0(xyz, cell), self.nvecs,
            self.alpha, self.r_cut, extra_mask=self.extra_mask,
            ex_pairs=self.ex_pairs,
            nbrs=aux if self.mode == "table" else None)


class BondPotentials(Interaction):
    """Harmonic bonds over ``top`` (B, 2) with the diagonal-cell re-wrap:
    0.5 k (r^2 - ro)^2 -- the reference's form, squared length against
    ``ro``, kept for its fitted constants."""

    def __init__(self, system, top, k, ro, device="cuda"):
        super().__init__()
        check_system(system)
        device = resolve_device(device)
        self._register_top(system, top)
        self.k, self.ro = k, ro
        self.to(device)

    def energy(self, xyz, aux, cell=None):
        vec = xyz[self.top[:, 0]] - xyz[self.top[:, 1]]
        vec = topology.wrap_bond_vectors(vec, self._cell("cell_len", xyz,
                                                         cell))
        bond_sq = (vec ** 2).sum(-1)
        return (0.5 * self.k * (bond_sq - self.ro) ** 2).sum()


class AnglePotentials(Interaction):
    """Harmonic angles over ``top`` (A, 3), the apex in the middle:
    0.5 k (theta - thetao)^2, cos(theta) clipped to +-0.999999 before the
    arccos (the reference's acos guard)."""

    def __init__(self, system, top, k, thetao, device="cuda"):
        super().__init__()
        check_system(system)
        device = resolve_device(device)
        self._register_top(system, top)
        self.k, self.thetao = k, thetao
        self.to(device)

    def energy(self, xyz, aux, cell=None):
        cl = self._cell("cell_len", xyz, cell)
        v1 = topology.wrap_bond_vectors(
            xyz[self.top[:, 0]] - xyz[self.top[:, 1]], cl)
        v2 = topology.wrap_bond_vectors(
            xyz[self.top[:, 2]] - xyz[self.top[:, 1]], cl)
        dot = (v1 * v2).sum(-1)
        norm = torch.sqrt((v1 ** 2).sum(-1) * (v2 ** 2).sum(-1))
        cos = torch.clamp(dot / norm, -0.999999, 0.999999)
        angle = torch.arccos(cos)
        return (0.5 * self.k * (angle - self.thetao) ** 2).sum()


class Stack(Interaction):
    """Sum of named interactions; aux is keyed like ``model_dict``.

    ``share_aux={"prior": "nn"}`` makes child "prior" use child "nn"'s
    neighbor structure instead of building its own: the sharer's aux slot
    stays ``()`` and its energy receives the donor's aux; capacity grows
    on the donor only.  Donor and sharer must read the same (N, K) table
    format (a ``GNNPotentials`` table and a ``PairPotentials`` in mode
    'table').  A sharer with a smaller cutoff than the donor's build
    cutoff (cutoff + skin) stays exact: table-mode ``PairPotentials``
    re-masks each slot by its own cutoff at the current distance.
    """

    def __init__(self, model_dict, share_aux=None):
        super().__init__()
        self.models = nn.ModuleDict(model_dict)
        self.share_aux = dict(share_aux or {})
        for k, donor in self.share_aux.items():
            if k not in self.models or donor not in self.models:
                raise ValueError(f"share_aux {k}->{donor}: unknown child")
            if donor in self.share_aux:
                raise ValueError("share_aux chains are not supported")

    def aux_init(self, xyz, cell=None):
        kw = {} if cell is None else {"cell": cell}
        return {k: (() if k in self.share_aux else m.aux_init(xyz, **kw))
                for k, m in self.models.items()}

    def aux_update(self, xyz, aux, cell=None):
        kw = {} if cell is None else {"cell": cell}
        return {k: (() if k in self.share_aux
                    else m.aux_update(xyz, aux[k], **kw))
                for k, m in self.models.items()}

    def grow_capacity(self, factor=1.5):
        """Grow every child's capacity but a sharer's; True if any grew."""
        return any([m.grow_capacity(factor) for k, m in self.models.items()
                    if k not in self.share_aux])

    def energy(self, xyz, aux, cell=None, keys=None):
        """The sum over the children, or over the children ``keys`` only
        (the multiple-time-step split); a sharer reads its donor's aux."""
        kw = {} if cell is None else {"cell": cell}
        total = 0.0
        for k, m in self.models.items():
            if keys is None or k in keys:
                total = total + m.energy(
                    xyz, aux[self.share_aux.get(k, k)], **kw)
        return total


class WithDynamicCell(Interaction):
    """``base`` with the cell carried in the aux: ``aux = (cell_len,
    base_aux)``, ``cell_len`` the (3,) diagonal lengths, passed as
    ``cell=`` to every call of ``base``.  One integrator then serves state
    points of different boxes (the multistate fit).  ``cell_len0`` is the
    cell of ``aux_init`` without an override; ``base``'s capacity is the
    one it was built with.  The cell in the aux is data to the
    multistate fit; the barostats (``NPTBerendsenNHC``, ``NPTMTKNHC``)
    hand their state's cell in its place, and gradients reach it there."""

    def __init__(self, base, cell_len0):
        super().__init__()
        self.base = base
        # float64, cast at each call: float32 runs get the JAX package's
        # rounding, float64 runs the exact lengths
        self.register_buffer("cell_len0", torch.tensor(
            np.asarray(cell_len0, dtype=np.float64),
            device=next(base.buffers()).device), persistent=False)

    def _c(self, xyz, cell):
        c = self.cell_len0 if cell is None else torch.as_tensor(cell)
        return c.to(dtype=xyz.dtype, device=xyz.device)

    def grow_capacity(self, factor=1.5):
        return self.base.grow_capacity(factor)

    def aux_init(self, xyz, cell=None):
        c = self._c(xyz, cell)
        return (c, self.base.aux_init(xyz, cell=c))

    def aux_update(self, xyz, aux, cell=None):
        c = aux[0] if cell is None else self._c(xyz, cell)
        return (c, self.base.aux_update(xyz, aux[1], cell=c))

    def energy(self, xyz, aux, cell=None):
        c = aux[0] if cell is None else cell
        return self.base.energy(xyz, aux[1], cell=c)
