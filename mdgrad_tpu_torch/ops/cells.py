"""Fixed-capacity cell list: O(N) neighbor culling for large systems.

Port of ``mdgrad_tpu/ops/cells.py``, plain PyTorch as the JAX module is
plain ``jnp`` (it reaches no ``pl.pallas_call``).  Atoms are binned into a
static grid of cells of width >= cutoff; pair work runs cell-major, each
cell's rows against the columns of its 27-cell neighborhood, so it is
O(N * 27 * M) instead of O(N^2):

* a cell holds at most ``M`` atoms (the density estimate times a slack,
  rounded up to 8); a fuller cell sets ``overflow`` -- detected, never
  silent;
* :func:`build_cell_list` sorts the atoms by cell id (a stable sort, so
  the slots of a cell follow atom index, as ``jnp.argsort``'s do), ranks
  them inside their cell from the run starts, and scatters them into the
  (n_cells * M,) slots once;
* the periodic 27-neighborhood is a static numpy table (n_cells, 27) made
  at construction and kept as a device tensor; the minimum image is
  elementwise (diagonal cells only).

The same structure gives analytic LJ-family forces (:class:`CellLJPair`,
the large-N sampling path) and the SchNet's (N, K) neighbor table
(:func:`neighbor_table_from_cells`, ``GNNPotentials(nbr_mode='cells')``),
whose top-k candidates shrink from N to 27 M.  ``jax.lax.approx_min_k``
(``recall_target=1.0``, exact) becomes ``torch.topk``; ties between equal
distances may fall another way, so tables compare as per-row sets.
"""

import typing

import numpy as np
import torch

from .. import topology
from .._device import resolve_device
from ..interface import Interaction
from ..system import check_system


class CellGrid(typing.NamedTuple):
    """Static grid geometry."""
    dims: typing.Tuple[int, int, int]       # cells per axis
    widths: typing.Tuple[float, float, float]
    M: int                                  # per-cell capacity
    nbr_cells: torch.Tensor                 # (n_cells, 27) int64


class CellList(typing.NamedTuple):
    """Per-configuration binning (rebuilt by :func:`build_cell_list`)."""
    slots: torch.Tensor          # (n_cells * M,) atom index, padded with N
    slot_mask: torch.Tensor      # (n_cells * M,) bool
    slot_of_atom: torch.Tensor   # (N,) slot holding each atom
    overflow: torch.Tensor       # () bool


def grid_geometry(cell_len, cutoff, density, slack=1.6):
    """(dims, widths, M, nbr_cells as an (n_cells, 27) int64 numpy array)
    for a diagonal box: floor(L / cutoff) cells per axis (at least 3, so
    that the 27-neighborhood tiles the box without repeats), widths L /
    dims, capacity from the density estimate."""
    L = np.asarray(cell_len, dtype=np.float64).reshape(3)
    dims = np.maximum(np.floor(L / cutoff).astype(int), 1)
    if np.any(dims < 3):
        raise ValueError(
            f"box {L} supports only {dims} cells of width >= {cutoff}; "
            "use the dense path below 3 cells per axis")
    widths = L / dims
    vol = float(np.prod(widths))
    M = int(np.ceil(max(density * vol, 1.0) * slack / 8) * 8)
    n_cells = int(np.prod(dims))
    cx, cy, cz = np.unravel_index(np.arange(n_cells), dims)
    nbrs = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nbrs.append(np.ravel_multi_index(
                    ((cx + dx) % dims[0], (cy + dy) % dims[1],
                     (cz + dz) % dims[2]), dims))
    return (tuple(int(d) for d in dims), tuple(float(w) for w in widths), M,
            np.stack(nbrs, axis=1).astype(np.int64))


def make_cell_grid(cell_len, cutoff, density, slack=1.6, device="cuda"):
    """:class:`CellGrid` of a diagonal box (:func:`grid_geometry`), its
    neighbor table on ``device`` (the card unless the caller asks for
    the CPU; no card raises)."""
    dims, widths, M, nbrs = grid_geometry(cell_len, cutoff, density, slack)
    return CellGrid(dims=dims, widths=widths, M=M,
                    nbr_cells=torch.as_tensor(
                        nbrs, device=resolve_device(device)))


def build_cell_list(xyz, cell_len, grid):
    """Bin atoms into cells: sort by cell id, rank inside each cell from the
    sorted run starts, one scatter into the (n_cells * M,) slots.  Under
    overflow the rank is clamped to M - 1, so several atoms write one slot,
    whose content is then unspecified (as in the JAX package); the
    ``overflow`` flag says so."""
    xyz = xyz.detach()
    n = xyz.shape[0]
    dev = xyz.device
    L = torch.as_tensor(cell_len, dtype=xyz.dtype, device=dev)
    dims = torch.tensor(grid.dims, device=dev)
    widths = torch.tensor(grid.widths, dtype=xyz.dtype, device=dev)
    frac = xyz - torch.floor(xyz / L) * L          # wrap into [0, L)
    coords = torch.minimum((frac / widths).to(torch.int64).clamp(min=0),
                           dims - 1)
    cell_id = ((coords[:, 0] * grid.dims[1] + coords[:, 1])
               * grid.dims[2] + coords[:, 2])
    sorted_ids, order = torch.sort(cell_id, stable=True)
    n_cells = int(np.prod(grid.dims))
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(n_cells, device=dev))
    rank = torch.arange(n, device=dev) - starts[sorted_ids]
    counts = torch.bincount(cell_id, minlength=n_cells)
    overflow = (counts > grid.M).any()
    slot_idx = sorted_ids * grid.M + torch.clamp(rank, max=grid.M - 1)
    slots = torch.full((n_cells * grid.M,), n, dtype=torch.int64, device=dev)
    slots[slot_idx] = order
    slot_of_atom = torch.zeros(n, dtype=torch.int64, device=dev)
    slot_of_atom[order] = slot_idx
    return CellList(slots=slots, slot_mask=slots < n,
                    slot_of_atom=slot_of_atom, overflow=overflow)


def _min_image_elem(d, L):
    return d - torch.round(d / L) * L


def _cell_major(xyz, clist, grid):
    """Rows (n_cells, M, 3), their atom ids (n_cells, M), columns
    (n_cells, 27 M, 3) and their ids; padded slots gather a zero sentinel
    row and carry id N."""
    ext = torch.cat([xyz, torch.zeros_like(xyz[:1])], dim=0)
    n_cells, M = grid.nbr_cells.shape[0], grid.M
    xyz_cs = ext[clist.slots].reshape(n_cells, M, 3)
    ids_cs = clist.slots.reshape(n_cells, M)
    cols = xyz_cs[grid.nbr_cells].reshape(n_cells, 27 * M, 3)
    col_ids = ids_cs[grid.nbr_cells].reshape(n_cells, 27 * M)
    return xyz_cs, ids_cs, cols, col_ids


def _pairs(xyz, clist, grid, cell_len, cutoff):
    """(d (n_cells, M, 27 M, 3), r^2, valid): every (row, column) pair of
    distinct real atoms inside ``cutoff``, minimum-imaged."""
    n = xyz.shape[0]
    L = torch.as_tensor(cell_len, dtype=xyz.dtype, device=xyz.device)
    rows, row_ids, cols, col_ids = _cell_major(xyz, clist, grid)
    d = _min_image_elem(rows[:, :, None, :] - cols[:, None, :, :], L)
    r_sq = (d ** 2).sum(-1)
    valid = ((row_ids[:, :, None] != col_ids[:, None, :])
             & (row_ids[:, :, None] < n) & (col_ids[:, None, :] < n)
             & (r_sq < cutoff ** 2))
    return d, r_sq, valid, col_ids


def cell_pair_energy_forces(pair_u_g, xyz, clist, grid, cell_len, cutoff):
    """(total energy, forces (N, 3)) with analytic per-pair derivatives.

    ``pair_u_g(r_sq) -> (u, g)`` with g = u'(r) / r; every pair is seen
    from both of its cells, so the energy is halved."""
    d, r_sq, valid, _ = _pairs(xyz, clist, grid, cell_len, cutoff)
    r_sq = torch.where(valid, r_sq, torch.ones_like(r_sq))
    u, g = pair_u_g(r_sq)
    u = torch.where(valid, u, torch.zeros_like(u))
    g = torch.where(valid, g, torch.zeros_like(g))
    energy = 0.5 * u.sum()
    f_rows = -(g[..., None] * d).sum(2)          # (n_cells, M, 3)
    return energy, f_rows.reshape(-1, 3)[clist.slot_of_atom]


def lj_u_g(sigma, epsilon, rep_pow=12, attr_pow=6):
    """LJ-family (u, u'/r) closure for :func:`cell_pair_energy_forces`."""
    def fn(r_sq):
        inv_r2 = 1.0 / r_sq
        sr = sigma * torch.sqrt(inv_r2)
        sr_a = sr ** attr_pow
        sr_r = sr ** rep_pow
        u = 4.0 * epsilon * (sr_r - sr_a)
        g = 4.0 * epsilon * (-rep_pow * sr_r + attr_pow * sr_a) * inv_r2
        return u, g
    return fn


class CellLJPair(Interaction):
    """LJ-family energy and analytic forces through the cell list (the
    10k-100k-atom sampling path; the scope of
    :class:`~mdgrad_tpu_torch.ops.pair.PallasLJPair` at O(N 27 M) work).

    ``sigma`` and ``epsilon`` are parameters; aux is the
    :class:`CellList`, rebuilt by ``aux_update``.  ``skin`` widens the
    cells for a table kept over several steps (``topology_update_freq``).
    """

    def __init__(self, system, cutoff, sigma=1.0, epsilon=1.0, rep_pow=12,
                 attr_pow=6, skin=0.0, slack=1.6, device="cuda"):
        super().__init__()
        check_system(system)
        device = resolve_device(device)
        cell = np.asarray(system.get_cell(), dtype=np.float64)
        if not topology._is_diagonal(cell):
            raise ValueError("CellLJPair needs a diagonal cell")
        # the grid from the float32 lengths, as the JAX package sizes it
        cell_len = np.diag(cell).astype(np.float32).astype(np.float64)
        self.cutoff = cutoff
        self.rep_pow, self.attr_pow = rep_pow, attr_pow
        self.sigma = torch.nn.Parameter(torch.tensor(float(sigma)))
        self.epsilon = torch.nn.Parameter(torch.tensor(float(epsilon)))
        density = system.get_number_of_atoms() / float(np.prod(cell_len))
        self.dims, self.widths, self.M, nbrs = grid_geometry(
            cell_len, cutoff + skin, density, slack=slack)
        self.register_buffer("nbr_cells", torch.as_tensor(nbrs),
                             persistent=False)
        self._register_cell("cell_len", system)
        self.to(device)

    @property
    def grid(self):
        return CellGrid(self.dims, self.widths, self.M, self.nbr_cells)

    def aux_init(self, xyz, cell=None):
        if cell is not None:
            raise ValueError("CellLJPair has a fixed cell")
        return build_cell_list(xyz, self._cell("cell_len", xyz), self.grid)

    def aux_update(self, xyz, aux, cell=None):
        return self.aux_init(xyz, cell)

    def _u_g(self, dtype):
        return lj_u_g(self.sigma.to(dtype), self.epsilon.to(dtype),
                      self.rep_pow, self.attr_pow)

    def energy_forces(self, xyz, aux):
        return cell_pair_energy_forces(
            self._u_g(xyz.dtype), xyz, aux, self.grid,
            self._cell("cell_len", xyz), self.cutoff)

    def energy(self, xyz, aux, cell=None):
        if cell is not None:
            raise ValueError("CellLJPair has a fixed cell")
        return self.energy_forces(xyz, aux)[0]

    def force(self, xyz, aux):
        return self.energy_forces(xyz, aux)[1]


def neighbor_table_from_cells(xyz, clist, grid, cell_len, cutoff, k_max):
    """(N, K) :class:`~mdgrad_tpu_torch.topology.NeighborTable`, offsets
    free, from the cell list: each atom's ``k_max`` nearest among its
    27 M candidates.  ``overflow`` flags an atom with more neighbors or a
    cell past its capacity; ``drift`` the raw positions' single-image
    validity (the downstream energy minimum-images them, unwrapped).
    ``k_max`` above 27 M raises, as the JAX package's ``approx_min_k``
    does."""
    n = xyz.shape[0]
    width = 27 * grid.M
    if k_max > width:
        raise ValueError(f"k must be smaller than the size of the candidate "
                         f"set {width}, got {k_max}")
    xyz = xyz.detach()
    _, r_sq, valid, col_ids = _pairs(xyz, clist, grid, cell_len, cutoff)
    score = torch.where(valid, r_sq, torch.full_like(r_sq, np.inf))
    vals, pos = torch.topk(score.reshape(-1, width), k_max, dim=-1,
                           largest=False)
    found = vals < np.inf
    cand_ids = col_ids[:, None, :].expand(score.shape).reshape(-1, width)
    chosen = torch.gather(cand_ids, 1, pos)
    table_cs = torch.where(found, chosen, n).to(torch.int32)
    overflow = (valid.sum(-1) > k_max).any() | clist.overflow
    L = torch.as_tensor(cell_len, dtype=xyz.dtype, device=xyz.device)
    return topology.NeighborTable(
        table=table_cs[clist.slot_of_atom], mask=found[clist.slot_of_atom],
        overflow=overflow, drift=topology.image_drift(xyz, L))
