"""Periodic-boundary geometry and the (N, K) neighbor table.

Port of ``mdgrad_tpu/topology.py``: minimum image,
dense distance matrices, pair selection masks, the per-atom neighbor
table (with stored offsets for triclinic cells) with its overflow and
drift flags, the padded edge lists (``generate_nbr_list`` and the
``top_k`` builder ``generate_nbr_list_topk``), the capacity estimate, and
the differentiable distances of an edge list (``compute_dis``), and the
angle observables' per-atom table (``neighbors_per_atom``,
``angle_triples``, ``wrap_bond_vectors``).
``lax.approx_min_k`` and ``lax.top_k`` become ``torch.topk`` on the
masked distance scores, ``jnp.nonzero(size=...)`` a ``torch.nonzero``
cut or padded to the capacity; the lists keep the JAX package's padding
sentinel N.  The 3x3 cell projections are plain f32 matmuls with TF32
switched off (see ``_device.resolve_device``).
"""

import typing

import numpy as np
import torch


class NeighborTable(typing.NamedTuple):
    """Per-atom fixed-width neighbor table.

    table:    (N, K) int32 neighbor indices, padded with N
    mask:     (N, K) bool
    overflow: () bool tensor -- some atom had more than K neighbors
    drift:    () bool tensor -- positions outside single-image validity
    offsets:  (N, K, 3) fractional minimum-image offsets of each edge, or
              () where the consumer recomputes the image (diagonal cells)
    """
    table: torch.Tensor
    mask: torch.Tensor
    overflow: torch.Tensor
    drift: torch.Tensor
    offsets: typing.Any = ()


class NeighborList(typing.NamedTuple):
    """Fixed-capacity padded pair list.

    idx:      (P, 2) int32, padded rows hold N
    offsets:  (P, 3) fractional minimum-image offsets in {-1, 0, 1}
    mask:     (P,) bool, True for real pairs
    count:    () int tensor, number of real pairs
    overflow: () bool tensor -- the pairs exceeded the capacity (or some
              atom its k_max, for the top_k builder)
    drift:    () bool tensor -- positions outside single-image validity
    """
    idx: torch.Tensor
    offsets: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor
    drift: torch.Tensor


def _is_diagonal(cell):
    c = cell.detach().cpu().numpy() if torch.is_tensor(cell) else \
        np.asarray(cell)
    return c.ndim == 2 and not np.any(c - np.diag(np.diag(c)))


def _cell_lengths(cell):
    """(3,) lengths of a 1-D or diagonal cell, else None."""
    if cell.dim() == 1:
        return cell
    return torch.diagonal(cell) if _is_diagonal(cell) else None


def min_image(disp, cell):
    """Minimum-image displacements and their fractional offsets in
    {-1, 0, 1}; diagonal cells elementwise, triclinic through the cell."""
    L = _cell_lengths(cell)
    if L is not None:
        offsets = (-(disp > 0.5 * L).to(disp.dtype)
                   + (disp < -0.5 * L).to(disp.dtype))
        return disp + offsets * L, offsets
    reduced = torch.matmul(disp, torch.linalg.inv(cell))
    offsets = (-(reduced > 0.5).to(disp.dtype)
               + (reduced < -0.5).to(disp.dtype))
    return disp + torch.matmul(offsets, cell), offsets


def image_drift(xyz, cell):
    """Bool tensor: some fractional coordinate left [-0.25, 1.25], past
    which single-image minimum-image distances may be wrong."""
    L = _cell_lengths(cell)
    frac = xyz / L if L is not None else torch.matmul(
        xyz, torch.linalg.inv(cell))
    return ((frac < -0.25) | (frac > 1.25)).any()


def displacement_matrix(xyz, cell):
    """d[i, j] = xyz[j] - xyz[i], minimum-imaged; returns (d, offsets)."""
    disp = xyz[..., None, :, :] - xyz[..., :, None, :]
    return min_image(disp, cell)


def distance_matrix(xyz, cell):
    """(dist (N, N), valid (N, N) bool); the diagonal distance is 1 so
    that r**-p stays finite, and ``valid`` excludes it."""
    d, _ = displacement_matrix(xyz, cell)
    dist_sq = (d ** 2).sum(-1)
    n = xyz.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=xyz.device)
    safe = torch.where(eye, torch.ones_like(dist_sq), dist_sq)
    return torch.sqrt(safe), ~eye


def pair_index_mask(n, index_tuple=None, ex_pairs=None):
    """(N, N) bool CPU tensor selecting species pairs (``index_tuple``)
    minus excluded bonded pairs (``ex_pairs``); None when nothing is
    restricted."""
    if index_tuple is None and ex_pairs is None:
        return None
    if index_tuple is not None:
        mask = np.zeros((n, n), dtype=bool)
        a = np.asarray(index_tuple[0]).reshape(-1)
        b = np.asarray(index_tuple[1]).reshape(-1)
        mask[np.ix_(a, b)] = True
        mask[np.ix_(b, a)] = True
    else:
        mask = np.ones((n, n), dtype=bool)
    if ex_pairs is not None:
        ex = np.asarray(ex_pairs)
        mask[ex[:, 0], ex[:, 1]] = False
        mask[ex[:, 1], ex[:, 0]] = False
    return torch.from_numpy(mask)


def _within(xyz, cutoff, cell, select_mask):
    d, offsets = displacement_matrix(xyz, cell)
    dist_sq = (d ** 2).sum(-1)
    n = xyz.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=xyz.device)
    within = (dist_sq < cutoff ** 2) & ~eye
    if select_mask is not None:
        within = within & select_mask.to(xyz.device)
    return within, dist_sq, offsets


def _nearest(xyz, cutoff, cell, k_max, select_mask):
    """(within (N, N), cols (N, K), valid (N, K), offsets (N, N, 3)): each
    atom's ``k_max`` nearest neighbors inside ``cutoff``."""
    within, dist_sq, offsets = _within(xyz, cutoff, cell, select_mask)
    score = torch.where(within, dist_sq, torch.full_like(dist_sq, np.inf))
    vals, cols = torch.topk(score, k_max, dim=-1, largest=False)
    return within, cols, vals < np.inf, offsets


def _edge_offsets(offsets, rows, cols, keep):
    """(..., 3) offsets of the edges (rows, cols), zero where not kept."""
    off = offsets[rows, cols]
    return torch.where(keep[..., None], off, torch.zeros_like(off))


def generate_neighbor_table(xyz, cutoff, cell, k_max, select_mask=None,
                            store_offsets=False):
    """(N, K) table of each atom's ``k_max`` nearest neighbors inside
    ``cutoff``, padded with N; ``overflow`` flags an atom with more.

    ``store_offsets`` keeps each edge's (N, K, 3) fractional offsets, which
    a triclinic cell needs.  Without them (the default here; the JAX
    package's ``store_offsets=False``) the cell must be diagonal and the
    consumer recomputes the minimum image from gathered positions.
    """
    if not store_offsets and _cell_lengths(cell) is None:
        raise ValueError("store_offsets=False requires a diagonal cell")
    xyz = xyz.detach()
    within, cols, valid, offsets = _nearest(xyz, cutoff, cell, k_max,
                                            select_mask)
    n = xyz.shape[-2]
    table = NeighborTable(table=torch.where(valid, cols, n).to(torch.int32),
                          mask=valid,
                          overflow=(within.sum(-1) > k_max).any(),
                          drift=image_drift(xyz, cell))
    if not store_offsets:
        return table
    rows = torch.arange(n, device=xyz.device)[:, None].expand(n, k_max)
    return table._replace(offsets=_edge_offsets(offsets, rows, cols, valid))


def generate_nbr_list(xyz, cutoff, cell, capacity, select_mask=None):
    """Padded (i < j) :class:`NeighborList` of the pairs within
    ``cutoff``, in row-major order, cut or padded (with N) to
    ``capacity``; ``overflow`` flags more pairs than that.  The count
    goes through the host (``torch.nonzero``)."""
    xyz = xyz.detach()
    within, _, offsets = _within(xyz, cutoff, cell, select_mask)
    n = xyz.shape[-2]
    upper = torch.triu(within, diagonal=1)
    pairs = torch.nonzero(upper)[:capacity]
    count = upper.sum()
    idx = torch.full((capacity, 2), n, dtype=torch.int64, device=xyz.device)
    idx[:pairs.shape[0]] = pairs
    mask = idx[:, 0] < n
    safe = idx.clamp(max=n - 1)
    return NeighborList(
        idx=idx.to(torch.int32),
        offsets=_edge_offsets(offsets, safe[:, 0], safe[:, 1], mask),
        mask=mask, count=count, overflow=count > capacity,
        drift=image_drift(xyz, cell))


def generate_nbr_list_topk(xyz, cutoff, cell, k_max, select_mask=None,
                           directed=False):
    """Padded :class:`NeighborList` of capacity N * ``k_max`` from each
    atom's ``k_max`` nearest in-cutoff neighbors; exact unless some atom
    has more (``overflow``).  ``directed=False`` keeps the (i < j) half,
    ``directed=True`` every (receiver, sender) row."""
    xyz = xyz.detach()
    within, cols, valid, offsets = _nearest(xyz, cutoff, cell, k_max,
                                            select_mask)
    n = xyz.shape[-2]
    rows = torch.arange(n, device=xyz.device)[:, None].expand(n, k_max)
    keep = valid if directed else valid & (rows < cols)
    i = torch.where(keep, rows, n).reshape(-1)
    j = torch.where(keep, cols, n).reshape(-1)
    return NeighborList(
        idx=torch.stack([i, j], dim=-1).to(torch.int32),
        offsets=_edge_offsets(offsets, rows, cols, keep).reshape(-1, 3),
        mask=i < n, count=keep.sum(),
        overflow=(within.sum(-1) > k_max).any(),
        drift=image_drift(xyz, cell))


def count_pairs(xyz, cutoff, cell, select_mask=None):
    """Number of (i < j) pairs within ``cutoff``."""
    within, _, _ = _within(torch.as_tensor(xyz), cutoff, cell, select_mask)
    return int(torch.triu(within, diagonal=1).sum())


def estimate_capacity(xyz, cutoff, cell, select_mask=None, slack=1.35,
                      multiple=128):
    """Pair count x slack, rounded up to a multiple of 128."""
    c = count_pairs(xyz, cutoff, cell, select_mask)
    return int(np.ceil(max(c, 1) * slack / multiple) * multiple)


def compute_dis(xyz, nbr_idx, offsets, cell):
    """(P, 1) differentiable distances |xyz[i] - xyz[j] - offsets @ cell|
    of a padded (P, 2) edge list; ``cell`` (3,) lengths or a 3x3 matrix.
    Padded rows (index N) gather a zero sentinel row and take distance 1:
    a safe value BEFORE any potential sees it, since u'(r -> 0) = inf and
    0 * inf = NaN in the force even where the list's mask drops the row."""
    n = xyz.shape[-2]
    ext = torch.cat([xyz, torch.zeros_like(xyz[:1])], dim=-2)
    off_real = (offsets * cell if cell.dim() == 1
                else torch.matmul(offsets, cell))
    i, j = nbr_idx[:, 0].long(), nbr_idx[:, 1].long()
    d = ext[i] - ext[j] - off_real
    dist_sq = torch.where(i < n, (d ** 2).sum(-1),
                          torch.ones_like(d[:, 0]))
    return torch.sqrt(dist_sq)[:, None]


def max_neighbors(xyz, cutoff, cell, select_mask=None):
    """Largest in-cutoff neighbor count of any atom (sizes ``k_max``)."""
    within, _, _ = _within(xyz, cutoff, cell, select_mask)
    return int(within.sum(-1).max())


def _flags(aux, field):
    """Every ``field`` leaf (overflow / drift) of a nested aux."""
    if aux is None or (isinstance(aux, tuple) and len(aux) == 0):
        return []
    if isinstance(aux, dict):
        return [f for a in aux.values() for f in _flags(a, field)]
    if isinstance(aux, (list, tuple)) and not hasattr(aux, "_fields"):
        return [f for a in aux for f in _flags(a, field)]
    flag = getattr(aux, field, None)
    return [] if flag is None else [flag]


def aux_flag(aux, field):
    """Device-side OR of every ``field`` flag in ``aux`` (no host sync),
    or None if it has none."""
    flags = [torch.as_tensor(f).reshape(()) for f in _flags(aux, field)
             if torch.is_tensor(f)]
    if not flags:
        return None
    out = flags[0]
    for f in flags[1:]:
        out = out | f
    return out


def aux_overflow(aux):
    """True if any neighbor structure in ``aux`` overflowed (host sync)."""
    flag = aux_flag(aux, "overflow")
    return False if flag is None else bool(flag)


def aux_drift(aux):
    """True if any neighbor structure in ``aux`` was built from drifted
    positions (host sync)."""
    flag = aux_flag(aux, "drift")
    return False if flag is None else bool(flag)


def get_offsets(vecs, cell_len):
    """Re-wrap offsets of bond vectors for a diagonal cell: -1 where a
    component is at least half the box, +1 where it is below minus half,
    else 0 (multiplied by ``cell_len`` elementwise)."""
    cell_len = torch.as_tensor(cell_len, dtype=vecs.dtype, device=vecs.device)
    return (-(vecs >= 0.5 * cell_len).to(vecs.dtype)
            + (vecs < -0.5 * cell_len).to(vecs.dtype))


def wrap_bond_vectors(vecs, cell_len):
    """Minimum-image bond vectors for a diagonal cell."""
    cell_len = torch.as_tensor(cell_len, dtype=vecs.dtype, device=vecs.device)
    return vecs + get_offsets(vecs, cell_len) * cell_len


def neighbors_per_atom(xyz, cutoff, cell, k_max):
    """(table (N, K) padded with N, valid (N, K), the largest in-cutoff
    neighbor count as a device scalar): each atom's ``k_max`` nearest
    neighbors inside ``cutoff`` (both directions), the angle observables'
    static-shape layout.  ``lax.top_k`` of the negated scores becomes
    ``torch.topk``; equal distances may fall in another order."""
    xyz = xyz.detach()
    d, _ = displacement_matrix(xyz, cell)
    dist_sq = (d ** 2).sum(-1)
    n = xyz.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=xyz.device)
    within = (dist_sq < cutoff ** 2) & ~eye
    score = torch.where(within, dist_sq, torch.full_like(dist_sq, np.inf))
    vals, idx = torch.topk(score, min(k_max, n), dim=-1, largest=False)
    valid = torch.isfinite(vals)
    return torch.where(valid, idx, n), valid, within.sum(-1).max()


def angle_triples(nbr_table, nbr_valid):
    """(idx (N, K, K, 3) of (j, i, k) with the apex i in the middle, mask
    (N, K, K)) of every angle at each atom, counted once (j < k)."""
    n, k = nbr_table.shape
    centers = torch.arange(n, device=nbr_table.device)[:, None, None].expand(
        n, k, k)
    j = nbr_table[:, :, None].expand(n, k, k)
    kk = nbr_table[:, None, :].expand(n, k, k)
    mask = nbr_valid[:, :, None] & nbr_valid[:, None, :] & (j < kk)
    return torch.stack([j, centers, kk], dim=-1), mask
