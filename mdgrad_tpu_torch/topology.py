"""Periodic-boundary geometry and the (N, K) neighbor table.

Port of the parts of ``mdgrad_tpu/topology.py`` that the sampling slice
runs: minimum image, dense distance matrices, pair selection masks, the
per-atom neighbor table with its overflow and drift flags, and the
capacity estimate.  ``lax.approx_min_k`` becomes ``torch.topk`` on the
masked distance scores; the table keeps the JAX package's padding
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
    """
    table: torch.Tensor
    mask: torch.Tensor
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
    d, _ = displacement_matrix(xyz, cell)
    dist_sq = (d ** 2).sum(-1)
    n = xyz.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=xyz.device)
    within = (dist_sq < cutoff ** 2) & ~eye
    if select_mask is not None:
        within = within & select_mask.to(xyz.device)
    return within, dist_sq


def generate_neighbor_table(xyz, cutoff, cell, k_max, select_mask=None):
    """(N, K) table of each atom's ``k_max`` nearest neighbors inside
    ``cutoff``, padded with N; ``overflow`` flags an atom with more.

    Diagonal cells only, and no per-edge offsets are stored (the JAX
    package's ``store_offsets=False``): the consumer recomputes the
    minimum image from gathered positions.
    """
    if _cell_lengths(cell) is None:
        raise ValueError("the neighbor table needs a diagonal cell")
    xyz = xyz.detach()
    within, dist_sq = _within(xyz, cutoff, cell, select_mask)
    n = xyz.shape[-2]
    score = torch.where(within, dist_sq, torch.full_like(dist_sq, np.inf))
    vals, cols = torch.topk(score, k_max, dim=-1, largest=False)
    valid = vals < np.inf
    return NeighborTable(table=torch.where(valid, cols, n).to(torch.int32),
                         mask=valid,
                         overflow=(within.sum(-1) > k_max).any(),
                         drift=image_drift(xyz, cell))


def count_pairs(xyz, cutoff, cell, select_mask=None):
    """Number of (i < j) pairs within ``cutoff``."""
    within, _ = _within(torch.as_tensor(xyz), cutoff, cell, select_mask)
    return int(torch.triu(within, diagonal=1).sum())


def estimate_capacity(xyz, cutoff, cell, select_mask=None, slack=1.35,
                      multiple=128):
    """Pair count x slack, rounded up to a multiple of 128."""
    c = count_pairs(xyz, cutoff, cell, select_mask)
    return int(np.ceil(max(c, 1) * slack / multiple) * multiple)


def max_neighbors(xyz, cutoff, cell, select_mask=None):
    """Largest in-cutoff neighbor count of any atom (sizes ``k_max``)."""
    within, _ = _within(xyz, cutoff, cell, select_mask)
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
