"""The soft-histogram RDF and the velocity autocorrelation (port of
``mdgrad_tpu/observables.py``: ``generate_vol_bins``, ``rdf`` and
``vacf``).

``backend='pallas'`` counts pairs with the K3/K4 kernel of ``ops/rdf.py``
and differentiates through its K3b/K4b backward kernel (their plain
versions for CPU tensors); ``backend='xla'`` is the JAX package's dense
(N, N, G) evaluation in plain PyTorch, differentiated by autograd.
"""

import numpy as np
import torch

from . import topology
from ._device import resolve_device
from .nn.layers import GaussianSmearing
from .ops.rdf import RDFCounts
from .system import check_system


def generate_vol_bins(start, end, nbins, dim):
    """(V, shell volumes (nbins,), bin edges (nbins + 1,)) as float64
    numpy."""
    bins = np.linspace(start, end, nbins + 1)
    if dim == 3:
        vol_bins = 4 * np.pi / 3 * (bins[1:] ** 3 - bins[:-1] ** 3)
        V = (4 / 3) * np.pi * end ** 3
    elif dim == 2:
        vol_bins = np.pi * (bins[1:] ** 2 - bins[:-1] ** 2)
        V = np.pi * end ** 2
    else:
        raise ValueError("dim must be 2 or 3")
    return V, vol_bins, bins


class rdf:
    """Soft-histogram radial distribution function.  Call with xyz of
    shape (N, 3) or (F, N, 3); returns (count, bins, g_r)."""

    def __init__(self, system, nbins, r_range, index_tuple=None, width=None,
                 backend="xla", device="cuda"):
        check_system(system)
        device = resolve_device(device)
        if backend not in ("xla", "pallas"):
            raise ValueError(f"backend {backend!r} not in ('xla', 'pallas')")
        start, end = r_range
        self.V, vol_bins, bins = generate_vol_bins(start, end, nbins,
                                                   dim=system.dim)
        # float32, as the JAX package keeps them, and exact for float64 runs
        self.vol_bins = torch.tensor(vol_bins, dtype=torch.float32,
                                     device=device)
        self.vol_bins_f64 = torch.tensor(vol_bins, dtype=torch.float64,
                                         device=device)
        self.bins = torch.tensor(bins, dtype=torch.float32, device=device)
        self.smear = GaussianSmearing(start=start,
                                      stop=float(self.bins[-1]),
                                      n_gaussians=nbins, width=width,
                                      device=device)
        self.nbins = nbins
        self.cutoff_boundary = end + 0.5
        cell = np.asarray(system.get_cell(), dtype=np.float64)
        if topology._is_diagonal(cell):
            cell = np.diag(cell)
        self.cell = torch.tensor(cell, dtype=torch.float32, device=device)
        self.cell_f64 = torch.tensor(cell, dtype=torch.float64, device=device)
        mask = topology.pair_index_mask(system.get_number_of_atoms(),
                                        index_tuple, None)
        self.select_mask = None if mask is None else mask.to(device)
        self.r_axis = np.linspace(start, end, nbins)
        self.backend = backend
        if backend == "pallas":
            if index_tuple is not None:
                raise ValueError("pallas rdf backend does not support "
                                 "index_tuple")
            if self.cell.dim() != 1:
                raise ValueError("pallas rdf backend needs a diagonal cell")
            self._counts = RDFCounts(
                cell, self.smear.offsets, self.smear.widths,
                self.cutoff_boundary, device)

    def _frame_counts(self, xyz):
        cell = self.cell_f64 if xyz.dtype == torch.float64 else self.cell
        dist, valid = topology.distance_matrix(xyz, cell)
        mask = valid & torch.triu(torch.ones_like(valid), diagonal=1)
        mask = mask & (dist < self.cutoff_boundary)
        if self.select_mask is not None:
            mask = mask & self.select_mask
        g = self.smear(dist[..., None])
        return (g * mask[..., None]).sum((0, 1))

    def __call__(self, xyz):
        if self.backend == "pallas":
            count = (self._counts(xyz) if xyz.dim() == 2
                     else self._counts.frames(xyz))
        elif xyz.dim() == 2:
            count = self._frame_counts(xyz)
        else:
            count = sum(self._frame_counts(x) for x in xyz)
        count = count / count.sum()
        vol_bins = (self.vol_bins_f64 if count.dtype == torch.float64
                    else self.vol_bins)
        g_r = count / (vol_bins / self.V)
        return count, self.bins, g_r


class vacf:
    """Velocity autocorrelation over lags 0 .. ``t_range`` - 1 of a
    (T, N, 3) velocity trajectory: C(t) = mean over the T - t frame pairs
    (i, i + t) of v_i . v_{i+t} / (3N), differentiable.

    One (T, T) gram product over the flattened N x 3 axis in full f32
    (TF32 is off: the correlation's tail decays to ~1e-3 of C(0)), then a
    gather of its first ``t_range`` superdiagonals, as the JAX package.
    """

    def __init__(self, system, t_range):
        check_system(system)
        self.t_range = t_range

    def __call__(self, vel):
        T, tr = vel.shape[0], self.t_range
        S = vel.reshape(T, -1)
        gram = torch.matmul(S, S.T)
        padded = torch.nn.functional.pad(gram, (0, tr))
        rows = torch.arange(T, device=vel.device)[:, None]
        cols = rows + torch.arange(tr, device=vel.device)[None, :]
        band = padded[rows, cols]                       # (T, t_range)
        valid = cols < T
        denom = valid.sum(0) * S.shape[1]
        return (band * valid).sum(0) / denom
