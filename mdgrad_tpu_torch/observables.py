"""The soft-histogram RDF, the velocity autocorrelation, and the angle and
dihedral observables (port of ``mdgrad_tpu/observables.py``:
``generate_vol_bins``, ``rdf``, ``vacf``, ``compute_angle``,
``angle_distribution``, ``Angles``, ``compute_dihe``,
``signed_dihedrals``, ``chain_quads`` and ``dihedral_distribution``).

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


def compute_angle(xyz, angle_list, cell, N):
    """cos(theta) of (frame, j, i, k) angle triples, the apex the middle
    index, bond vectors minimum-imaged in the diagonal ``cell``."""
    xyz = xyz.reshape(-1, N, 3)
    cell = torch.as_tensor(cell, dtype=xyz.dtype, device=xyz.device)
    cell_len = torch.diagonal(cell) if cell.dim() == 2 else cell
    a = torch.as_tensor(angle_list, device=xyz.device).long()
    v1 = xyz[a[:, 0], a[:, 1]] - xyz[a[:, 0], a[:, 2]]
    v2 = xyz[a[:, 0], a[:, 3]] - xyz[a[:, 0], a[:, 2]]
    v1 = topology.wrap_bond_vectors(v1, cell_len)
    v2 = topology.wrap_bond_vectors(v2, cell_len)
    dot = (v1 * v2).sum(-1)
    return dot / torch.sqrt((v1 ** 2).sum(-1) * (v2 ** 2).sum(-1))


class angle_distribution:
    """Soft histogram of the bond angles at every atom between pairs of
    its neighbors inside ``cutoff`` (each atom's ``k_max`` nearest, as
    ``topology.neighbors_per_atom``).  Call with xyz (N, 3) or (F, N, 3);
    returns (bins, normalized counts, (angles (F, N, K, K), mask,
    overflow)) -- ``overflow`` (a device bool) when some atom had more
    than ``k_max`` neighbors, whose triples were then dropped.
    Differentiable in xyz.  The frames run one after another (the JAX
    package ``vmap``s them)."""

    def __init__(self, system, nbins, angle_range, cutoff=3.0, width=None,
                 k_max=16, device="cuda"):
        check_system(system)
        device = resolve_device(device)
        start, end = angle_range
        self.bins = torch.tensor(np.linspace(start, end, nbins + 1),
                                 dtype=torch.float32, device=device)
        self.smear = GaussianSmearing(start=start, stop=end,
                                      n_gaussians=nbins, width=width,
                                      device=device)
        self.cutoff = cutoff
        self.natoms = system.get_number_of_atoms()
        self.k_max = k_max
        cell = np.diag(np.asarray(system.get_cell(), dtype=np.float64))
        self.cell_len = torch.tensor(cell, dtype=torch.float32, device=device)
        self.cell_len_f64 = torch.tensor(cell, dtype=torch.float64,
                                         device=device)

    def _frame_angles(self, xyz, cell_len):
        table, valid, max_count = topology.neighbors_per_atom(
            xyz, self.cutoff, cell_len, self.k_max)
        triples, mask = topology.angle_triples(table, valid)
        ext = torch.cat([xyz, torch.zeros_like(xyz[:1])], dim=0)
        j, i, k = triples[..., 0], triples[..., 1], triples[..., 2]
        v1 = topology.wrap_bond_vectors(ext[j] - ext[i], cell_len)
        v2 = topology.wrap_bond_vectors(ext[k] - ext[i], cell_len)
        dot = (v1 * v2).sum(-1)
        norm = torch.sqrt((v1 ** 2).sum(-1) * (v2 ** 2).sum(-1) + 1e-20)
        angles = torch.arccos(torch.clamp(dot / norm, -0.999999, 0.999999))
        counts = (self.smear(angles[..., None])
                  * mask[..., None]).sum((0, 1, 2))
        return counts, angles, mask, max_count > self.k_max

    def __call__(self, xyz):
        xyz = xyz.reshape(-1, self.natoms, 3)
        cell_len = (self.cell_len_f64 if xyz.dtype == torch.float64
                    else self.cell_len)
        out = [self._frame_angles(x, cell_len) for x in xyz]
        count = sum(o[0] for o in out)
        count = count / count.sum()
        angles = torch.stack([o[1] for o in out])
        mask = torch.stack([o[2] for o in out])
        overflow = torch.stack([o[3] for o in out]).any()
        return self.bins, count, (angles, mask, overflow)


class Angles:
    """Raw cos(angle) and its mask over the triples
    :class:`angle_distribution` detects."""

    def __init__(self, system, nbins=None, angle_range=None, cutoff=3.0,
                 k_max=16, device="cuda"):
        self._dist = angle_distribution(
            system, nbins or 64, angle_range or (0.5, np.pi), cutoff=cutoff,
            k_max=k_max, device=device)

    def __call__(self, xyz):
        _, _, (angles, mask, _) = self._dist(xyz)
        return torch.cos(angles), mask


def _quad_vectors(xyz, quads):
    q = torch.as_tensor(quads, device=xyz.device).long()
    return (xyz[..., q[:, 0], :], xyz[..., q[:, 1], :], xyz[..., q[:, 2], :],
            xyz[..., q[:, 3], :])


def compute_dihe(xyz, dihes):
    """cos(phi) of the dihedrals ``dihes`` (Q, 4) over (F, N, 3) frames."""
    a, b, c, d = _quad_vectors(xyz, dihes)
    cross1 = torch.linalg.cross(a - b, c - b, dim=-1)
    cross2 = torch.linalg.cross(b - c, d - c, dim=-1)
    norm = torch.sqrt((cross1 ** 2).sum(-1) * (cross2 ** 2).sum(-1) + 1e-20)
    return (cross1 * cross2).sum(-1) / norm


def signed_dihedrals(xyz, quads):
    """Signed dihedral angles in (-pi, pi] of (a, b, c, d) quads: with b1 =
    b - a, b2 = c - b, b3 = d - c, n1 = b1 x b2, n2 = b2 x b3, phi =
    atan2(-(n1 x n2) . b2 / |b2|, n1 . n2) (the sign of the folding
    workload's chain dihedrals)."""
    a, b, c, d = _quad_vectors(xyz, quads)
    b1, b2, b3 = b - a, c - b, d - c
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    b2n = b2 / torch.sqrt((b2 ** 2).sum(-1, keepdim=True) + 1e-20)
    y = -(torch.linalg.cross(n1, n2, dim=-1) * b2n).sum(-1)
    return torch.atan2(y, (n1 * n2).sum(-1))


def chain_quads(n_atoms):
    """Consecutive (i, i+1, i+2, i+3) quads of a linear chain, numpy."""
    i = np.arange(n_atoms - 3)
    return np.stack([i, i + 1, i + 2, i + 3], axis=-1)


class dihedral_distribution:
    """Soft histogram of signed dihedral angles over fixed quads (default
    every consecutive quad of a chain); call with (N, 3) or (F, N, 3),
    returns (bins, normalized counts, phi (F, Q)), differentiable in
    xyz."""

    def __init__(self, n_atoms, nbins=64, angle_range=(-np.pi, np.pi),
                 quads=None, width=None, device="cuda"):
        device = resolve_device(device)
        start, end = angle_range
        self.n_atoms = int(n_atoms)
        self.bins = torch.tensor(np.linspace(start, end, nbins + 1),
                                 dtype=torch.float32, device=device)
        self.smear = GaussianSmearing(start=start, stop=end,
                                      n_gaussians=nbins, width=width,
                                      device=device)
        self.quads = torch.as_tensor(
            chain_quads(n_atoms) if quads is None else np.asarray(quads),
            device=device)

    def __call__(self, xyz):
        xyz = xyz.reshape(-1, self.n_atoms, 3)
        phi = signed_dihedrals(xyz, self.quads)
        counts = self.smear(phi[..., None]).sum((0, 1))
        return self.bins, counts / counts.sum(), phi
