"""Ewald summation for long-range electrostatics (port of
``mdgrad_tpu/ops/ewald.py``).

    U = U_real + U_recip + U_self + U_background (+ the exclusion term)

Every term is differentiable in positions, charges and the cell, a (3,)
diagonal one (its lengths) or a (3, 3) triclinic one (rows the lattice
vectors), so the energy composes with the barostats.  The JAX module is
plain ``jnp`` with no Pallas kernel, and so is this one plain PyTorch:
the reciprocal sum is one (N, 3) x (3, Nk) phase product, cos and sin, and
reductions; the real sum the dense masked minimum-image erfc sum, or the
same over an (N, K) neighbor table.

Precision: the phase ``2 pi frac . n`` reaches ``2 pi n_max`` (~44 on the
molten-salt box), so its inputs must stay in full f32.  The JAX package
runs these products at ``precision=HIGHEST``; here TF32 is off
(``_device.resolve_device``, which every Ewald entry point goes
through).  Fractional coordinates are wrapped to [0, 1) before the phase
product; the wrap is taken from detached values, so it is piecewise
constant and leaves gradients exact.  A diagonal cell is turned into its
3 x 3 matrix, as the JAX package's ``_as_matrix``, and inverted with the
triclinic one.

Units: charges in e, lengths in Angstrom, energies in eV; ``COULOMB`` is
k_e = 14.399645 eV Angstrom / e^2 (CODATA 2014, as ASE).
"""

import math

import numpy as np
import torch

from .. import topology

# k_e = 1/(4 pi eps0) in eV * Angstrom / e^2 (CODATA 2014, ASE-compatible)
COULOMB = 14.399645478425668


def ewald_params(r_cut, accuracy=3.2):
    """(alpha, k_cut) from a real-space cutoff: alpha = s / r_cut and k_cut
    = 2 alpha s, so that both truncation errors are ~erfc(s) (erfc(3.2) ~
    6e-6) for ``accuracy`` s."""
    alpha = accuracy / r_cut
    k_cut = 2.0 * alpha * accuracy
    return alpha, k_cut


def build_kvectors(cell, k_cut):
    """(Nk, 3) float32 integer triples n of the half space (first nonzero
    component positive) with 0 < |k(n)| <= k_cut, k(n) = 2 pi n inv(cell)^T,
    in the JAX package's order.  Built once on the host in float64."""
    cell = np.asarray(cell, dtype=np.float64)
    cell = np.diag(cell) if cell.ndim == 1 else cell
    recip_t = 2 * np.pi * np.linalg.inv(cell).T
    a_norm = np.linalg.norm(cell, axis=1)
    nmax = np.maximum(1, np.ceil(k_cut * a_norm / (2 * np.pi)).astype(int))
    rng = [np.arange(-m, m + 1) for m in nmax]
    n = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, 3)
    k2 = ((n @ recip_t) ** 2).sum(-1)
    keep = (k2 > 0) & (k2 <= k_cut ** 2)
    first = np.where(n[:, 0] != 0, n[:, 0],
                     np.where(n[:, 1] != 0, n[:, 1], n[:, 2]))
    keep &= first > 0
    return torch.from_numpy(n[keep].astype(np.float32))


def _as_matrix(cell):
    return torch.diag(cell) if cell.dim() == 1 else cell


def _inv_volume(cell):
    """(the inverse cell matrix, the volume), through ``inv_ex`` (no host
    check) and ``det``."""
    cm = _as_matrix(cell)
    return torch.linalg.inv_ex(cm)[0], torch.abs(torch.linalg.det(cm))


def reciprocal_energy(q, xyz, cell, nvecs, alpha):
    """U_recip = k_e (4 pi / V) sum over the half space of exp(-k^2 / 4
    alpha^2) / k^2 |S(k)|^2, S(k) = sum_j q_j exp(i k . r_j)."""
    inv, V = _inv_volume(cell)
    nvecs = nvecs.to(xyz.dtype)
    frac = torch.matmul(xyz, inv)
    frac = frac - torch.floor(frac.detach())
    phase = 2 * math.pi * torch.matmul(frac, nvecs.T)
    re = (q[:, None] * torch.cos(phase)).sum(0)           # (Nk,)
    im = (q[:, None] * torch.sin(phase)).sum(0)
    k = 2 * math.pi * torch.matmul(nvecs, inv.T)
    k2 = (k ** 2).sum(-1)
    coeff = torch.exp(-k2 / (4 * alpha ** 2)) / k2
    return COULOMB * (4 * math.pi / V) * (coeff * (re ** 2 + im ** 2)).sum()


def real_energy(q, xyz, cell, alpha, r_cut, extra_mask=None):
    """Dense masked erfc-screened pair sum (minimum image) over i < j
    within ``r_cut``; masked pairs take distance 1, so neither erfc nor
    1/r sees a zero."""
    dist, valid = topology.distance_matrix(xyz, cell)
    mask = valid & torch.triu(torch.ones_like(valid), diagonal=1)
    mask = mask & (dist < r_cut)
    if extra_mask is not None:
        mask = mask & extra_mask
    qq = q[:, None] * q[None, :]
    safe = torch.where(mask, dist, torch.ones_like(dist))
    u = COULOMB * qq * torch.special.erfc(alpha * safe) / safe
    return torch.where(mask, u, torch.zeros_like(u)).sum()


def real_energy_table(q, xyz, cell, alpha, r_cut, nbrs):
    """The erfc-screened pair sum over an (N, K) neighbor table (diagonal
    cells; the image offset detached): every pair lies in both atoms'
    rows, so 0.5 of the sum.  Exclusions are the table's own (its
    ``select_mask`` at build time)."""
    cl = torch.diagonal(cell) if cell.dim() == 2 else cell
    table = nbrs.table.long()
    ext = torch.cat([xyz, torch.zeros_like(xyz[:1])])
    d_raw = xyz[:, None, :] - ext[table]
    with torch.no_grad():
        off = (-(d_raw > 0.5 * cl).to(d_raw.dtype)
               + (d_raw < -0.5 * cl).to(d_raw.dtype))
    d = d_raw + off * cl
    dist_sq = (d ** 2).sum(-1)
    mask = nbrs.mask & (dist_sq < r_cut ** 2)
    safe = torch.sqrt(torch.where(mask, dist_sq, torch.ones_like(dist_sq)))
    q_ext = torch.cat([q, torch.zeros_like(q[:1])])
    qq = q[:, None] * q_ext[table]
    u = COULOMB * qq * torch.special.erfc(alpha * safe) / safe
    return 0.5 * torch.where(mask, u, torch.zeros_like(u)).sum()


def self_energy(q, alpha):
    return -COULOMB * alpha / math.sqrt(math.pi) * (q ** 2).sum()


def background_energy(q, cell, alpha):
    """The neutralizing-background term (the omitted k = 0 term): keeps U
    independent of alpha for a net-charged cell."""
    _, V = _inv_volume(cell)
    return -COULOMB * math.pi / (2 * V * alpha ** 2) * q.sum() ** 2


def exclusion_correction(q, xyz, cell, alpha, pairs):
    """Minus the reciprocal sum's erf(alpha r) / r share of each excluded
    pair (``pairs`` (P, 2)); diagonal cells (the bond re-wrap is
    elementwise)."""
    cl = torch.diagonal(cell) if cell.dim() == 2 else cell
    vec = xyz[pairs[:, 0]] - xyz[pairs[:, 1]]
    vec = topology.wrap_bond_vectors(vec, cl)
    r = torch.sqrt((vec ** 2).sum(-1))
    qq = q[pairs[:, 0]] * q[pairs[:, 1]]
    return -(COULOMB * qq * torch.special.erf(alpha * r) / r).sum()


def ewald_energy(q, xyz, cell, nvecs, alpha, r_cut, extra_mask=None,
                 ex_pairs=None, nbrs=None):
    """Total Ewald energy (eV).  ``cell`` is (3,) diagonal lengths or a
    (3, 3) matrix.  ``nbrs`` (an (N, K) ``NeighborTable``) switches the
    real-space term to the table, whose exclusions were applied at build
    time (``extra_mask`` is then not used for the real term)."""
    cell = torch.as_tensor(cell, dtype=xyz.dtype, device=xyz.device)
    if nbrs is not None:
        u_real = real_energy_table(q, xyz, cell, alpha, r_cut, nbrs)
    else:
        u_real = real_energy(q, xyz, cell, alpha, r_cut, extra_mask)
    u = (u_real
         + reciprocal_energy(q, xyz, cell, nvecs, alpha)
         + self_energy(q, alpha)
         + background_energy(q, cell, alpha))
    if ex_pairs is not None:
        u = u + exclusion_correction(q, xyz, cell, alpha, ex_pairs)
    return u
