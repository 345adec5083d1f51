"""Minimum-image Lennard-Jones-family pair energy and forces, the force's
vector-Jacobian product and its parameter sums.

Port of ``mdgrad_tpu/ops/pallas_pair.py``.  Four CUDA kernels
(``csrc/pair.cu``, each with its fixed-order reduction launch), each
beside its plain PyTorch version:

* :func:`lj_energy_forces` (K5) -- ``(E, F)`` with ``E = 1/2 sum u(r_ij)``
  and ``F_i = -sum_j (u'/r) d_ij``; replaces ``lj_energy_forces``
  (``_pair_kernel``).  Its energy has no gradient, as in the JAX package:
  the backward raises.
* :func:`make_lj_force` (K6 forward, K6b backward) -- the differentiable
  force; replaces ``make_lj_force`` (``_force_only_kernel`` and, as the
  backward, ``_force_hvp_kernel``).  The backward is first-order only,
  as the JAX ``custom_vjp`` is: the replay adjoint takes one vjp per step.
* :func:`lj_force_param` (K7) -- the forces with ``dU/dsigma`` and
  ``U/eps``; replaces ``_force_param_kernel``.  No autograd.

``u(r) = 4 eps ((sigma/r)^R - (sigma/r)^A)`` with integer powers R =
``rep_pow`` and A = ``attr_pow``; a pair counts when ``j != i`` and
``r_ij^2 < cutoff^2``; ``d_ij = x_i - x_j`` under the diagonal-cell
minimum image ``d - round(d / L) L``.  ``cell_len`` is a (3,) sequence of
floats (the kernels take it as launch arguments) or, for the plain
versions, a tensor.

What bounds them on an H100: operations -- the minimum image and r^2 of
every i < j pair, the LJ terms of those inside the cutoff; bytes are 12
to 24 per atom.  All four kernels are one walk over each i < j pair in
32 x 32 warp tiles: it gives the pair's term to the row and its negative
to the column, with a minimum image that needs no division
(:func:`image_thresholds`) and r^2 rounded as the plain versions round
it.  K7 takes each pair's scalar terms once, where its plain version
sums half of each over ordered pairs.  Every partial is summed in a fixed
order: no (N, N) tensor, no float atomics, the same bits on every call,
as the replay needs.  The library sizes its own scratch
(``mdg_lj_scratch``).

A wrapper launches its kernel for CUDA tensors (float32, contiguous; any
other dtype raises ``TypeError`` where the JAX package casts) or raises;
it takes the plain version only for CPU tensors.  ``launches`` and
``plain_calls`` count the two paths.
"""

import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import topology
from ..interface import Interaction
from ..system import check_system
from .._device import resolve_device
from . import _build

launches = {"lj_energy_forces": 0, "lj_force": 0, "lj_force_vjp": 0,
            "lj_force_param": 0}
plain_calls = {"lj_energy_forces": 0, "lj_force": 0, "lj_force_vjp": 0,
               "lj_force_param": 0}


# ---------------------------------------------------------------------------
# plain versions (CPU path; the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _ipow(x, p):
    """x^p for an int p >= 0 by repeated squaring, as the kernels and
    JAX's integer_pow compute it."""
    acc = None
    while p > 0:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def _pair_terms(xyz, cell_len, cutoff, sigma, rep_pow, attr_pow):
    """Dense (N, N) terms over ordered pairs: (d, inv_r2, sr^R, sr^A,
    valid as 0/1), with r^2 = 1 at invalid pairs before the powers."""
    n = xyz.shape[0]
    if not torch.is_tensor(cell_len):
        cell_len = torch.tensor(np.asarray(cell_len, dtype=np.float64))
    L = cell_len.to(xyz.device, xyz.dtype)
    d = xyz[:, None, :] - xyz[None, :, :]
    d = d - torch.round(d / L) * L
    r_sq = (d * d).sum(-1)
    cut = torch.tensor(cutoff, dtype=xyz.dtype)   # a CPU scalar: no copy
    valid = (r_sq < cut * cut) & ~torch.eye(n, dtype=torch.bool,
                                           device=xyz.device)
    inv_r2 = 1 / torch.where(valid, r_sq, torch.ones_like(r_sq))
    sr = sigma * torch.sqrt(inv_r2)
    return (d, inv_r2, _ipow(sr, rep_pow), _ipow(sr, attr_pow),
            valid.to(xyz.dtype))


def lj_energy_forces_plain(xyz, cell_len, cutoff, sigma, epsilon, rep_pow=12,
                           attr_pow=6):
    """Plain version of K5: (energy (), forces (N, 3))."""
    plain_calls["lj_energy_forces"] += 1
    d, inv_r2, sr_r, sr_a, vm = _pair_terms(xyz, cell_len, cutoff, sigma,
                                            rep_pow, attr_pow)
    u = 4 * epsilon * (sr_r - sr_a) * vm
    g = 4 * epsilon * (-rep_pow * sr_r + attr_pow * sr_a) * inv_r2 * vm
    return 0.5 * u.sum(), -(g[..., None] * d).sum(1)


def lj_force_plain(xyz, cell_len, cutoff, sigma, epsilon, rep_pow=12,
                   attr_pow=6):
    """Plain version of K6: forces (N, 3)."""
    plain_calls["lj_force"] += 1
    d, inv_r2, sr_r, sr_a, vm = _pair_terms(xyz, cell_len, cutoff, sigma,
                                            rep_pow, attr_pow)
    g = 4 * epsilon * (-rep_pow * sr_r + attr_pow * sr_a) * inv_r2 * vm
    return -(g[..., None] * d).sum(1)


def lj_force_vjp_plain(xyz, w, cell_len, cutoff, sigma, epsilon, rep_pow=12,
                       attr_pow=6):
    """Plain version of K6b: for the cotangent ``w`` (N, 3) of the forces,
    (d(w.F)/dxyz (N, 3), d(w.F)/dsigma (), d(w.F)/deps ())."""
    plain_calls["lj_force_vjp"] += 1
    R, A = rep_pow, attr_pow
    d, inv_r2, sr_r, sr_a, vm = _pair_terms(xyz, cell_len, cutoff, sigma,
                                            R, A)
    g0 = 4 * (-R * sr_r + A * sr_a) * inv_r2 * vm            # g / eps
    g = epsilon * g0
    h = (4 * epsilon * (R * (R + 2) * sr_r - A * (A + 2) * sr_a)
         * inv_r2 * inv_r2 * vm)
    w_ij = w[None, :, :] - w[:, None, :]                     # W_j - W_i
    wd = (w_ij * d).sum(-1)
    out = ((h * wd)[..., None] * d + g[..., None] * w_ij).sum(1)
    dgds = 4 * epsilon * (-R * R * sr_r + A * A * sr_a) * inv_r2 / sigma * vm
    wrd = (w[:, None, :] * d).sum(-1)                        # W_i . d_ij
    return out, -(dgds * wrd).sum(), -(g0 * wrd).sum()


def lj_force_param_plain(xyz, cell_len, cutoff, sigma, epsilon, rep_pow=12,
                         attr_pow=6):
    """Plain version of K7: (forces (N, 3), dU/dsigma (), U/eps ())."""
    plain_calls["lj_force_param"] += 1
    R, A = rep_pow, attr_pow
    d, inv_r2, sr_r, sr_a, vm = _pair_terms(xyz, cell_len, cutoff, sigma,
                                            R, A)
    g = 4 * epsilon * (-R * sr_r + A * sr_a) * inv_r2 * vm
    dsig = 0.5 * (4 * epsilon * (R * sr_r - A * sr_a) / sigma * vm).sum()
    ueps = 0.5 * (4 * (sr_r - sr_a) * vm).sum()
    return -(g[..., None] * d).sum(1), dsig, ueps


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(t, name, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# the kernels' order in mdg_lj_pair's mode argument (csrc/pair.cu)
_MODES = ("lj_energy_forces", "lj_force", "lj_force_vjp", "lj_force_param")
# each kernel's scalar outputs: E; none; d/dsigma, d/deps; dU/dsigma, U/eps
SCALARS = {"lj_energy_forces": 1, "lj_force": 0, "lj_force_vjp": 2,
           "lj_force_param": 2}
# csrc/pair.cu's kForceTile: the block tile of the i < j walk
FORCE_TILE = 64


def lj_scratch(name, n):
    """(partial, block_partial) float counts that ``csrc/pair.cu``'s
    ``mdg_lj_scratch`` gives kernel ``name`` at ``n`` atoms: tiles * n * 3
    and scalars * blocks, the walk running tiles (tiles + 1) / 2 blocks of
    FORCE_TILE.  The wrappers size their buffers from the library; this
    mirror is what the tests and ``chip_smoke.py`` hold the library to."""
    tiles = -(-n // FORCE_TILE)
    return tiles * n * 3, SCALARS[name] * (tiles * (tiles + 1) // 2)


def _scratch(lib, name, n, device):
    """The (partial, block_partial) buffers of kernel ``name`` at ``n``
    atoms, sized by the library (None for an empty one)."""
    mode = _MODES.index(name)
    sizes = [lib.mdg_lj_scratch(mode, n, which) for which in (0, 1)]
    if min(sizes) < 0:
        raise ValueError(f"{name}: no kernel for {n} atoms")
    return [torch.empty(size, device=device, dtype=torch.float32)
            if size else None for size in sizes]


@functools.cache
def image_thresholds(L):
    """(t1, t2) as float32 for the cell length ``L``: with ``s =
    rint(fl32(d / L))``, for ``|d| < t2`` s is 1 from ``d >= t1`` on, -1
    from ``d <= -t1`` on and 0 between.  t1 is the least float32 with
    fl32(t1 / L) > 0.5 (rint takes 0.5 to 0, ties to even), t2 the least
    with fl32(t2 / L) >= 1.5; the division is monotone in d, so a
    nextafter search from 0.5 L and 1.5 L finds them.  K5, K6 and K6b take
    the minimum image from these compares, bit-equal to ``d - rint(d / L)
    L``.
    """
    L = np.float32(L)
    if not (np.isfinite(L) and L > 0):
        raise ValueError(f"cell length must be finite and > 0, got {L}")

    def least(q, above):
        d = np.float32(np.float32(q) * L)
        hit = (lambda d: d / L > q) if above else (lambda d: d / L >= q)
        while hit(d):
            d = np.nextafter(d, np.float32(0))
        while not hit(d):
            d = np.nextafter(d, np.float32(np.inf))
        return float(d)

    return least(0.5, True), least(1.5, False)


def _launch(name, xyz, cell_len, cutoff, sigma, epsilon, rep_pow, attr_pow,
            w=None):
    """Run one of the four kernels: (out_vec (N, 3), out_scalars
    (SCALARS[name],) or None)."""
    dev = xyz.device
    if xyz.dim() != 2:
        raise ValueError(f"{name}: xyz must be (N, 3), got "
                         f"{tuple(xyz.shape)}")
    n = xyz.shape[0]
    _check(xyz, "xyz", dev, (n, 3))
    _check(sigma, "sigma", dev, ())
    _check(epsilon, "epsilon", dev, ())
    if w is not None:
        _check(w, "w", dev, (n, 3))
    if rep_pow < 0 or attr_pow < 0:
        raise ValueError(f"{name}: powers must be >= 0, got ({rep_pow}, "
                         f"{attr_pow})")
    lib = _build.library()
    partial, block_partial = _scratch(lib, name, n, dev)
    out = torch.empty(n, 3, device=dev, dtype=torch.float32)
    scalars = (torch.empty(SCALARS[name], device=dev, dtype=torch.float32)
               if SCALARS[name] else None)
    cell_len = tuple(float(c) for c in cell_len)
    t1, t2 = zip(*map(image_thresholds, cell_len))
    code = lib.mdg_lj_pair(
        _MODES.index(name), xyz.data_ptr(),
        None if w is None else w.data_ptr(), n, *cell_len, *t1, *t2,
        float(cutoff),
        sigma.data_ptr(), epsilon.data_ptr(), int(rep_pow), int(attr_pow),
        partial.data_ptr(),
        None if block_partial is None else block_partial.data_ptr(),
        out.data_ptr(), None if scalars is None else scalars.data_ptr(),
        _build.stream_of(xyz))
    _build.check(code, name)
    launches[name] += 1
    return out, scalars


def _launch_energy_forces(xyz, cell_len, cutoff, sigma, epsilon, rep_pow=12,
                          attr_pow=6):
    out, scalars = _launch("lj_energy_forces", xyz, cell_len, cutoff, sigma,
                           epsilon, rep_pow, attr_pow)
    return scalars[0], out


def _launch_force(xyz, cell_len, cutoff, sigma, epsilon, rep_pow=12,
                  attr_pow=6):
    return _launch("lj_force", xyz, cell_len, cutoff, sigma, epsilon,
                   rep_pow, attr_pow)[0]


def _launch_force_vjp(xyz, w, cell_len, cutoff, sigma, epsilon, rep_pow=12,
                      attr_pow=6):
    out, scalars = _launch("lj_force_vjp", xyz, cell_len, cutoff, sigma,
                           epsilon, rep_pow, attr_pow, w=w)
    return out, scalars[0], scalars[1]


def _launch_force_param(xyz, cell_len, cutoff, sigma, epsilon, rep_pow=12,
                        attr_pow=6):
    out, scalars = _launch("lj_force_param", xyz, cell_len, cutoff, sigma,
                           epsilon, rep_pow, attr_pow)
    return out, scalars[0], scalars[1]


# ---------------------------------------------------------------------------
# autograd Functions and the public wrappers
# ---------------------------------------------------------------------------

# each kernel's launcher and plain version, both (xyz, [w,] cell_len,
# cutoff, sigma, epsilon, rep_pow, attr_pow)
_KERNELS = {
    "lj_energy_forces": (_launch_energy_forces, lj_energy_forces_plain),
    "lj_force": (_launch_force, lj_force_plain),
    "lj_force_vjp": (_launch_force_vjp, lj_force_vjp_plain),
    "lj_force_param": (_launch_force_param, lj_force_param_plain),
}


def _static(cell_len, cutoff, rep_pow, attr_pow):
    """The static part of a pair call as a tuple: (cell lengths (3 floats),
    cutoff, rep_pow, attr_pow)."""
    cell_len = np.asarray(cell_len, dtype=np.float64).reshape(3)
    return (tuple(float(c) for c in cell_len), float(cutoff), int(rep_pow),
            int(attr_pow))


def _run(name, static, xyz, sigma, epsilon, w=None):
    """The kernel ``name`` for CUDA tensors, its plain version for CPU
    tensors."""
    cell_len, cutoff, rep_pow, attr_pow = static
    launch, plain = _KERNELS[name]
    if _build.on_cuda(xyz):
        fn, xyz = launch, xyz.contiguous()
        w = None if w is None else w.contiguous()
    else:
        fn = plain
    vec = (xyz,) if w is None else (xyz, w)
    return fn(*vec, cell_len, cutoff, sigma, epsilon, rep_pow, attr_pow)


class _LJEnergyForces(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, sigma, epsilon, static):
        return _run("lj_energy_forces", static, xyz, sigma, epsilon)

    @staticmethod
    def backward(ctx, *cts):
        raise NotImplementedError(
            "lj_energy_forces has no gradient, as in the JAX package; "
            "differentiate through PallasLJPair.force (make_lj_force), "
            "whose backward is the K6b kernel")


class _LJForce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, sigma, epsilon, static):
        ctx.save_for_backward(xyz, sigma, epsilon)
        ctx.static = static
        return _run("lj_force", static, xyz, sigma, epsilon)

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        xyz, sigma, epsilon = ctx.saved_tensors
        dxyz, dsig, deps = _run("lj_force_vjp", ctx.static, xyz, sigma,
                                epsilon, w=w)
        return dxyz, dsig, deps, None


def _scalar(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def lj_energy_forces(xyz, cell_len, cutoff, sigma, epsilon, rep_pow=12,
                     attr_pow=6):
    """(total energy (), forces (N, 3)) through K5.  Not differentiable:
    its backward raises (use :func:`make_lj_force`)."""
    static = _static(cell_len, cutoff, rep_pow, attr_pow)
    return _LJEnergyForces.apply(xyz, _scalar(sigma, xyz),
                                 _scalar(epsilon, xyz), static)


def make_lj_force(cell_len, cutoff, rep_pow=12, attr_pow=6):
    """Differentiable force ``force(xyz, sigma, eps) -> (N, 3)``: K6
    forward, K6b backward into (xyz, sigma, eps), first order."""
    static = _static(cell_len, cutoff, rep_pow, attr_pow)

    def force(xyz, sigma, epsilon):
        return _LJForce.apply(xyz, _scalar(sigma, xyz),
                              _scalar(epsilon, xyz), static)

    return force


def lj_force_param(xyz, cell_len, cutoff, sigma, epsilon, rep_pow=12,
                   attr_pow=6):
    """(forces (N, 3), dU/dsigma (), U/eps ()) through K7; no autograd."""
    static = _static(cell_len, cutoff, rep_pow, attr_pow)
    with torch.no_grad():
        return _run("lj_force_param", static, xyz, _scalar(sigma, xyz),
                    _scalar(epsilon, xyz))


class PallasLJPair(Interaction):
    """LJ-family pair interaction through the fused pair kernels; the
    counterpart of the JAX ``PallasLJPair``, whose name it keeps.

    ``force(xyz, aux)`` is the differentiable force (K6, K6b backward):
    integrators take it in place of differentiating the energy, so it can
    sit inside MD steps that the replay adjoint differentiates.
    ``energy`` runs K5 (for logging; no gradient).  ``sigma`` and
    ``epsilon`` are ``nn.Parameter``s.  Diagonal cells only.
    """

    def __init__(self, system, cutoff, sigma=1.0, epsilon=1.0, rep_pow=12,
                 attr_pow=6, device="cuda"):
        super().__init__()
        check_system(system)
        device = resolve_device(device)
        cell = np.asarray(system.get_cell(), dtype=np.float64)
        if not topology._is_diagonal(cell):
            raise NotImplementedError("PallasLJPair needs a diagonal "
                                      "(orthorhombic) cell")
        self.static = _static(np.diag(cell), cutoff, rep_pow, attr_pow)
        self.sigma = torch.nn.Parameter(torch.tensor(sigma,
                                                     dtype=torch.float32))
        self.epsilon = torch.nn.Parameter(torch.tensor(epsilon,
                                                       dtype=torch.float32))
        self.to(device)

    def energy(self, xyz, aux):
        return _LJEnergyForces.apply(xyz, self.sigma, self.epsilon,
                                     self.static)[0]

    def force(self, xyz, aux):
        return _LJForce.apply(xyz, self.sigma, self.epsilon,
                             self.static)
