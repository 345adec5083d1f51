"""Soft-histogram RDF counts over one frame or many, and their gradient.

Port of ``mdgrad_tpu/ops/pallas_rdf.py``.  Two CUDA kernels
(``csrc/rdf.cu``, each with its fixed-order reduction pass), each with a
frame axis F >= 1:

* the forward replaces the single-frame ``counts`` (``_fwd_kernel``, K3)
  and the frame-batched ``counts.frames`` (``_fwd_kernel_frames``, K4) and
  returns the counts summed over frames,

      counts[g] = sum_f sum_{i<j, r_ij < cutoff} exp(coeff_g (r_ij - mu_g)^2)

* the backward replaces ``counts_bwd`` (``_bwd_kernel``, K3b) and
  ``counts_frames_bwd`` (``_bwd_kernel_frames``, K4b): given the cotangent
  ``ct`` (G,) it returns per frame

      dxyz[f, i] = sum_{j != i, r_ij < cutoff} w(r_ij) d_ij / r_ij
      w(r) = sum_g ct_g 2 coeff_g (r - mu_g) exp(coeff_g (r - mu_g)^2)

both with the diagonal-cell minimum image ``d - round(d / L) L``.

What bounds them on an H100: the exponentials, on the SFU, and only the
ones that are not zero.  ``exp(coeff_g (r - mu_g)^2)`` is exactly +0 in
float32 once ``|r - mu_g| >= reach_g`` (:func:`reach`, argument -110 where
-103.97 already gives +0), so both kernels take a (pair, bin) term only
inside that window -- ~24 of the water path's 109 bins per pair, ~19 of
the LJ fit's 100 -- and no bit of any sum changes.  Both walk each i < j
pair once, with a division-free minimum image, over tiles whose sites are
taken in a strided order so that no tile pair is much denser than
another; bytes are negligible.  The forward sorts each 64 x 64 tile's
pairs by r^2 (a stable counting sort by warp ballots) so that a warp of 8
bins walks one contiguous run, and splits the bins over more blocks at
small frame counts; the backward gives each pair of a 32 x 32 tile to one
thread, which sums w(r) over the pair's bins (found by binary search where
the windows ascend, every bin where not), and the block sums +-(w / r) d
by rows and columns.  Every partial is summed in a fixed order: no (N, N,
G) tensor, no atomics, deterministic; any number of bins.

The backward is first-order only, as the JAX ``custom_vjp`` is.
"""

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _build
from .pair import image_thresholds

# -coeff reach^2: exp(-110) is +0 in float32 (it is from -103.97 down);
# csrc/rdf.cu's kReachArg, which the library returns from
# mdg_rdf_reach_arg() (held equal by chip_smoke.py and the tests)
REACH_ARG = 110.0

launches = {"rdf_counts": 0, "rdf_counts_bwd": 0}
plain_calls = {"rdf_counts": 0, "rdf_counts_bwd": 0}


def rdf_counts_plain(xyz, cell_len, mu, coeff, cutoff):
    """Plain version: (N, 3) or (F, N, 3) -> (G,) counts summed over
    frames, the same arithmetic as the kernel, one frame at a time."""
    plain_calls["rdf_counts"] += 1
    frames = xyz if xyz.dim() == 3 else xyz[None]
    n = frames.shape[1]
    L = torch.as_tensor(cell_len, dtype=frames.dtype, device=frames.device)
    cut_sq = torch.tensor(cutoff, dtype=frames.dtype) ** 2
    iu = torch.triu_indices(n, n, 1, device=frames.device)
    out = torch.zeros(mu.shape[0], dtype=frames.dtype, device=frames.device)
    for x in frames:
        d = x[iu[1]] - x[iu[0]]
        d = d - torch.round(d / L) * L
        r_sq = (d * d).sum(-1)
        r = torch.sqrt(r_sq[r_sq < cut_sq.to(frames.device)])
        diff = r[:, None] - mu
        out = out + torch.exp(coeff * (diff * diff)).sum(0)
    return out


def rdf_counts_bwd_plain(xyz, cell_len, mu, coeff, cutoff, ct):
    """Plain version of the backward: ``d(ct . counts) / d xyz`` in the
    shape of ``xyz`` ((N, 3) or (F, N, 3)), the same formula as the kernel,
    dense over ordered pairs, one frame at a time."""
    plain_calls["rdf_counts_bwd"] += 1
    frames = xyz if xyz.dim() == 3 else xyz[None]
    n = frames.shape[1]
    L = torch.as_tensor(cell_len, dtype=frames.dtype, device=frames.device)
    cut_sq = torch.tensor(cutoff, dtype=frames.dtype) ** 2
    off_diag = ~torch.eye(n, dtype=torch.bool, device=frames.device)
    out = []
    for x in frames:
        d = x[:, None] - x[None, :]
        d = d - torch.round(d / L) * L
        r_sq = (d * d).sum(-1)
        ii, jj = torch.nonzero((r_sq < cut_sq.to(frames.device)) & off_diag,
                               as_tuple=True)
        r = torch.sqrt(r_sq[ii, jj])
        diff = r[:, None] - mu
        w = (ct * 2 * coeff * diff * torch.exp(coeff * (diff * diff))).sum(1)
        out.append(torch.zeros_like(x).index_add(
            0, ii, (w / r)[:, None] * d[ii, jj]))
    return torch.stack(out).reshape(xyz.shape)


def reach(coeff):
    """Each bin's reach, float32 as the kernels compute it: ``sqrt(110 /
    -coeff)``; for ``|r - mu| >= reach``, ``exp(coeff (r - mu)^2)`` is
    exactly +0 in float32, so the kernels skip the term.  inf (or nan)
    where coeff is not negative: such a bin meets every pair."""
    coeff = torch.as_tensor(coeff, dtype=torch.float32)
    return torch.sqrt(torch.tensor(REACH_ARG, dtype=torch.float32) / -coeff)


def _check_inputs(name, xyz, *params):
    dev = xyz.device
    for t in (xyz, *params):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous float32 "
                             f"on {dev}, got {t.dtype} on {t.device}")
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"{name}: xyz must be (F, N, 3), got "
                         f"{tuple(xyz.shape)}")
    if any(p.shape != params[0].shape or p.dim() != 1 for p in params):
        raise ValueError(f"{name}: bin parameters must share one (G,) shape")


def _cell_args(cell_len):
    """The cell lengths, then each axis's image thresholds t1 and t2."""
    cell_len = tuple(float(c) for c in cell_len)
    t1, t2 = zip(*map(image_thresholds, cell_len))
    return (*cell_len, *t1, *t2)


def _scratch(lib, name, xyz, n_bins, backward):
    f, n, _ = xyz.shape
    size = lib.mdg_rdf_scratch(f, n, n_bins, int(backward))
    if size < 0:
        raise ValueError(f"{name}: no kernel for {f} frames of {n} sites "
                         f"and {n_bins} bins")
    return torch.empty(size, device=xyz.device, dtype=torch.float32)


def _launch(xyz, cell_len, mu, coeff, cutoff):
    _check_inputs("rdf_counts", xyz, mu, coeff)
    f, n, _ = xyz.shape
    g = mu.shape[0]
    lib = _build.library()
    partial = _scratch(lib, "rdf_counts", xyz, g, False)
    out = torch.empty(g, device=xyz.device, dtype=torch.float32)
    code = lib.mdg_rdf_counts(
        xyz.data_ptr(), f, n, *_cell_args(cell_len), float(cutoff),
        mu.data_ptr(), coeff.data_ptr(), g, partial.data_ptr(),
        out.data_ptr(), _build.stream_of(xyz))
    _build.check(code, "rdf_counts")
    launches["rdf_counts"] += 1
    return out


def _launch_bwd(xyz, cell_len, mu, coeff, cutoff, ct):
    """(F, N, 3) gradient of ``ct . counts`` from the K3b/K4b kernel."""
    _check_inputs("rdf_counts_bwd", xyz, mu, coeff, ct)
    f, n, _ = xyz.shape
    g = mu.shape[0]
    lib = _build.library()
    partial = _scratch(lib, "rdf_counts_bwd", xyz, g, True)
    out = torch.empty_like(xyz)
    code = lib.mdg_rdf_counts_bwd(
        xyz.data_ptr(), f, n, *_cell_args(cell_len), float(cutoff),
        mu.data_ptr(), coeff.data_ptr(), ct.data_ptr(), g,
        partial.data_ptr(), out.data_ptr(), _build.stream_of(xyz))
    _build.check(code, "rdf_counts_bwd")
    launches["rdf_counts_bwd"] += 1
    return out


class _RDFCounts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, op):
        ctx.save_for_backward(xyz)
        ctx.op = op
        if _build.on_cuda(xyz):
            frames = xyz if xyz.dim() == 3 else xyz[None]
            return _launch(frames.contiguous(), op.cell_len, op.mu, op.coeff,
                           op.cutoff)
        return rdf_counts_plain(xyz, op.cell_len, op.mu, op.coeff, op.cutoff)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        (xyz,) = ctx.saved_tensors
        op = ctx.op
        if _build.on_cuda(xyz):
            frames = xyz if xyz.dim() == 3 else xyz[None]
            dxyz = _launch_bwd(frames.contiguous(), op.cell_len, op.mu,
                               op.coeff, op.cutoff, ct.contiguous())
            return dxyz.reshape(xyz.shape), None
        return rdf_counts_bwd_plain(xyz, op.cell_len, op.mu, op.coeff,
                                    op.cutoff, ct), None


def _f32(a):
    if torch.is_tensor(a):
        return a.detach().to("cpu", torch.float32)
    return torch.tensor(np.asarray(a), dtype=torch.float32)


class RDFCounts:
    """``counts(xyz (N, 3)) -> (G,)`` and ``counts.frames(xyz (F, N, 3))
    -> (G,)`` summed over frames; the port of ``make_pallas_rdf``.

    cell_len: the (3,) diagonal cell; mu, widths: (G,) bin centres and
    widths; coeff = -1/2 / widths^2 is formed in float32, as on the TPU.
    """

    def __init__(self, cell_len, mu, widths, cutoff, device):
        self.cell_len = tuple(float(c) for c in cell_len)
        self.mu = _f32(mu).to(device)
        self.coeff = (-0.5 / _f32(widths) ** 2).to(device)
        self.cutoff = float(cutoff)

    def __call__(self, xyz):
        if xyz.dim() != 2:
            raise ValueError("counts takes one (N, 3) frame; use .frames")
        return _RDFCounts.apply(xyz, self)

    def frames(self, xyzs):
        if xyzs.dim() != 3:
            raise ValueError("counts.frames takes (F, N, 3)")
        return _RDFCounts.apply(xyzs, self)

