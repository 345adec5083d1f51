"""Soft-histogram RDF counts over one frame or many.

Port of ``mdgrad_tpu/ops/pallas_rdf.py`` (forward only).  One CUDA kernel
(``csrc/rdf.cu``, with its tile-reduction pass) replaces both the
single-frame ``counts`` (``_fwd_kernel``, K3) and the frame-batched
``counts.frames`` (``_fwd_kernel_frames``, K4): it takes a frame axis
F >= 1 and returns the counts summed over frames,

    counts[g] = sum_f sum_{i<j, r_ij < cutoff} exp(coeff_g (r_ij - mu_g)^2)

with the diagonal-cell minimum image ``d - round(d / L) L``.

What bounds it on an H100: the exponentials, one per (pair inside the
cutoff, bin); bytes are negligible.  The kernel compacts the pairs inside
the cutoff of each 64 x 64 tile before the bin loop, so no exponential is
spent outside the cutoff, keeps one bin per thread in a register, and
sums the per-tile partials in a fixed order: no (N, N, G) tensor, no
atomics, deterministic.

The backward kernels (``_bwd_kernel``, ``_bwd_kernel_frames``) come with
the training slice: until then the autograd Function raises in backward,
on every device, rather than fall back to a plain version.
"""

import numpy as np
import torch

from . import _build

launches = {"rdf_counts": 0}
plain_calls = {"rdf_counts": 0}

_BACKWARD_MSG = (
    "rdf counts backward is not ported yet: the RDF backward kernels "
    "(pallas_rdf _bwd_kernel / _bwd_kernel_frames) come with the training "
    "slice (replay adjoint, force grad-of-grad, RDF backward)")


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


def _launch(xyz, cell_len, mu, coeff, cutoff):
    dev = xyz.device
    for t, name, dt in ((xyz, "xyz", torch.float32), (mu, "mu", torch.float32),
                        (coeff, "coeff", torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"rdf_counts: {name} must be contiguous {dt} "
                             f"on {dev}, got {t.dtype} on {t.device}")
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"rdf_counts: xyz must be (F, N, 3), got "
                         f"{tuple(xyz.shape)}")
    f, n, _ = xyz.shape
    g = mu.shape[0]
    if not 1 <= g <= 1024 or coeff.shape != mu.shape:
        raise ValueError(f"rdf_counts: {g} bins (1..1024 supported)")
    lib = _build.library()
    tiles = -(-n // lib.mdg_rdf_tile())
    partial = torch.empty(g * f * tiles * tiles, device=dev,
                          dtype=torch.float32)
    out = torch.empty(g, device=dev, dtype=torch.float32)
    lx, ly, lz = (float(c) for c in cell_len)
    code = lib.mdg_rdf_counts(
        xyz.data_ptr(), f, n, lx, ly, lz, float(cutoff), mu.data_ptr(),
        coeff.data_ptr(), g, partial.data_ptr(), out.data_ptr(),
        _build.stream_of(xyz))
    _build.check(code, "rdf_counts")
    launches["rdf_counts"] += 1
    return out


class _RDFCounts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, op):
        if xyz.is_cuda:
            frames = xyz if xyz.dim() == 3 else xyz[None]
            return _launch(frames.contiguous(), op.cell_len, op.mu, op.coeff,
                           op.cutoff)
        if xyz.device.type != "cpu":
            raise ValueError(f"no kernel or plain version for {xyz.device}")
        return rdf_counts_plain(xyz, op.cell_len, op.mu, op.coeff, op.cutoff)

    @staticmethod
    def backward(ctx, ct):
        raise NotImplementedError(_BACKWARD_MSG)


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

