"""SchNet continuous-filter GNN over an (N, K) neighbor table.

Port of the table path of ``mdgrad_tpu/nn/schnet.py`` (``SchNetConv``,
``_SchNetModule``, ``SchNet``).  Parameter layout follows ``nn.Linear``;
``nn/convert.py`` carries the JAX package's flax parameters across.

Three details match the JAX code exactly: the diagonal-cell elementwise
minimum image with a detached offset, ``e = sqrt(sum d^2 + 1e-20)``, and
the sentinel remap ``idx_m = where(mask, idx, N)`` that the aggregation
kernel reads.

``gather_mode`` maps onto this port as follows.  ``'auto'``, ``'onehot'``
and ``'pallas'`` (the TPU's one-hot MXU aggregation and its Pallas
kernel) all run the fused aggregation of ``ops/gather.py``: the K1 CUDA
kernel for CUDA tensors, its plain version for CPU tensors.  ``'gather'``
(the JAX package's plain indexed aggregation) calls that plain version,
``gather_mul_reduce_plain``, directly on any device, differentiated by
autograd; it launches no kernel.

``compute_dtype`` 'float32' only: the arithmetic runs in the parameters'
dtype (float32, or float64 after ``.double()`` in tests).  bf16 and
'mixed' come with a later slice.
"""

import math

import numpy as np
import torch
from torch import nn

from ..ops.gather import (TableIndex, gather_mul_reduce,
                          gather_mul_reduce_plain)
from .layers import gaussian_smearing, shifted_softplus

GATHER_MODES = ("auto", "onehot", "pallas", "gather")


def _dense(n_in, n_out, generator):
    """nn.Linear with the flax Dense default init (LeCun truncated normal
    kernel, zero bias), drawn from ``generator``."""
    layer = nn.Linear(n_in, n_out)
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


class SchNetConv(nn.Module):
    """One continuous-filter convolution over the (N, K) table.

    Submodules, in the order of the flax ``Dense_0 .. Dense_4``:
    ``filter_in`` (G -> G), ``filter_out`` (G -> F) on the edge side,
    ``node_filter`` (n_atom_basis -> F), ``update_in`` (F -> n_atom_basis),
    ``update_out`` (n_atom_basis -> n_atom_basis).
    """

    def __init__(self, n_atom_basis, n_filters, n_gaussians, cutoff,
                 generator):
        super().__init__()
        offsets = np.linspace(0.0, cutoff, n_gaussians)
        self.register_buffer(
            "offsets", torch.tensor(offsets, dtype=torch.float32),
            persistent=False)
        self.register_buffer(
            "widths", torch.full((n_gaussians,), offsets[1] - offsets[0],
                                 dtype=torch.float32), persistent=False)
        self.filter_in = _dense(n_gaussians, n_gaussians, generator)
        self.filter_out = _dense(n_gaussians, n_filters, generator)
        self.node_filter = _dense(n_atom_basis, n_filters, generator)
        self.update_in = _dense(n_filters, n_atom_basis, generator)
        self.update_out = _dense(n_atom_basis, n_atom_basis, generator)

    def forward(self, r, e, mask, index, plain):
        """r (N, n_atom_basis), e (N, K, 1), mask (N, K); ``index`` is the
        sentinel-remapped TableIndex; ``plain`` calls the plain version of
        the aggregation instead of its autograd wrapper."""
        ef = gaussian_smearing(e, self.offsets, self.widths)
        ef = self.filter_out(shifted_softplus(self.filter_in(ef)))
        rf = self.node_filter(r)
        n, k = mask.shape
        w = (ef * mask[..., None].to(ef.dtype)).reshape(n * k, -1)
        if plain:
            agg = gather_mul_reduce_plain(rf, w, index.idx, k)
        else:
            agg = gather_mul_reduce(rf, w, index, k)
        return self.update_out(shifted_softplus(self.update_in(agg)))


class _Readout(nn.Module):
    """Atomwise head: Dense(n -> n/2), shifted softplus, Dense(n/2 -> 1)."""

    def __init__(self, n_atom_basis, generator):
        super().__init__()
        self.d0 = _dense(n_atom_basis, n_atom_basis // 2, generator)
        self.d1 = _dense(n_atom_basis // 2, 1, generator)

    def forward(self, r):
        return self.d1(shifted_softplus(self.d0(r))).squeeze(-1)


class SchNet(nn.Module):
    """SchNet force field; ``modelparams`` is the JAX package's dict
    (n_atom_basis, n_filters, n_gaussians, n_convolutions, cutoff,
    gather_mode, compute_dtype, readout_keys).

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (the same weights on every device); the interaction that holds the
    model moves it to its device.
    """

    def __init__(self, modelparams, seed=0):
        super().__init__()
        if modelparams.get("trainable_gauss", False):
            raise NotImplementedError("trainable_gauss comes with a later "
                                      "slice of the port")
        cdt = modelparams.get("compute_dtype", "float32")
        if cdt not in ("float32", "f32"):
            raise NotImplementedError(
                f"compute_dtype {cdt!r}: only 'float32' is ported; bf16 and "
                "'mixed' come with a later slice")
        gather_mode = modelparams.get("gather_mode", "auto")
        if gather_mode not in GATHER_MODES:
            raise ValueError(f"gather_mode {gather_mode!r} not in "
                             f"{GATHER_MODES}")
        self.gather_mode = gather_mode
        self.cutoff = modelparams["cutoff"]
        n_atom_basis = modelparams["n_atom_basis"]
        gen = torch.Generator().manual_seed(seed)
        self.embedding = nn.Embedding(100, n_atom_basis)
        with torch.no_grad():
            # flax Embed default: normal with variance 1 / n_atom_basis
            self.embedding.weight.normal_(0.0, n_atom_basis ** -0.5,
                                          generator=gen)
        self.convs = nn.ModuleList([
            SchNetConv(n_atom_basis, modelparams["n_filters"],
                       modelparams["n_gaussians"], self.cutoff, gen)
            for _ in range(modelparams["n_convolutions"])])
        self.readouts = nn.ModuleDict({
            key: _Readout(n_atom_basis, gen)
            for key in modelparams.get("readout_keys", ("energy",))})

    def atomwise(self, z, xyz, idx, mask, cell_len):
        """Per-atom readouts {key: (N,)} over the (N, K) table ``idx``
        with mask ``mask`` in the diagonal cell ``cell_len`` (3,)."""
        n = xyz.shape[0]
        ext = torch.cat([xyz, xyz.new_zeros(1, 3)])
        d_raw = xyz[:, None, :] - ext[idx.long()]
        # the offset choice is piecewise constant: detached, so forces stay
        # exact away from the L/2 boundary
        off = (-(d_raw > 0.5 * cell_len).to(d_raw.dtype)
               + (d_raw < -0.5 * cell_len).to(d_raw.dtype)).detach()
        d = d_raw + off * cell_len
        e = torch.sqrt((d ** 2).sum(-1) + 1e-20)[..., None]

        index = TableIndex(torch.where(mask, idx, n).reshape(-1), n)
        plain = self.gather_mode == "gather"
        r = self.embedding(z)
        for conv in self.convs:
            r = r + conv(r, e, mask, index, plain)
        return {key: head(r) for key, head in self.readouts.items()}

    def energy(self, z, xyz, idx, mask, cell_len):
        """Total potential energy (scalar)."""
        return self.atomwise(z, xyz, idx, mask, cell_len)["energy"].sum()
