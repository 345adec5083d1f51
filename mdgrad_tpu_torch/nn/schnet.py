"""SchNet continuous-filter GNN over an (N, K) neighbor table or an edge list.

Port of ``mdgrad_tpu/nn/schnet.py`` (``SchNetConv``, ``_SchNetModule``,
``SchNet``).  Parameter layout follows ``nn.Linear``; ``nn/convert.py``
carries the JAX package's flax parameters across.

Edge formats, as the JAX package's ``edge_format`` and ``directed``:

* ``'table'``: an (N, K) neighbor table and its mask.  Three details
  match the JAX code exactly: the diagonal-cell elementwise minimum image
  with a detached offset (or, for a triclinic cell, the table's stored
  offsets in real space), ``e = sqrt(sum d^2 + 1e-20)``, and the sentinel
  remap ``idx_m = where(mask, idx, N)`` that the aggregation kernel reads,
  built from the same effective mask as the edge weights.
* ``'pairs'``: a padded (P, 2) edge list with real-space offsets; the
  undirected (i < j) list sends each message both ways, the ``directed``
  (receiver, sender) list of ``nbr_mode='topk'`` one way.  The JAX
  package sums them with ``segment_sum``, outside any Pallas kernel; here
  ``index_add``.

``runtime_cutoff`` (the Verlet skin) masks every edge by its current
length, so a list built at ``cutoff + skin`` stays exact while no atom
moves more than skin / 2.

``compute_dtype``: the parameters stay in their dtype (float32); each
dense layer casts its input, weight and bias to its compute dtype and
computes ``(x @ W.T) + b`` in two ops, as flax's ``Dense(dtype=...)``
rounds (``F.linear`` fuses the bias and rounds once: it differs from
flax in ~27% of a bf16 output).  ``'float32'`` computes in the
parameters' dtype.  ``'bf16'`` / ``'bfloat16'``: the Gaussian smearing in
f32, then the edge filter, the node filter, the aggregation and the
update MLP in bf16, and the convolution's output back in f32.
``'mixed'``: the node filter's GEMM in bf16, everything else f32.

``gather_mode`` x ``compute_dtype`` on the table.  ``'auto'``,
``'onehot'`` and ``'pallas'`` (the TPU's one-hot MXU aggregation and its
Pallas kernel) all run the fused aggregation of ``ops/gather.py``: the K1
CUDA kernel for CUDA tensors, its plain version for CPU tensors.  In
float32 and ``'mixed'`` it is the exact f32 gather (the TPU's bf16 hi/lo
split, ``_split_matmul``, is a device for its MXU and maps to exact f32,
``split=True``).  In bf16 all three follow JAX's ``'pallas'``
(``split=False``): the gathered features rounded to bf16, f32 products
and sums over K, one rounding to bf16 -- the bf16 instantiations of K1,
K2a and K2b.  ``'gather'`` (the JAX package's plain indexed aggregation)
calls K1's plain version directly on any device, differentiated by
autograd; it launches no kernel, and in bf16 rounds each product to bf16
before the sum, as JAX's ``'gather'`` does.

In bf16 JAX's own modes do not agree: on the 32-atom system of
``tests/test_schnet.py`` (32/32/16 widths, cutoff 2.5) the forces of
``'pallas'``, ``'gather'`` and ``'onehot'`` lie 2.07e-3, 1.95e-3 and
2.25e-3 from f32 ``'pallas'`` and 0, 1.86e-3 and 1.36e-3 from bf16
``'pallas'``; in ``'mixed'`` all three lie 4.7e-4 from f32 and within
6e-8 of each other.  A bf16 parity test names its JAX mode: the port's
kernel modes are held to JAX ``'pallas'``, ``'gather'`` to ``'gather'``.
"""

import math

import numpy as np
import torch
from torch import nn

from ..ops.gather import (TableIndex, gather_mul_reduce,
                          gather_mul_reduce_plain)
from .layers import gaussian_smearing, shifted_softplus

GATHER_MODES = ("auto", "onehot", "pallas", "gather")
# compute_dtype -> (node-filter GEMM dtype, edge filter / aggregation /
# update dtype); None is the parameters' dtype
COMPUTE_DTYPES = {"float32": (None, None), "f32": (None, None),
                  "bfloat16": (torch.bfloat16, torch.bfloat16),
                  "bf16": (torch.bfloat16, torch.bfloat16),
                  "mixed": (torch.bfloat16, None)}


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


def linear(layer, x, dtype=None):
    """``layer`` (an nn.Linear) on ``x`` as flax's ``Dense(dtype=dtype)``:
    input, weight and bias cast to ``dtype``, the product rounded before
    the bias is added.  ``dtype`` None: the parameters' dtype."""
    if dtype is None:
        return layer(x)
    return (x.to(dtype) @ layer.weight.to(dtype).T) + layer.bias.to(dtype)


class SchNetConv(nn.Module):
    """One continuous-filter convolution.

    Submodules, in the order of the flax ``Dense_0 .. Dense_4``:
    ``filter_in`` (G -> G), ``filter_out`` (G -> F) on the edge side,
    ``node_filter`` (n_atom_basis -> F), ``update_in`` (F -> n_atom_basis),
    ``update_out`` (n_atom_basis -> n_atom_basis).  The Gaussian centres
    and widths are buffers, or parameters with ``trainable_gauss`` (the
    flax ``gauss_offsets`` and ``gauss_widths``).
    """

    def __init__(self, n_atom_basis, n_filters, n_gaussians, cutoff,
                 generator, trainable_gauss=False, compute_dtype="float32"):
        super().__init__()
        init_off = np.linspace(0.0, cutoff, n_gaussians)
        offsets = torch.tensor(init_off, dtype=torch.float32)
        widths = torch.full((n_gaussians,), init_off[1] - init_off[0],
                            dtype=torch.float32)
        if trainable_gauss:
            self.offsets = nn.Parameter(offsets)
            self.widths = nn.Parameter(widths)
        else:
            self.register_buffer("offsets", offsets, persistent=False)
            self.register_buffer("widths", widths, persistent=False)
        self.fdt, self.adt = COMPUTE_DTYPES[compute_dtype]
        self.filter_in = _dense(n_gaussians, n_gaussians, generator)
        self.filter_out = _dense(n_gaussians, n_filters, generator)
        self.node_filter = _dense(n_atom_basis, n_filters, generator)
        self.update_in = _dense(n_filters, n_atom_basis, generator)
        self.update_out = _dense(n_atom_basis, n_atom_basis, generator)

    def forward(self, r, e, mask, aggregate):
        """r (N, n_atom_basis); e (..., 1) edge lengths and mask (...) in
        the edge layout; ``aggregate(rf, w)`` sums each atom's senders'
        rows of ``rf`` times the edge weights ``w`` (..., F)."""
        adt = self.adt
        ef = gaussian_smearing(e, self.offsets, self.widths)
        if adt is not None:
            ef = ef.to(adt)
        ef = linear(self.filter_out,
                    shifted_softplus(linear(self.filter_in, ef, adt)), adt)
        rf = linear(self.node_filter, r, self.fdt).to(ef.dtype)
        agg = aggregate(rf, ef * mask[..., None].to(ef.dtype))
        out = shifted_softplus(linear(self.update_in, agg.to(ef.dtype), adt))
        return linear(self.update_out, out, adt).to(r.dtype)


class _Readout(nn.Module):
    """Atomwise head: Dense(n -> n/2), shifted softplus, Dense(n/2 -> 1)."""

    def __init__(self, n_atom_basis, generator):
        super().__init__()
        self.d0 = _dense(n_atom_basis, n_atom_basis // 2, generator)
        self.d1 = _dense(n_atom_basis // 2, 1, generator)

    def forward(self, r):
        return self.d1(shifted_softplus(self.d0(r))).squeeze(-1)


def _table_aggregate(index, k, split, plain):
    def aggregate(rf, w):
        w = w.reshape(-1, w.shape[-1])
        if plain:
            return gather_mul_reduce_plain(rf, w, index.idx, k)
        return gather_mul_reduce(rf, w, index, k, split)
    return aggregate


def _edge_aggregate(idx, n, directed):
    """Messages over a (P, 2) list; padded rows hold index ``n`` and zero
    weight, and land in a dropped row ``n``."""
    i, j = idx[:, 0].long(), idx[:, 1].long()

    def aggregate(rf, w):
        ext = torch.cat([rf, rf.new_zeros(1, rf.shape[1])])
        out = rf.new_zeros(n + 1, rf.shape[1])
        if directed:   # (receiver, sender) rows
            return out.index_add(0, i, ext[j] * w)[:n]
        return (out.index_add(0, j, ext[i] * w)
                + out.index_add(0, i, ext[j] * w))[:n]
    return aggregate


class SchNet(nn.Module):
    """SchNet force field; ``modelparams`` is the JAX package's dict
    (n_atom_basis, n_filters, n_gaussians, n_convolutions, cutoff,
    trainable_gauss, gather_mode, compute_dtype, readout_keys).

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (the same weights on every device); the interaction that holds the
    model moves it to its device.
    """

    def __init__(self, modelparams, seed=0):
        super().__init__()
        cdt = modelparams.get("compute_dtype", "float32")
        if cdt not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {cdt!r} not in "
                             f"{tuple(COMPUTE_DTYPES)}")
        gather_mode = modelparams.get("gather_mode", "auto")
        if gather_mode not in GATHER_MODES:
            raise ValueError(f"gather_mode {gather_mode!r} not in "
                             f"{GATHER_MODES}")
        self.gather_mode = gather_mode
        self.compute_dtype = cdt
        # the JAX package's split flag: the exact f32 gather unless bf16
        self.split = COMPUTE_DTYPES[cdt][1] is None
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
                       modelparams["n_gaussians"], self.cutoff, gen,
                       modelparams.get("trainable_gauss", False), cdt)
            for _ in range(modelparams["n_convolutions"])])
        self.readouts = nn.ModuleDict({
            key: _Readout(n_atom_basis, gen)
            for key in modelparams.get("readout_keys", ("energy",))})

    def atomwise(self, z, xyz, idx, mask, cell_len=None, offsets_real=None,
                 edge_format="table", directed=False, runtime_cutoff=None):
        """Per-atom readouts {key: (N,)}.

        ``edge_format='table'``: ``idx`` (N, K) and ``mask`` (N, K), with
        ``offsets_real`` (N, K, 3) or, for a diagonal cell, the minimum
        image in ``cell_len`` (3,).  ``'pairs'``: ``idx`` (P, 2),
        ``mask`` (P,) and ``offsets_real`` (P, 3); ``directed`` for
        (receiver, sender) rows.  ``runtime_cutoff`` masks edges by their
        current length (the Verlet skin)."""
        n = xyz.shape[0]
        ext = torch.cat([xyz, xyz.new_zeros(1, 3)])
        if edge_format == "table":
            d = xyz[:, None, :] - ext[idx.long()]
            if offsets_real is None:
                # the offset choice is piecewise constant: detached, so
                # forces stay exact away from the L/2 boundary
                off = (-(d > 0.5 * cell_len).to(d.dtype)
                       + (d < -0.5 * cell_len).to(d.dtype)).detach()
                d = d + off * cell_len
            else:
                d = d - offsets_real
        else:
            d = ext[idx[:, 0].long()] - ext[idx[:, 1].long()] - offsets_real
        e = torch.sqrt((d ** 2).sum(-1) + 1e-20)[..., None]
        if runtime_cutoff is not None:
            mask = mask & (e.squeeze(-1) < runtime_cutoff)
        if edge_format == "table":
            index = TableIndex(torch.where(mask, idx, n).reshape(-1), n)
            aggregate = _table_aggregate(index, idx.shape[1], self.split,
                                         self.gather_mode == "gather")
        else:
            aggregate = _edge_aggregate(idx, n, directed)
        r = self.embedding(z)
        for conv in self.convs:
            r = r + conv(r, e, mask, aggregate)
        return {key: head(r) for key, head in self.readouts.items()}

    def energy(self, z, xyz, idx, mask, cell_len=None, **edges):
        """Total potential energy (scalar); ``edges`` as :meth:`atomwise`."""
        return self.atomwise(z, xyz, idx, mask, cell_len,
                             **edges)["energy"].sum()
