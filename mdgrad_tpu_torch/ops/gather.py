"""Neighbor-table gather, scatter and fused gather-multiply-reduce.

Port of ``mdgrad_tpu/ops/pallas_gather.py``.  Three CUDA kernels
(``csrc/gather.cu``), each beside its plain PyTorch version:

* :func:`gather_mul_reduce` (K1) -- ``out[i] = sum_k values[idx[iK+k]] *
  w[iK+k]``, the SchNet table aggregation; replaces ``gather_mul_reduce``
  (``_gmr_kernel``).
* :func:`table_gather` (K2a) -- ``out[e] = values[idx[e]]``, zero at the
  sentinel; replaces ``table_gather`` (``_gather_kernel``).
* :func:`table_scatter` (K2b) -- ``out[i] = sum_{idx[e]=i} g[e]``,
  out-of-range indices dropped; replaces ``table_scatter``
  (``_scatter_kernel``).  It reads a CSR inverse of the index, built on
  the card by a fourth kernel (``TableIndex.csr``, counted as
  ``table_index_csr``), the port's own: the TPU kernel needs no inverse.

What bounds them on an H100: bytes.  At the 512-site water shapes the
edge tensor has 20480 slots of 128 f32 (10.5 MB), of which ~70% are real
edges.  K2a writes every slot; K1 and K2b read only the real edges' rows
(~7.3 MB), plus the (512, 128) node tables: ~2.3-3.2 us at 3.35 TB/s,
with 2 flops per edge element at most.  They reach that bound only with
enough loads in flight, so K1 and K2a move rows as 16-byte vectors and
issue a batch of independent row loads before using any: K1 spreads each
output row's K slots over up to 16 warps of one block (4 slots a warp,
partials summed in warp order), K2a gives each warp 8 edge rows; F % 4
!= 0 or an unaligned pointer takes a scalar instantiation of the same
kernel.  What remains is a launch floor of ~2 us (the same kernels on one
row) and, with the inputs in device memory rather than in the L2, the
HBM's rate (PERF.md).  K2b's CSR inverse moves 4E bytes in and 4E +
4(n + 1) out (0.05 us) and is bound by latency: one block builds it as a
stable counting sort in one launch (``csrc/gather.cu``).  The TPU
kernels turn the gather into a one-hot matmul for the MXU; here the
gather is a direct indexed load in exact f32, and the K-sum of K1 stays
on chip so the gathered (E, F) tensor never reaches memory.  The scatter
reads a CSR inverse of the index (:class:`TableIndex`) and sums each
output row in ascending edge order: deterministic, with no float atomics.

Autograd is wired as the JAX ``custom_vjp``s are: the gather's backward
is the scatter and the scatter's is the gather, and K1's backward is
``d_values = scatter(w * repeat(ct))``, ``d_w = gather(values) *
repeat(ct)``, so every grad order stays inside the pair.

A wrapper launches its kernel for CUDA tensors (f32, contiguous) or
raises; it takes the plain version only for CPU tensors.  ``launches``
and ``plain_calls`` count the two paths.
"""

import torch

from . import _build

launches = {"gather_mul_reduce": 0, "table_gather": 0, "table_scatter": 0,
            "table_index_csr": 0}
plain_calls = {"gather_mul_reduce": 0, "table_gather": 0,
               "table_scatter": 0, "table_index_csr": 0}


class TableIndex:
    """Flat edge index ``idx`` (E,) into ``n`` node rows, plus its CSR
    inverse for the scatter.

    An entry outside ``[0, n)`` is the padding sentinel.  The CSR inverse
    (a stable argsort of the sentinel-mapped index and row pointers) is
    built on first use -- by the CSR kernel for a CUDA index, by
    :func:`table_index_csr_plain` for a CPU one -- and then shared by every
    scatter on this index.  SchNet makes one TableIndex per energy, so on
    the MD path that is one build per force.
    """

    def __init__(self, idx, n):
        if idx.dim() != 1:
            raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
        self.idx = idx.to(torch.int32).contiguous()
        self.n = int(n)
        self._csr = None

    def key(self):
        """int64 index with every sentinel mapped to ``n``."""
        return _key(self.idx, self.n)

    def csr(self):
        """(order (E,) int32, rowptr (n + 1,) int32): the edges that land
        on row ``i`` are ``order[rowptr[i]:rowptr[i + 1]]``, ascending."""
        if self._csr is None:
            self._csr = (_launch_table_index_csr(self.idx, self.n)
                         if _build.on_cuda(self.idx)
                         else table_index_csr_plain(self.idx, self.n))
        return self._csr


# ---------------------------------------------------------------------------
# plain versions (CPU path; the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _key(idx, n):
    """int64 ``idx`` with every sentinel mapped to ``n``."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _gather_rows(values, idx):
    ext = torch.cat([values, values.new_zeros(1, values.shape[1])])
    return ext[_key(idx, values.shape[0])]


def table_index_csr_plain(idx, n):
    """(order (E,) int32, rowptr (n + 1,) int32): a stable argsort of the
    index with every sentinel mapped to ``n``, and each row's first slot."""
    plain_calls["table_index_csr"] += 1
    key = _key(idx, n)
    order = torch.argsort(key, stable=True)
    rowptr = torch.searchsorted(key[order],
                                torch.arange(n + 1, device=key.device))
    return order.to(torch.int32), rowptr.to(torch.int32)


def table_gather_plain(values, idx):
    """``values[idx]`` with a zero row for sentinel indices."""
    plain_calls["table_gather"] += 1
    return _gather_rows(values, idx)


def table_scatter_plain(g, idx, n):
    """``out[i] = sum over e with idx[e] == i of g[e]``; sentinels dropped."""
    plain_calls["table_scatter"] += 1
    return g.new_zeros(n + 1, g.shape[1]).index_add(0, _key(idx, n), g)[:n]


def gather_mul_reduce_plain(values, w, idx, k):
    """``(values[idx] * w).reshape(-1, k, F).sum(1)``, sentinel rows zero."""
    plain_calls["gather_mul_reduce"] += 1
    return (_gather_rows(values, idx) * w).reshape(-1, k, w.shape[1]).sum(1)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(t, name, device, dtype, ndim):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_gather_mul_reduce(values, w, idx, k):
    dev = values.device
    _check(values, "values", dev, torch.float32, 2)
    _check(w, "w", dev, torch.float32, 2)
    _check(idx, "idx", dev, torch.int32, 1)
    n, f = values.shape
    e = idx.shape[0]
    if k < 1 or e % k or w.shape != (e, f):
        raise ValueError(f"gather_mul_reduce: w {tuple(w.shape)}, idx ({e},)"
                         f" and k={k} do not fit values ({n}, {f})")
    out = torch.empty(e // k, f, device=dev, dtype=torch.float32)
    code = _build.library().mdg_gather_mul_reduce(
        values.data_ptr(), w.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n, e // k, k, f, _build.stream_of(values))
    _build.check(code, "gather_mul_reduce")
    launches["gather_mul_reduce"] += 1
    return out


def _launch_table_gather(values, idx):
    dev = values.device
    _check(values, "values", dev, torch.float32, 2)
    _check(idx, "idx", dev, torch.int32, 1)
    n, f = values.shape
    out = torch.empty(idx.shape[0], f, device=dev, dtype=torch.float32)
    code = _build.library().mdg_table_gather(
        values.data_ptr(), idx.data_ptr(), out.data_ptr(), n, idx.shape[0],
        f, _build.stream_of(values))
    _build.check(code, "table_gather")
    launches["table_gather"] += 1
    return out


# max_shared for mdg_table_index_csr: any size up to the card's limit
# takes the one-block build, 0 forces the grid build
_CSR_ONE_BLOCK, _CSR_GRID = 2 ** 31 - 1, 0


def _launch_table_index_csr(idx, n, one_block=True):
    dev = idx.device
    _check(idx, "idx", dev, torch.int32, 1)
    e = idx.shape[0]
    order = torch.empty(e, device=dev, dtype=torch.int32)
    rowptr = torch.empty(n + 1, device=dev, dtype=torch.int32)
    scratch = torch.empty(n + 1, device=dev, dtype=torch.int32)
    code = _build.library().mdg_table_index_csr(
        idx.data_ptr(), e, n, order.data_ptr(), rowptr.data_ptr(),
        scratch.data_ptr(), _CSR_ONE_BLOCK if one_block else _CSR_GRID,
        _build.stream_of(idx))
    _build.check(code, "table_index_csr")
    launches["table_index_csr"] += 1
    return order, rowptr


def table_index_csr_path(e, n):
    """The build the CSR kernel takes on the card for ``e`` edges over
    ``n`` rows: "one block" while its shared memory fits the card's
    limit, else "grid"."""
    code = _build.library().mdg_table_index_csr_one_block(e, n)
    if code < 0:
        _build.check(-code, "table_index_csr_path")
    return "one block" if code else "grid"


def _launch_table_scatter(g, index):
    dev = g.device
    _check(g, "g", dev, torch.float32, 2)
    order, rowptr = index.csr()
    _check(order, "order", dev, torch.int32, 1)
    if g.shape[0] != order.shape[0]:
        raise ValueError(f"table_scatter: g has {g.shape[0]} rows, the "
                         f"index {order.shape[0]} edges")
    out = torch.empty(index.n, g.shape[1], device=dev, dtype=torch.float32)
    code = _build.library().mdg_table_scatter(
        g.data_ptr(), order.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
        index.n, g.shape[1], _build.stream_of(g))
    _build.check(code, "table_scatter")
    launches["table_scatter"] += 1
    return out


# ---------------------------------------------------------------------------
# autograd Functions (the JAX custom_vjp pairs)
# ---------------------------------------------------------------------------

class _TableGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, index):
        if index.n != values.shape[0]:
            raise ValueError(f"index is over {index.n} rows, values has "
                             f"{values.shape[0]}")
        ctx.index = index
        if _build.on_cuda(values):
            return _launch_table_gather(values.contiguous(), index.idx)
        return table_gather_plain(values, index.idx)

    @staticmethod
    def backward(ctx, g):
        return table_scatter(g, ctx.index), None


class _TableScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, index):
        ctx.index = index
        if _build.on_cuda(g):
            return _launch_table_scatter(g.contiguous(), index)
        return table_scatter_plain(g, index.idx, index.n)

    @staticmethod
    def backward(ctx, ct):
        return table_gather(ct, ctx.index), None


class _GatherMulReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, w, index, k):
        if index.n != values.shape[0]:
            raise ValueError(f"index is over {index.n} rows, values has "
                             f"{values.shape[0]}")
        ctx.save_for_backward(values, w)
        ctx.index, ctx.k = index, k
        if _build.on_cuda(values):
            return _launch_gather_mul_reduce(values.contiguous(),
                                             w.contiguous(), index.idx, k)
        return gather_mul_reduce_plain(values, w, index.idx, k)

    @staticmethod
    def backward(ctx, ct):
        values, w = ctx.saved_tensors
        ct_e = ct.repeat_interleave(ctx.k, dim=0)
        d_values = d_w = None
        if ctx.needs_input_grad[0]:
            d_values = table_scatter(w * ct_e, ctx.index)
        if ctx.needs_input_grad[1]:
            d_w = table_gather(values, ctx.index) * ct_e
        return d_values, d_w, None, None


def table_gather(values, index):
    """(E, F) rows ``values[index.idx]``, zero at sentinels; differentiable,
    its backward is :func:`table_scatter`."""
    return _TableGather.apply(values, index)


def table_scatter(g, index):
    """(index.n, F) sums of the rows of ``g`` per target; differentiable,
    its backward is :func:`table_gather`."""
    return _TableScatter.apply(g, index)


def gather_mul_reduce(values, w, index, k):
    """(E // k, F): ``sum_k values[idx[i*k + s]] * w[i*k + s]`` over an
    atom-major (E // k, k) table; differentiable in ``values`` and ``w``
    to any order."""
    return _GatherMulReduce.apply(values, w, index, k)
