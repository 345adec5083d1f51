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
enough loads in flight, so all three move rows as wide lanes and issue a
batch of independent row loads before using any: K1 spreads each output
row's K slots over up to 16 warps of one block (4 slots a warp, 4
elements a lane in f32 and bf16, so a 128-wide row fills the warp) and
adds the warps' partials in a fixed pairwise tree; K2a gives each
one-warp block a contiguous run of 256 lanes of the output (16 rows in
bf16, 8 in f32 at F = 128), a grid that spreads evenly over the SMs; K2b
gives each warp a 32-lane chunk of one output row in 8-byte lanes (two
warps a row in f32, one in bf16 at F = 128) and loads up to 32 of its
edges' rows at a time, adding them in ascending edge order; a row that
does not split into lanes or an unaligned pointer takes a scalar
instantiation of the same kernel, with the same sum order.  What remains
is a launch floor of ~1.6-2 us on an NVIDIA H100 80GB HBM3 at 700 W (the
same kernels on one row) and, with the inputs in device memory rather
than in the L2, the HBM's rate (PERF.md).  K2b's
CSR inverse moves 4E bytes in and 4E + 4(n + 1) out (0.05 us) and is
bound by latency: one launch of a thread block cluster builds it as a
stable counting sort over 8 SMs (``csrc/gather.cu``), for up to
:data:`CSR_CLUSTER_MAX_EDGES` edges over up to :data:`CSR_CLUSTER_MAX_ROWS`
rows; past that (the 4096-site tables) the same stable counting sort runs
over the grid as an LSD radix sort of 8-bit digits, one launch a digit
and two more, 4 at 4096 rows (:func:`table_index_csr_path`).  The TPU
kernels turn the gather into a one-hot matmul for the MXU; here the
gather is a direct indexed load in exact f32, and the K-sum of K1 stays
on chip so the gathered (E, F) tensor never reaches memory.  The scatter
reads a CSR inverse of the index (:class:`TableIndex`) and sums each
output row in ascending edge order: deterministic, with no float atomics.

Autograd is wired as the JAX ``custom_vjp``s are: the gather's backward
is the scatter and the scatter's is the gather, and K1's backward is
``d_values = scatter(w * repeat(ct))``, ``d_w = gather(values) *
repeat(ct)``, so every grad order stays inside the pair.

``split`` is the JAX package's flag.  ``split=True`` (the default) is
the exact gather of f32 operands: on the TPU a bf16 hi/lo split of the
operand on the MXU, here a direct f32 load.  ``split=False`` is JAX's
bf16 path: the gathered operand is rounded to bf16 (round to nearest
even) before any product, products and sums are f32, and K1's output
takes ``w.dtype``, K2a's ``values.dtype`` and K2b's ``g.dtype``; on the
card it runs the kernels' bf16 instantiations (bf16 in; K1 and K2a bf16
out, K2b f32 out).  JAX's K2b adds its 512-edge tiles into a bf16 output
when ``g`` is bf16; K2b here sums each row in f32 and rounds once.

A wrapper launches its kernel for CUDA tensors (f32, or bf16 where
``split=False``; contiguous) or raises; it takes the plain version only
for CPU tensors.  ``launches`` and ``plain_calls`` count the two paths,
``launches_bf16`` and ``plain_calls_bf16`` the same for ``split=False``.
"""

import torch

from . import _build

launches = {"gather_mul_reduce": 0, "table_gather": 0, "table_scatter": 0,
            "table_index_csr": 0}
plain_calls = {"gather_mul_reduce": 0, "table_gather": 0,
               "table_scatter": 0, "table_index_csr": 0}
# split=False: the bf16 instantiations and their plain versions
launches_bf16 = {"gather_mul_reduce": 0, "table_gather": 0,
                 "table_scatter": 0}
plain_calls_bf16 = dict(launches_bf16)


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


def _bf16(t):
    """``t`` rounded to bf16 (round to nearest even) and widened to f32."""
    return t.to(torch.bfloat16).float()


def table_gather_plain(values, idx, split=True):
    """``values[idx]`` with a zero row for sentinel indices; ``split=False``
    gathers ``values`` rounded to bf16, in ``values.dtype``."""
    if split:
        plain_calls["table_gather"] += 1
        return _gather_rows(values, idx)
    plain_calls_bf16["table_gather"] += 1
    return _gather_rows(values.to(torch.bfloat16), idx).to(values.dtype)


def table_scatter_plain(g, idx, n, split=True):
    """``out[i] = sum over e with idx[e] == i of g[e]``; sentinels dropped.
    ``split=False`` sums ``g`` rounded to bf16 in f32, in ``g.dtype``."""
    if split:
        plain_calls["table_scatter"] += 1
        return g.new_zeros(n + 1, g.shape[1]).index_add(0, _key(idx, n),
                                                        g)[:n]
    plain_calls_bf16["table_scatter"] += 1
    out = torch.zeros(n + 1, g.shape[1], dtype=torch.float32,
                      device=g.device)
    return out.index_add(0, _key(idx, n), _bf16(g))[:n].to(g.dtype)


def gather_mul_reduce_plain(values, w, idx, k, split=True):
    """``(values[idx] * w).reshape(-1, k, F).sum(1)``, sentinel rows zero.
    ``split=False``: ``values`` rounded to bf16, f32 products and sums over
    K, in ``w.dtype``."""
    f = w.shape[1]
    if split:
        plain_calls["gather_mul_reduce"] += 1
        return (_gather_rows(values, idx) * w).reshape(-1, k, f).sum(1)
    plain_calls_bf16["gather_mul_reduce"] += 1
    prod = _gather_rows(_bf16(values), idx) * w.float()
    return prod.reshape(-1, k, f).sum(1).to(w.dtype)


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


def _counts(split):
    return launches if split else launches_bf16


def _launch_gather_mul_reduce(values, w, idx, k, split=True):
    """K1; ``split=False`` takes bf16 ``values`` and ``w`` and gives bf16."""
    dev = values.device
    dtype = torch.float32 if split else torch.bfloat16
    _check(values, "values", dev, dtype, 2)
    _check(w, "w", dev, dtype, 2)
    _check(idx, "idx", dev, torch.int32, 1)
    n, f = values.shape
    e = idx.shape[0]
    if k < 1 or e % k or w.shape != (e, f):
        raise ValueError(f"gather_mul_reduce: w {tuple(w.shape)}, idx ({e},)"
                         f" and k={k} do not fit values ({n}, {f})")
    out = torch.empty(e // k, f, device=dev, dtype=dtype)
    lib = _build.library()
    entry = (lib.mdg_gather_mul_reduce if split
             else lib.mdg_gather_mul_reduce_bf16)
    code = entry(values.data_ptr(), w.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), n, e // k, k, f, _build.stream_of(values))
    _build.check(code, "gather_mul_reduce")
    _counts(split)["gather_mul_reduce"] += 1
    return out


def _launch_table_gather(values, idx, split=True):
    """K2a; ``split=False`` takes and gives bf16 rows."""
    dev = values.device
    dtype = torch.float32 if split else torch.bfloat16
    _check(values, "values", dev, dtype, 2)
    _check(idx, "idx", dev, torch.int32, 1)
    n, f = values.shape
    out = torch.empty(idx.shape[0], f, device=dev, dtype=dtype)
    lib = _build.library()
    entry = lib.mdg_table_gather if split else lib.mdg_table_gather_bf16
    code = entry(values.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                 idx.shape[0], f, _build.stream_of(values))
    _build.check(code, "table_gather")
    _counts(split)["table_gather"] += 1
    return out


# max_shared for mdg_table_index_csr: any size takes the cluster build
# within its capacity, 0 forces the grid build
_CSR_ANY_SHARED, _CSR_GRID = 2 ** 31 - 1, 0
# the cluster build's capacity (csrc/gather.cu kCsrMaxEdges, kCsrMaxKeys -
# 1): 8 blocks x 512 threads x 16 edges a lane, and 2048 keys (~144 KB of
# shared memory a block); the 512-site water tables (K <= 72, 36864 edges)
# are well inside, the grid build takes any index
CSR_CLUSTER_MAX_EDGES = 65536
CSR_CLUSTER_MAX_ROWS = 2047


def _launch_table_index_csr(idx, n, cluster=True):
    """K2b's CSR inverse on the card: the cluster build where
    :func:`table_index_csr_path` says so, or the grid build (forced by
    ``cluster=False``)."""
    dev = idx.device
    _check(idx, "idx", dev, torch.int32, 1)
    e = idx.shape[0]
    lib = _build.library()
    order = torch.empty(e, device=dev, dtype=torch.int32)
    rowptr = torch.empty(n + 1, device=dev, dtype=torch.int32)
    scratch = torch.empty(lib.mdg_table_index_csr_scratch(e, n), device=dev,
                          dtype=torch.int32)
    code = lib.mdg_table_index_csr(
        idx.data_ptr(), e, n, order.data_ptr(), rowptr.data_ptr(),
        scratch.data_ptr(), _CSR_ANY_SHARED if cluster else _CSR_GRID,
        _build.stream_of(idx))
    _build.check(code, "table_index_csr")
    launches["table_index_csr"] += 1
    return order, rowptr


def table_index_csr_path(e, n):
    """The build the CSR kernel takes on the card for ``e`` edges over
    ``n`` rows: "cluster" (one launch of 8 blocks) up to
    ``CSR_CLUSTER_MAX_EDGES`` edges and ``CSR_CLUSTER_MAX_ROWS`` rows, else
    "grid" (a radix sort over the grid: one launch for each 8-bit digit
    of ``n`` and two more, 4 at 4096 rows).  The library's own answer,
    ``mdg_table_index_csr_cluster``, is checked against this one on the
    card."""
    fits = e <= CSR_CLUSTER_MAX_EDGES and n <= CSR_CLUSTER_MAX_ROWS
    return "cluster" if fits else "grid"


def _launch_table_scatter(g, index, split=True):
    """K2b; ``split=False`` takes bf16 ``g`` and gives f32 sums."""
    dev = g.device
    _check(g, "g", dev, torch.float32 if split else torch.bfloat16, 2)
    order, rowptr = index.csr()
    _check(order, "order", dev, torch.int32, 1)
    if g.shape[0] != order.shape[0]:
        raise ValueError(f"table_scatter: g has {g.shape[0]} rows, the "
                         f"index {order.shape[0]} edges")
    out = torch.empty(index.n, g.shape[1], device=dev, dtype=torch.float32)
    lib = _build.library()
    entry = lib.mdg_table_scatter if split else lib.mdg_table_scatter_bf16
    code = entry(g.data_ptr(), order.data_ptr(), rowptr.data_ptr(),
                 out.data_ptr(), index.n, g.shape[1], _build.stream_of(g))
    _build.check(code, "table_scatter")
    _counts(split)["table_scatter"] += 1
    return out


# ---------------------------------------------------------------------------
# autograd Functions (the JAX custom_vjp pairs)
# ---------------------------------------------------------------------------

def _check_rows(index, values):
    if index.n != values.shape[0]:
        raise ValueError(f"index is over {index.n} rows, values has "
                         f"{values.shape[0]}")


class _TableGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, index, split):
        _check_rows(index, values)
        ctx.index, ctx.split = index, split
        if not _build.on_cuda(values):
            return table_gather_plain(values, index.idx, split)
        if split:
            return _launch_table_gather(values.contiguous(), index.idx)
        return _launch_table_gather(
            values.to(torch.bfloat16).contiguous(), index.idx,
            False).to(values.dtype)

    @staticmethod
    def backward(ctx, g):
        return table_scatter(g, ctx.index, ctx.split), None, None


class _TableScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, index, split):
        ctx.index, ctx.split = index, split
        if not _build.on_cuda(g):
            return table_scatter_plain(g, index.idx, index.n, split)
        if split:
            return _launch_table_scatter(g.contiguous(), index)
        return _launch_table_scatter(g.to(torch.bfloat16).contiguous(),
                                     index, False).to(g.dtype)

    @staticmethod
    def backward(ctx, ct):
        return table_gather(ct, ctx.index, ctx.split), None, None


class _GatherMulReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, w, index, k, split):
        _check_rows(index, values)
        ctx.save_for_backward(values, w)
        ctx.index, ctx.k, ctx.split = index, k, split
        if not _build.on_cuda(values):
            return gather_mul_reduce_plain(values, w, index.idx, k, split)
        if not split:
            values = values.to(torch.bfloat16)
        return _launch_gather_mul_reduce(values.contiguous(), w.contiguous(),
                                         index.idx, k, split)

    @staticmethod
    def backward(ctx, ct):
        values, w = ctx.saved_tensors
        index, split = ctx.index, ctx.split
        ct_e = ct.repeat_interleave(ctx.k, dim=0)
        d_values = d_w = None
        if split:
            if ctx.needs_input_grad[0]:
                d_values = table_scatter(w * ct_e, index)
            if ctx.needs_input_grad[1]:
                d_w = table_gather(values, index) * ct_e
            return d_values, d_w, None, None, None
        # the JAX _gmr_bwd, cast for cast
        ct_e = ct_e.float()
        if ctx.needs_input_grad[0]:
            d_values = table_scatter(w.float() * ct_e, index,
                                     False).to(values.dtype)
        if ctx.needs_input_grad[1]:
            d_w = (table_gather(values, index, False).float()
                   * ct_e).to(w.dtype)
        return d_values, d_w, None, None, None


def table_gather(values, index, split=True):
    """(E, F) rows ``values[index.idx]``, zero at sentinels; differentiable,
    its backward is :func:`table_scatter`."""
    return _TableGather.apply(values, index, split)


def table_scatter(g, index, split=True):
    """(index.n, F) sums of the rows of ``g`` per target; differentiable,
    its backward is :func:`table_gather`."""
    return _TableScatter.apply(g, index, split)


def gather_mul_reduce(values, w, index, k, split=True):
    """(E // k, F): ``sum_k values[idx[i*k + s]] * w[i*k + s]`` over an
    atom-major (E // k, k) table; differentiable in ``values`` and ``w``
    to any order."""
    return _GatherMulReduce.apply(values, w, index, k, split)
