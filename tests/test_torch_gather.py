"""Neighbor-table gather, scatter and gather-multiply-reduce of the port
(mdgrad_tpu_torch/ops/gather.py) against the JAX package's Pallas kernels
(mdgrad_tpu/ops/pallas_gather.py, interpret mode on the CPU).

On the CPU the port's wrappers run their plain versions through the same
autograd Functions as on the card, so these tests hold both the plain
arithmetic and the backward wiring (gather <-> scatter) to the JAX
custom_vjps.  The kernels themselves are held to the plain versions on
the card by tests/test_torch_cuda.py.
"""

import itertools
import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu.ops.pallas_gather import (gather_mul_reduce, table_gather,
                                          table_scatter)
from mdgrad_tpu_torch.ops import counts, gather as tg, reset_counts
from mdgrad_tpu_torch.ops.time_gather import (CSR_GRID_TILE, CSR_RADIX_BITS,
                                             GATHER_F, GATHER_K,
                                             GATHER_LAYOUTS, gather_index)
from test_torch_cuda import csr_index_cases

N, F, K, NO = 37, 40, 12, 29


def _fixture_inputs():
    """N values, NO output rows of K slots at F = 40, the index uniform
    over [0, N]: about 1 slot in 38 is the sentinel N."""
    rng = np.random.default_rng(0)
    return {
        "vals": rng.normal(size=(N, F)).astype(np.float32),
        # entries equal to N are the padding sentinel
        "idx": rng.integers(0, N + 1, size=NO * K).astype(np.int32),
        "w": rng.normal(size=(NO * K, F)).astype(np.float32),
        "g": rng.normal(size=(NO * K, F)).astype(np.float32),
        "ct": rng.normal(size=(NO, F)).astype(np.float32),
    }


@pytest.fixture
def data():
    return _fixture_inputs()


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


# The JAX Pallas kernels gather through a bf16 hi/lo split: 8 + 8 mantissa
# bits, ~1.5e-5 relative per gathered value; the port gathers exact f32.
# Sums of at most K=12 products of N(0, 1) values reach |x| ~ 10, so the
# split's error reaches ~5e-5; 2e-4 (test_pallas.py's bound for the same
# kernel) is still far below any indexing mistake (O(1)).
ATOL = 2e-4


# each (F, K) of the kernels' special cases once, the sentinel layouts in
# turn; (128, 40) is the water shape with the water table's layout; and the
# inputs of the ``data`` fixture
GATHER_CASES = [(f, k, GATHER_LAYOUTS[i % len(GATHER_LAYOUTS)])
                for i, (f, k) in enumerate(
                    itertools.product(GATHER_F, GATHER_K), start=1)]
GATHER_CASES.append((F, K, "fixture"))


def _case(f, k, layout):
    """Seeded inputs for a (F, K, layout) case: N values, NO output rows."""
    if layout == "fixture":
        return _fixture_inputs()
    rng = np.random.default_rng(7)
    return {
        "vals": rng.normal(size=(N, f)).astype(np.float32),
        "idx": gather_index(rng, layout, N, NO, k),
        "w": rng.normal(size=(NO * k, f)).astype(np.float32),
        "g": rng.normal(size=(NO * k, f)).astype(np.float32),
        "ct": rng.normal(size=(NO, f)).astype(np.float32),
    }


@pytest.mark.parametrize("f,k,layout", GATHER_CASES)
def test_gather_mul_reduce_matches_jax(f, k, layout):
    data = _case(f, k, layout)
    index = tg.TableIndex(_t(data["idx"]), N)
    vals = _t(data["vals"], requires_grad=True)
    w = _t(data["w"], requires_grad=True)
    out = tg.gather_mul_reduce(vals, w, index, k)
    ref = gather_mul_reduce(jnp.asarray(data["vals"]), jnp.asarray(data["w"]),
                            jnp.asarray(data["idx"]), k, True, True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    plain = tg.gather_mul_reduce_plain(vals.detach(), w.detach(),
                                       index.idx, k)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=ATOL)

    (out * _t(data["ct"])).sum().backward()
    gv, gw = jax.grad(lambda v, w_: (gather_mul_reduce(
        v, w_, jnp.asarray(data["idx"]), k, True, True)
        * data["ct"]).sum(), argnums=(0, 1))(
        jnp.asarray(data["vals"]), jnp.asarray(data["w"]))
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(gv), atol=ATOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), atol=ATOL)


@pytest.mark.parametrize("f,k,layout", GATHER_CASES)
def test_table_gather_scatter_match_jax(f, k, layout):
    data = _case(f, k, layout)
    index = tg.TableIndex(_t(data["idx"]), N)
    idx_j = jnp.asarray(data["idx"])
    vals = _t(data["vals"], requires_grad=True)
    g = _t(data["g"], requires_grad=True)

    out = tg.table_gather(vals, index)
    ref = table_gather(jnp.asarray(data["vals"]), idx_j, True, True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    sc = tg.table_scatter(g, index)
    ref_sc = table_scatter(jnp.asarray(data["g"]), idx_j, N, True, True)
    np.testing.assert_allclose(sc.detach().numpy(), np.asarray(ref_sc),
                               atol=ATOL)

    # first-order grads: each one's vjp is the other
    (out * _t(data["g"])).sum().backward()
    (sc * _t(data["vals"])).sum().backward()
    gv = jax.grad(lambda v: (table_gather(v, idx_j, True, True)
                             * data["g"]).sum())(jnp.asarray(data["vals"]))
    gg = jax.grad(lambda x: (table_scatter(x, idx_j, N, True, True)
                             * data["vals"]).sum())(jnp.asarray(data["g"]))
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(gv), atol=ATOL)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(gg), atol=ATOL)


def test_gather_grad_of_grad_matches_jax(data):
    """The force grad-of-grad pattern: d/dv of |d E / d v|^2 for an energy
    built on K1, through the gather/scatter backward pair."""
    index = tg.TableIndex(_t(data["idx"]), N)
    idx_j = jnp.asarray(data["idx"])
    w_t, ct_t = _t(data["w"]), _t(data["ct"])
    v = _t(data["vals"], requires_grad=True)
    e = (tg.gather_mul_reduce(v * v, w_t, index, K) * ct_t).sum()
    (dv,) = torch.autograd.grad(e, v, create_graph=True)
    (h,) = torch.autograd.grad((dv ** 2).sum(), v)

    def energy(x):
        return (gather_mul_reduce(x * x, jnp.asarray(data["w"]), idx_j, K,
                                  True, True) * data["ct"]).sum()

    h_ref = jax.grad(lambda x: (jax.grad(energy)(x) ** 2).sum())(
        jnp.asarray(data["vals"]))
    scale = np.abs(np.asarray(h_ref)).max()
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref),
                               atol=1e-5 * scale)


def test_gradcheck_f64():
    """gradcheck and gradgradcheck in f64 on the plain versions and on the
    autograd Functions that wrap them."""
    rng = np.random.default_rng(1)
    n, f, k, no = 7, 3, 4, 5
    idx = torch.tensor(rng.integers(0, n + 2, size=no * k), dtype=torch.int32)
    index = tg.TableIndex(idx, n)
    v = torch.tensor(rng.normal(size=(n, f)), requires_grad=True)
    w = torch.tensor(rng.normal(size=(no * k, f)), requires_grad=True)
    g = torch.tensor(rng.normal(size=(no * k, f)), requires_grad=True)
    cases = [
        (lambda a, b: tg.gather_mul_reduce_plain(a, b, idx, k), (v, w)),
        (lambda a: tg.table_gather_plain(a, idx), (v,)),
        (lambda a: tg.table_scatter_plain(a, idx, n), (g,)),
        (lambda a, b: tg.gather_mul_reduce(a, b, index, k), (v, w)),
        (lambda a: tg.table_gather(a, index), (v,)),
        (lambda a: tg.table_scatter(a, index), (g,)),
    ]
    for fn, args in cases:
        assert torch.autograd.gradcheck(fn, args)
        assert torch.autograd.gradgradcheck(fn, args)


def test_table_index_csr():
    rng = np.random.default_rng(2)
    n = 9
    idx = rng.integers(-1, n + 3, size=50).astype(np.int32)
    order, rowptr = tg.TableIndex(torch.tensor(idx), n).csr()
    order, rowptr = order.numpy(), rowptr.numpy()
    for i in range(n):
        np.testing.assert_array_equal(order[rowptr[i]:rowptr[i + 1]],
                                      np.flatnonzero(idx == i))
    assert rowptr[n] == ((idx >= 0) & (idx < n)).sum()


def test_cpu_wrappers_take_the_plain_versions(data):
    index = tg.TableIndex(_t(data["idx"]), N)
    reset_counts()
    v = _t(data["vals"])
    tg.gather_mul_reduce(v, _t(data["w"]), index, K)
    tg.table_gather(v, index)
    tg.table_scatter(_t(data["g"]), index)
    c = counts()
    assert all(c["launches"][k] == 0 for k in tg.launches)
    # the plain scatter is an index_add: it builds no CSR inverse
    assert {k: c["plain_calls"][k] for k in tg.plain_calls} == {
        "gather_mul_reduce": 1, "table_gather": 1, "table_scatter": 1,
        "table_index_csr": 0}


@pytest.mark.parametrize("case", csr_index_cases(), ids=lambda c: c[0])
def test_table_index_csr_plain_matches_numpy(case):
    """The plain CSR build (the reference of the CSR kernel) against a
    numpy stable argsort and bincount of the sentinel-mapped index, on
    negative, == n and > n sentinels, empty rows, one row that takes every
    edge, no edges, and the water shape."""
    _, idx, n = case
    key = np.where((idx >= 0) & (idx < n), idx, n)
    reset_counts()
    order, rowptr = tg.TableIndex(torch.tensor(idx), n).csr()
    assert counts()["plain_calls"]["table_index_csr"] == 1
    assert order.dtype == rowptr.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(key, kind="stable"))
    starts = np.concatenate([[0], np.cumsum(np.bincount(key, minlength=n + 1))])
    np.testing.assert_array_equal(rowptr.numpy(), starts[:n + 1])


# (e, n, the build the card takes): every water table, K = 16 (a
# regrow's start) to 72 (its end) at n = 512, and each side of the cluster
# build's capacity in edges and in rows
CSR_PATHS = ([(512 * k, 512, "cluster") for k in (16, 40, 48, 56, 72)]
             + [(tg.CSR_CLUSTER_MAX_EDGES, 512, "cluster"),
                (tg.CSR_CLUSTER_MAX_EDGES + 1, 512, "grid"),
                (8192, tg.CSR_CLUSTER_MAX_ROWS, "cluster"),
                (8192, tg.CSR_CLUSTER_MAX_ROWS + 1, "grid")])


@pytest.mark.parametrize("e, n, path", CSR_PATHS)
def test_table_index_csr_path(e, n, path):
    """Every water table takes the cluster build; the grid build only
    past 65536 edges or 2047 rows."""
    assert tg.table_index_csr_path(e, n) == path


def _gather_cu_const(name):
    """The value of ``constexpr int name = ...;`` in csrc/gather.cu."""
    src = (pathlib.Path(tg.__file__).parent.parent / "csrc"
           / "gather.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def test_csr_capacity_is_the_kernels():
    """ops/gather.py's capacity of the cluster build is csrc/gather.cu's:
    blocks x threads x edges a lane, and keys less the sentinel's."""
    assert tg.CSR_CLUSTER_MAX_EDGES == (_gather_cu_const("kCsrCluster")
                                        * _gather_cu_const("kCsrThreads")
                                        * _gather_cu_const("kCsrSteps"))
    assert tg.CSR_CLUSTER_MAX_ROWS == _gather_cu_const("kCsrMaxKeys") - 1


def test_csr_grid_layout_is_the_kernels():
    """The digit width and tile that ``csr_index_cases`` straddles are
    csrc/gather.cu's grid build's: kCsrRadixBits, and kCsrThreads x
    kCsrTileSteps edges a tile."""
    assert CSR_RADIX_BITS == _gather_cu_const("kCsrRadixBits")
    assert CSR_GRID_TILE == (_gather_cu_const("kCsrThreads")
                             * _gather_cu_const("kCsrTileSteps"))


def _csr_grid_model(idx, n):
    """numpy model of csrc/gather.cu's grid build, with its digit width,
    tile, warps and blocks read from the source: LSD passes over the
    digits of the sentinel-mapped key, each placing edge p at the digit's
    first slot + the lower blocks' count of the digit + the block's
    earlier tiles' + the tile's lower warps' + its place among its warp's
    edges of the digit (edge order); then rowptr from the sorted keys'
    boundaries, position q writing q for the keys in (key[q - 1], key[q]]
    and position e for the keys past the last.  Every slot must be written
    once in each pass."""
    bits = _gather_cu_const("kCsrRadixBits")
    threads = _gather_cu_const("kCsrThreads")
    tile = threads * _gather_cu_const("kCsrTileSteps")
    warps, slice_ = threads // 32, tile // (threads // 32)
    max_blocks = _gather_cu_const("kCsrMaxBlocks")
    e, digits = idx.size, 1 << bits
    key = np.where((idx >= 0) & (idx < n), idx, n).astype(np.int64)
    if e == 0:   # the entry point's memset
        return np.zeros(0, np.int64), np.zeros(n + 1, np.int64)
    passes = -(-max(int(n).bit_length(), 1) // bits)
    tiles = -(-e // tile)
    per = -(-tiles // max_blocks)
    p = np.arange(e)
    t = p // tile
    b = t // per
    w = t * warps + (p % tile) // slice_
    ids = p
    for pass_ in range(passes):
        d = (key >> (bits * pass_)) & (digits - 1)
        # each block's count of each digit (the count launch's in the
        # first pass, the previous scatter's atomics after it)
        block_counts = np.bincount(b * digits + d, minlength=(b[-1] + 1)
                                   * digits).reshape(-1, digits)
        first = np.cumsum(block_counts.sum(0)) - block_counts.sum(0)
        lower_blocks = np.cumsum(block_counts, 0) - block_counts
        tile_counts = np.bincount(t * digits + d, minlength=tiles
                                  * digits).reshape(tiles, digits)
        before_tile = np.cumsum(tile_counts, 0) - tile_counts
        earlier_tiles = before_tile - before_tile[(np.arange(tiles) // per)
                                                  * per]
        warp_counts = np.bincount(w * digits + d, minlength=tiles * warps
                                  * digits).reshape(tiles, warps, digits)
        lower_warps = (np.cumsum(warp_counts, 1) - warp_counts).reshape(
            -1, digits)
        group = w * digits + d
        by_group = np.argsort(group, kind="stable")
        place = np.empty(e, np.int64)
        place[by_group] = p - np.searchsorted(group[by_group],
                                              group[by_group])
        q = (first[d] + lower_blocks[b, d] + earlier_tiles[t, d]
             + lower_warps[w, d] + place)
        assert np.array_equal(np.bincount(q, minlength=e), np.ones(e))
        key_out, ids_out = np.empty_like(key), np.empty_like(ids)
        key_out[q], ids_out[q] = key, ids
        key, ids = key_out, ids_out
    before = np.concatenate([[-1], key])
    after = np.concatenate([key, [n]])
    return ids, np.repeat(np.arange(e + 1), after - before)


@pytest.mark.parametrize("case", csr_index_cases(), ids=lambda c: c[0])
def test_csr_grid_model_matches_plain(case):
    """The grid build's passes, modelled in numpy, give the plain build's
    order and rowptr on every case: its algorithm's guard off the card."""
    _, idx, n = case
    order, rowptr = _csr_grid_model(idx, n)
    ref_order, ref_rowptr = tg.table_index_csr_plain(torch.tensor(idx), n)
    np.testing.assert_array_equal(order, ref_order.numpy())
    np.testing.assert_array_equal(rowptr, ref_rowptr.numpy())


def _scatter_csr_order(g, order, rowptr, long_row=512):
    """out[i] = g[order[rowptr[i]]] + g[order[rowptr[i] + 1]] + ... in
    float32, in the order of the CSR kernel's walk (csrc/gather.cu); a row
    of more than ``long_row`` edges by numpy's cumsum, which also adds one
    at a time in float32."""
    n = rowptr.shape[0] - 1
    starts = rowptr.long()
    lens = starts[1:] - starts[:-1]
    starts = starts[:-1]
    out = g.new_zeros(n, g.shape[1])
    for s in range(min(int(lens.max()), long_row) if n else 0):
        rows = torch.nonzero(lens > s).flatten()
        out[rows] += g[order[starts[rows] + s].long()]
    for i in torch.nonzero(lens > long_row).flatten().tolist():
        edges = order[starts[i]:starts[i] + lens[i]].long()
        out[i] = torch.from_numpy(np.cumsum(g[edges].numpy(), axis=0)[-1])
    return out


# the JAX scatter's one-hot has E x n slots; past this many it runs on
# blocks of rows (the 4096-row and 48668-row cases)
JAX_ONE_HOT_SLOTS = 2 ** 26
JAX_ROW_BLOCK = 128


def _jax_table_scatter(g, idx, n):
    """The JAX table_scatter of ``g`` over ``idx`` (interpret mode).  Its
    one-hot costs E x n multiply-adds, minutes at 4096 rows on the CPU, so
    past ``JAX_ONE_HOT_SLOTS`` it runs once for each block of
    ``JAX_ROW_BLOCK`` consecutive rows that some edge lands on: the block's
    edges in edge order, renumbered into the block and padded with its
    sentinel to one length; every row sums the same edges as in one call."""
    if idx.size * n <= JAX_ONE_HOT_SLOTS:
        return np.asarray(table_scatter(jnp.asarray(g), jnp.asarray(idx), n,
                                        True, True))
    key = np.where((idx >= 0) & (idx < n), idx, n)
    rows = np.unique(key[key < n])
    block = np.full(n + 1, -1)
    block[rows] = np.arange(rows.size) // JAX_ROW_BLOCK
    local = np.full(n + 1, JAX_ROW_BLOCK)
    local[rows] = np.arange(rows.size) % JAX_ROW_BLOCK
    of_edge = block[key]
    n_blocks = -(-rows.size // JAX_ROW_BLOCK)
    length = np.bincount(of_edge[of_edge >= 0], minlength=n_blocks).max()
    length = -(-length // 512) * 512
    out = np.zeros((n, g.shape[1]), np.float32)
    for i in range(n_blocks):
        sel = np.flatnonzero(of_edge == i)
        g_i = np.zeros((length, g.shape[1]), np.float32)
        g_i[:sel.size] = g[sel]
        idx_i = np.full(length, JAX_ROW_BLOCK, np.int32)
        idx_i[:sel.size] = local[key[sel]]
        rows_i = rows[i * JAX_ROW_BLOCK:(i + 1) * JAX_ROW_BLOCK]
        out[rows_i] = np.asarray(table_scatter(
            jnp.asarray(g_i), jnp.asarray(idx_i), JAX_ROW_BLOCK, True,
            True))[:rows_i.size]
    return out


@pytest.mark.parametrize("case", csr_index_cases(), ids=lambda c: c[0])
def test_scatter_in_csr_order_matches_jax(case):
    """K2b's sum in the CSR's order, from the plain CSR, against the JAX
    table_scatter (interpret mode; by blocks of rows on the large cases)
    to 1e-6 of the largest |out| in f32.  g is rounded to bfloat16, which
    the JAX kernel's hi/lo split carries exactly, so both sides sum the
    same values and differ only in order."""
    _, idx, n = case
    rng = np.random.default_rng(8)
    g = rng.normal(size=(idx.shape[0], 24)).astype(np.float32)
    g = np.asarray(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    order, rowptr = tg.table_index_csr_plain(torch.tensor(idx), n)
    got = _scatter_csr_order(torch.tensor(g), order, rowptr)
    ref = _jax_table_scatter(g, idx, n)
    assert got.shape == ref.shape == (n, 24)
    scale = max(np.abs(ref).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(
        tg.table_scatter_plain(torch.tensor(g), torch.tensor(idx), n).numpy(),
        ref, rtol=0, atol=1e-6 * scale)
