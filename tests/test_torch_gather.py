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

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu.ops.pallas_gather import (gather_mul_reduce, table_gather,
                                          table_scatter)
from mdgrad_tpu_torch.ops import counts, gather as tg, reset_counts
from mdgrad_tpu_torch.ops.time_gather import (GATHER_F, GATHER_K,
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


def test_csr_capacity_is_the_kernels():
    """ops/gather.py's capacity of the cluster build is csrc/gather.cu's:
    blocks x threads x edges a lane, and keys less the sentinel's."""
    import pathlib
    import re
    src = (pathlib.Path(tg.__file__).parent.parent / "csrc"
           / "gather.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert tg.CSR_CLUSTER_MAX_EDGES == (const("kCsrCluster")
                                        * const("kCsrThreads")
                                        * const("kCsrSteps"))
    assert tg.CSR_CLUSTER_MAX_ROWS == const("kCsrMaxKeys") - 1


def _scatter_csr_order(g, order, rowptr):
    """out[i] = g[order[rowptr[i]]] + g[order[rowptr[i] + 1]] + ... in
    float32, in the order of the CSR kernel's walk (csrc/gather.cu)."""
    n = rowptr.shape[0] - 1
    starts = rowptr.long()
    lens = starts[1:] - starts[:-1]
    starts = starts[:-1]
    out = g.new_zeros(n, g.shape[1])
    for s in range(int(lens.max()) if n else 0):
        rows = torch.nonzero(lens > s).flatten()
        out[rows] += g[order[starts[rows] + s].long()]
    return out


@pytest.mark.parametrize("case", csr_index_cases(), ids=lambda c: c[0])
def test_scatter_in_csr_order_matches_jax(case):
    """K2b's sum in the CSR's order, from the plain CSR, against the JAX
    table_scatter (interpret mode) to 1e-6 of the largest |out| in f32.
    g is rounded to bfloat16, which the JAX kernel's hi/lo split carries
    exactly, so both sides sum the same values and differ only in order."""
    _, idx, n = case
    rng = np.random.default_rng(8)
    g = rng.normal(size=(idx.shape[0], 24)).astype(np.float32)
    g = np.asarray(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    order, rowptr = tg.table_index_csr_plain(torch.tensor(idx), n)
    got = _scatter_csr_order(torch.tensor(g), order, rowptr)
    ref = np.asarray(table_scatter(jnp.asarray(g), jnp.asarray(idx), n,
                                   True, True))
    assert got.shape == ref.shape == (n, 24)
    scale = max(np.abs(ref).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(
        tg.table_scatter_plain(torch.tensor(g), torch.tensor(idx), n).numpy(),
        ref, rtol=0, atol=1e-6 * scale)
