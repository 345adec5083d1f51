"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)  Inputs
are small and made from a numpy seed; sentinel indices are included.
"""

import numpy as np
import pytest
import torch

import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import ops
from mdgrad_tpu_torch.data.registry import get_unit_len
from mdgrad_tpu_torch.ops import gather as tg
from mdgrad_tpu_torch.ops import rdf as trdf
from mdgrad_tpu_torch.ops.time_gather import (GATHER_F, GATHER_K,
                                             GATHER_LAYOUTS, csr_index_cases,
                                             gather_index)
from mdgrad_tpu_torch.ops.time_pair import (cutoff_edge_case, lj_edge_cases,
                                           pair_image_w, split, unwrapped)
from mdgrad_tpu_torch.ops.time_rdf import edge_cases as rdf_edge_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_gather_kernels_match_plain(cuda):
    rng = np.random.default_rng(0)
    n, f, k, n_out = 37, 40, 12, 29
    idx = torch.tensor(rng.integers(-1, n + 2, size=n_out * k),
                       dtype=torch.int32, device=cuda)
    index = tg.TableIndex(idx, n)
    v = torch.tensor(rng.normal(size=(n, f)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.normal(size=(n_out * k, f)), dtype=torch.float32,
                     device=cuda)
    # f32 sums of at most k products in another order: ~1e-6 relative
    torch.testing.assert_close(
        tg._launch_gather_mul_reduce(v, w, index.idx, k),
        tg.gather_mul_reduce_plain(v, w, index.idx, k), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(tg._launch_table_gather(v, index.idx),
                               tg.table_gather_plain(v, index.idx),
                               atol=0, rtol=0)
    torch.testing.assert_close(tg._launch_table_scatter(w, index),
                               tg.table_scatter_plain(w, index.idx, n),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(TypeError):
        tg._launch_table_gather(v.double(), index.idx)
    with pytest.raises(ValueError):
        tg._launch_gather_mul_reduce(v, w[:-1], index.idx, k)


@pytest.mark.parametrize("layout", GATHER_LAYOUTS)
@pytest.mark.parametrize("k", GATHER_K)
@pytest.mark.parametrize("f", GATHER_F)
def test_gather_kernels_on_edge_cases(cuda, f, k, layout):
    """K1 within 1e-5 of max(|ref|, 1) of its plain version (f32 sums of
    at most k products in another order) and K2a bit-exact (a copy), on 29
    output rows over 37 values (neither a multiple of a block's or a warp's
    rows), and the same bits on a second call."""
    rng = np.random.default_rng(10)
    n, n_out = 37, 29
    idx = torch.tensor(gather_index(rng, layout, n, n_out, k), device=cuda)
    v = torch.tensor(rng.normal(size=(n, f)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.normal(size=(n_out * k, f)), dtype=torch.float32,
                     device=cuda)
    got = tg._launch_gather_mul_reduce(v, w, idx, k)
    ref = tg.gather_mul_reduce_plain(v, w, idx, k)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * max(ref.abs().max().item(), 1.0))
    assert torch.equal(got, tg._launch_gather_mul_reduce(v, w, idx, k))
    out = tg._launch_table_gather(v, idx)
    assert torch.equal(out, tg.table_gather_plain(v, idx))
    assert torch.equal(out, tg._launch_table_gather(v, idx))


@pytest.mark.parametrize("f", [40, 128])
def test_gather_kernels_at_an_unaligned_offset(cuda, f):
    """Contiguous views at a 4-byte storage offset take the scalar path:
    K1 and K2a still match their plain versions, and give the bits of the
    16-byte path on aligned copies of the same inputs (each feature is
    summed in the same order on both paths)."""
    rng = np.random.default_rng(11)
    n, n_out, k = 64, 64, 40
    idx = torch.tensor(gather_index(rng, "suffix", n, n_out, k), device=cuda)
    buf = torch.tensor(rng.normal(size=1 + n * f + n_out * k * f),
                       dtype=torch.float32, device=cuda)
    v = buf[1:1 + n * f].view(n, f)
    w = buf[1 + n * f:].view(n_out * k, f)
    assert v.is_contiguous() and v.data_ptr() % 16 and w.data_ptr() % 16
    got = tg._launch_gather_mul_reduce(v, w, idx, k)
    ref = tg.gather_mul_reduce_plain(v, w, idx, k)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * max(ref.abs().max().item(), 1.0))
    assert torch.equal(got, tg._launch_gather_mul_reduce(v.clone(),
                                                         w.clone(), idx, k))
    out = tg._launch_table_gather(v, idx)
    assert torch.equal(out, tg.table_gather_plain(v, idx))
    assert torch.equal(out, tg._launch_table_gather(v.clone(), idx))


def test_gather_autograd_runs_the_kernels(cuda):
    """Forward and backward of the wrappers on CUDA tensors launch the
    kernels and match autograd through the plain version."""
    rng = np.random.default_rng(1)
    n, f, k = 20, 16, 6
    idx = torch.tensor(rng.integers(0, n + 1, size=n * k), dtype=torch.int32,
                       device=cuda)
    index = tg.TableIndex(idx, n)
    v = torch.tensor(rng.normal(size=(n, f)), dtype=torch.float32,
                     device=cuda, requires_grad=True)
    w = torch.tensor(rng.normal(size=(n * k, f)), dtype=torch.float32,
                     device=cuda, requires_grad=True)
    ct = torch.tensor(rng.normal(size=(n, f)), dtype=torch.float32,
                      device=cuda)
    mt.ops.reset_counts()
    grads = torch.autograd.grad(
        (tg.gather_mul_reduce(v, w, index, k) * ct).sum(), (v, w))
    launches = mt.ops.counts()["launches"]
    assert launches["gather_mul_reduce"] == 1
    assert launches["table_gather"] == 1 and launches["table_scatter"] == 1
    ref = torch.autograd.grad(
        (tg.gather_mul_reduce_plain(v, w, idx, k) * ct).sum(), (v, w))
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _bf16(rng, shape, cuda):
    return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                        device=cuda).to(torch.bfloat16)


def _assert_k1_bf16_close(got, ref):
    """K1 in bf16: the kernel and the plain version sum the same f32
    products in other orders and round once, so they differ by at most one
    bf16 ulp (2^-7 of the value at most) plus the f32 order's 1e-5 of
    max(|ref|, 1)."""
    assert got.dtype == ref.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), ref.float(), rtol=2.0 ** -7,
        atol=1e-5 * max(ref.float().abs().max().item(), 1.0))


@pytest.mark.parametrize("layout", GATHER_LAYOUTS)
@pytest.mark.parametrize("k", GATHER_K)
@pytest.mark.parametrize("f", GATHER_F)
def test_bf16_gather_kernels_on_edge_cases(cuda, f, k, layout):
    """The bf16 instantiations (split=False) on the f32 kernels' edge
    cases (K1 at F % 4 != 0 and K2a at F % 8 != 0 take the scalar path):
    K1 within one bf16 ulp of its plain version, K2a bit-exact, K2b (f32
    sums of bf16 rows) within 1e-5 of max(|ref|, 1); each gives the same
    bits on a second call."""
    rng = np.random.default_rng(12)
    n, n_out = 37, 29
    idx = torch.tensor(gather_index(rng, layout, n, n_out, k), device=cuda)
    index = tg.TableIndex(idx, n)
    v = _bf16(rng, (n, f), cuda)
    w = _bf16(rng, (n_out * k, f), cuda)
    got = tg._launch_gather_mul_reduce(v, w, idx, k, False)
    _assert_k1_bf16_close(got, tg.gather_mul_reduce_plain(v, w, idx, k,
                                                          False))
    assert torch.equal(got, tg._launch_gather_mul_reduce(v, w, idx, k,
                                                         False))
    out = tg._launch_table_gather(v, idx, False)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tg.table_gather_plain(v, idx, False))
    assert torch.equal(out, tg._launch_table_gather(v, idx, False))
    sc = tg._launch_table_scatter(w, index, False)
    ref = tg.table_scatter_plain(w.float(), idx, n)
    assert sc.dtype == torch.float32
    torch.testing.assert_close(sc, ref, rtol=0,
                               atol=1e-5 * max(ref.abs().max().item(), 1.0))
    assert torch.equal(sc, tg._launch_table_scatter(w, index, False))


@pytest.mark.parametrize("f", [40, 128])
def test_bf16_gather_kernels_at_an_unaligned_offset(cuda, f):
    """bf16 views at a 2-byte storage offset take the scalar path and give
    the bits of the vector path (K1 8-byte lanes, K2a 16-byte lanes) on
    aligned copies."""
    rng = np.random.default_rng(13)
    n, n_out, k = 64, 64, 40
    idx = torch.tensor(gather_index(rng, "suffix", n, n_out, k), device=cuda)
    buf = _bf16(rng, 1 + n * f + n_out * k * f, cuda)
    v = buf[1:1 + n * f].view(n, f)
    w = buf[1 + n * f:].view(n_out * k, f)
    assert v.data_ptr() % 16 and w.data_ptr() % 16
    got = tg._launch_gather_mul_reduce(v, w, idx, k, False)
    _assert_k1_bf16_close(got, tg.gather_mul_reduce_plain(v, w, idx, k,
                                                          False))
    assert torch.equal(got, tg._launch_gather_mul_reduce(
        v.clone(), w.clone(), idx, k, False))
    out = tg._launch_table_gather(v, idx, False)
    assert torch.equal(out, tg._launch_table_gather(v.clone(), idx, False))
    with pytest.raises(TypeError):
        tg._launch_gather_mul_reduce(v.float(), w, idx, k, False)


@pytest.mark.parametrize("f", [128, 132])
def test_bf16_vector_and_scalar_paths_give_the_same_bits(cuda, f):
    """bf16 K1 through its 8-byte lanes (aligned rows, F % 4 == 0; two
    passes of the warps at F = 132) and through its scalar path (views at
    a 2-byte storage offset) gives the same bits: both sum each feature's
    products in the same order.  K2a is bit-exact against its plain
    version through both paths."""
    rng = np.random.default_rng(14)
    n, n_out, k = 64, 64, 40
    idx = torch.tensor(gather_index(rng, "interleaved", n, n_out, k),
                       device=cuda)
    buf = _bf16(rng, 1 + n * f + n_out * k * f, cuda)
    v = buf[1:1 + n * f].view(n, f)
    w = buf[1 + n * f:].view(n_out * k, f)
    assert v.data_ptr() % 8 and w.data_ptr() % 8
    va, wa = v.clone(), w.clone()
    assert va.data_ptr() % 16 == 0 and wa.data_ptr() % 16 == 0
    vec = tg._launch_gather_mul_reduce(va, wa, idx, k, False)
    assert torch.equal(vec, tg._launch_gather_mul_reduce(v, w, idx, k,
                                                         False))
    _assert_k1_bf16_close(vec, tg.gather_mul_reduce_plain(va, wa, idx, k,
                                                          False))
    ref = tg.table_gather_plain(va, idx, False)
    assert torch.equal(tg._launch_table_gather(va, idx, False), ref)
    assert torch.equal(tg._launch_table_gather(v, idx, False), ref)


def test_bf16_gather_autograd_runs_the_bf16_kernels(cuda):
    """split=False forward, backward and grad-of-grad on CUDA tensors
    launch only the bf16 instantiations and match the plain versions'
    autograd (bf16 outputs within one ulp)."""
    rng = np.random.default_rng(2)
    n, f, k = 20, 16, 6
    idx = torch.tensor(rng.integers(0, n + 1, size=n * k), dtype=torch.int32,
                       device=cuda)
    ct = torch.tensor(rng.normal(size=(n, f)), dtype=torch.float32,
                      device=cuda).to(torch.bfloat16)
    results = {}
    for dev in (cuda, torch.device("cpu")):
        index = tg.TableIndex(idx.to(dev), n)
        v = _bf16(np.random.default_rng(3), (n, f), dev).requires_grad_()
        w = _bf16(np.random.default_rng(4), (n * k, f),
                  dev).requires_grad_()
        mt.ops.reset_counts()
        out = tg.gather_mul_reduce(v, w, index, k, False)
        dv, dw = torch.autograd.grad((out * ct.to(dev)).sum(), (v, w),
                                     create_graph=True)
        (ddv,) = torch.autograd.grad((dw.float() ** 2).sum(), v)
        results[dev.type] = (out, dv, dw, ddv)
        if dev.type == "cuda":
            counts = mt.ops.counts()
            # K2b's CSR inverse is dtype-free: one build per index
            assert {k: c for k, c in counts["launches"].items() if c} == {
                "table_index_csr": 1}
            assert counts["launches_bf16"] == {
                "gather_mul_reduce": 1, "table_gather": 1,
                "table_scatter": 2}
            assert sum(counts["plain_calls_bf16"].values()) == 0
    for got, ref in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(got.cpu().float(), ref.float(),
                                   rtol=2.0 ** -7,
                                   atol=1e-5 * max(ref.float().abs().max()
                                                   .item(), 1.0))


def test_bf16_shifted_softplus_matches_the_cpu(cuda):
    """The bf16 shifted softplus, its derivative and second derivative
    give the CPU's bits on the card (the CPU's are JAX's,
    tests/test_torch_precision.py): log(2) is subtracted rounded to bf16
    on both, where a Python float stays f32 on the card."""
    from mdgrad_tpu_torch.nn.layers import shifted_softplus
    x = torch.tensor(np.random.default_rng(1).standard_normal(4096) * 6,
                     dtype=torch.float32).to(torch.bfloat16)
    results = {}
    for dev in (cuda, torch.device("cpu")):
        xd = x.to(dev).requires_grad_()
        y = shifted_softplus(xd)
        (g1,) = torch.autograd.grad(y.sum(), xd, create_graph=True)
        (g2,) = torch.autograd.grad(g1.float().sum(), xd)
        results[dev.type] = [t.detach().cpu() for t in (y, g1, g2)]
    for got, ref in zip(results["cuda"], results["cpu"]):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, ref)

def test_rdf_kernel_matches_plain(cuda):
    system = mt.System.from_lattice("fcc", 3, 1.679)
    rng = np.random.default_rng(1)
    frames = torch.tensor(
        np.stack([system.positions + rng.normal(0, 0.05, (108, 3))
                  for _ in range(3)]), dtype=torch.float32, device=cuda)
    obs = mt.observables.rdf(system, 48, (0.75, 2.0), backend="pallas",
                             device=cuda)
    op = obs._counts
    # f32 sums of thousands of exponentials in another order
    for xs in (frames[:1], frames):
        torch.testing.assert_close(
            trdf._launch(xs.contiguous(), op.cell_len, op.mu, op.coeff,
                         op.cutoff),
            trdf.rdf_counts_plain(xs, op.cell_len, op.mu, op.coeff,
                                  op.cutoff), rtol=1e-5, atol=1e-3)


def test_rdf_backward_kernel_matches_plain(cuda):
    """K3b/K4b against the plain backward at F = 1 and 3, and autograd
    through the counts launching it.  f32 sums of ~1e3 terms per site in
    another order: ~1e-6 of the largest entry; the bound is 1e-4 of it."""
    system = mt.System.from_lattice("fcc", 3, 1.679)
    rng = np.random.default_rng(2)
    frames = torch.tensor(
        np.stack([system.positions + rng.normal(0, 0.05, (108, 3))
                  for _ in range(3)]), dtype=torch.float32, device=cuda)
    obs = mt.observables.rdf(system, 48, (0.75, 2.0), backend="pallas",
                             device=cuda)
    op = obs._counts
    ct = torch.tensor(rng.normal(size=48), dtype=torch.float32, device=cuda)
    for xs in (frames[:1], frames):
        ref = trdf.rdf_counts_bwd_plain(xs, op.cell_len, op.mu, op.coeff,
                                        op.cutoff, ct)
        got = trdf._launch_bwd(xs.contiguous(), op.cell_len, op.mu,
                               op.coeff, op.cutoff, ct)
        assert got.shape == xs.shape
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * ref.abs().max().item())
    x = frames.clone().requires_grad_(True)
    ops.reset_counts()
    (g,) = torch.autograd.grad(op.frames(x), x, ct)
    counts = ops.counts()
    assert counts["launches"]["rdf_counts_bwd"] == 1
    assert counts["plain_calls"]["rdf_counts_bwd"] == 0
    torch.testing.assert_close(g, ref, rtol=0,
                               atol=1e-4 * ref.abs().max().item())


def test_rdf_reach_arg_is_the_kernels(cuda):
    """The library's kReachArg, by which K3/K4 and K3b/K4b skip terms, is
    the REACH_ARG that ops/rdf.py's reach (and the exact-zero checks) use."""
    from mdgrad_tpu_torch.ops import _build
    assert _build.library().mdg_rdf_reach_arg() == trdf.REACH_ARG


@pytest.mark.parametrize("case", rdf_edge_cases(), ids=lambda c: c[0])
def test_rdf_kernels_on_edge_cases(cuda, case):
    """K3/K4 and K3b/K4b against their plain versions on the cases their
    design special-cases (ops/time_rdf.py: N = 2, 33, 100, 1372; F = 1, 3,
    10; 1500 bins; unsorted centres with uneven widths; an unbounded bin;
    pairs at the cutoff, at +-L/2 and past a box), each giving the same
    bits on a second call.  f32 sums in another order: the forward within
    1e-4 of max(largest bin, 1), the backward within 1e-4 of the largest
    |dxyz|, as in chip_smoke.py."""
    _, xyz, cell, mu, widths, cutoff, ct = case
    op = trdf.RDFCounts(cell, mu, widths, cutoff, cuda)
    x = torch.tensor(xyz, device=cuda)
    ct = torch.tensor(ct, device=cuda)
    args = (op.cell_len, op.mu, op.coeff, op.cutoff)
    got = trdf._launch(x, *args)
    ref = trdf.rdf_counts_plain(x, *args)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * max(
        ref.abs().max().item(), 1.0))
    assert torch.equal(got, trdf._launch(x, *args))
    got = trdf._launch_bwd(x, *args, ct)
    ref = trdf.rdf_counts_bwd_plain(x, *args, ct)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-4 * ref.abs().max().item())
    assert torch.equal(got, trdf._launch_bwd(x, *args, ct))


def test_force_grad_of_grad_through_kernels_matches_plain_gather(cuda):
    """The vector-Jacobian product of the SchNet force with respect to the
    positions and the parameters (the replay adjoint's inner product) through
    K1/K2a/K2b against the plain gather path, same seeded weights; f32
    through two convolutions' second derivatives in another order."""
    L = get_unit_len(0.99749, 18.01528, 8)
    system = mt.System.from_lattice("diamond", 2, L, symbol="O")
    rng = np.random.default_rng(5)
    xyz = system.positions + 0.1 * rng.standard_normal((64, 3))
    u = torch.tensor(rng.standard_normal((64, 3)), dtype=torch.float32,
                     device=cuda)
    widths = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
              "n_convolutions": 2, "cutoff": 6.0}
    vjps = {}
    for mode in ("pallas", "gather"):
        inter = mt.GNNPotentials(system, mt.SchNet(
            {**widths, "gather_mode": mode}, seed=0), cutoff=6.0,
            capacity_slack=1.25, device=cuda)
        integ = mt.NoseHooverChain(inter, system, T=298.0, device=cuda)
        x = torch.tensor(xyz, dtype=torch.float32, device=cuda,
                         requires_grad=True)
        params = [p for p in inter.parameters() if p.requires_grad]
        f = integ.force(x, inter.aux_init(x.detach()), create_graph=True)
        ops.reset_counts()
        grads = torch.autograd.grad((f * u).sum(), [x, *params],
                                    allow_unused=True, materialize_grads=True)
        vjps[mode] = torch.cat([g.reshape(-1) for g in grads])
        counts = ops.counts()
        assert sum(counts["plain_calls"].values()) == 0
        if mode == "gather":
            assert sum(counts["launches"].values()) == 0
        else:
            # over the two convolutions: the backwards of the force's K2a
            # and K2b nodes and of the K1 nodes whose inputs need a
            # gradient (the same counts as the plain versions' on the CPU)
            assert counts["launches"]["table_gather"] == 3
            assert counts["launches"]["table_scatter"] == 4
    scale = vjps["gather"].abs().max().item()
    assert scale > 0
    torch.testing.assert_close(vjps["pallas"], vjps["gather"], rtol=0,
                               atol=1e-4 * scale)


def test_schnet_force_through_kernels_matches_plain_gather(cuda):
    """64 water sites, narrow widths: the force through K1/K2a/K2b against
    the plain gather path, same seeded weights (f32 through two
    convolutions in another order)."""
    L = get_unit_len(0.99749, 18.01528, 8)
    system = mt.System.from_lattice("diamond", 2, L, symbol="O")
    rng = np.random.default_rng(5)
    xyz = system.positions + 0.1 * rng.standard_normal((64, 3))
    widths = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
              "n_convolutions": 2, "cutoff": 6.0}
    forces = {}
    for mode in ("pallas", "gather"):
        inter = mt.GNNPotentials(system, mt.SchNet(
            {**widths, "gather_mode": mode}, seed=0), cutoff=6.0,
            capacity_slack=1.25, device=cuda)
        x = torch.tensor(xyz, dtype=torch.float32, device=cuda,
                         requires_grad=True)
        ops.reset_counts()
        (g,) = torch.autograd.grad(inter.energy(x, inter.aux_init(x)), x)
        forces[mode] = -g
        # 'pallas' launches K1 per convolution and K2a/K2b in its backward;
        # 'gather' runs K1's plain version and launches nothing
        launched = ops.counts()["launches"]
        if mode == "gather":
            assert sum(launched.values()) == 0
        else:
            assert launched["gather_mul_reduce"] == 2
            assert launched["table_gather"] == 2
            assert launched["table_scatter"] == 2
    scale = forces["gather"].abs().max().item()
    torch.testing.assert_close(forces["pallas"], forces["gather"],
                               atol=1e-4 * scale, rtol=0)


def _lj_inputs(cuda, n_cells=3, seed=0):
    """Perturbed FCC at a = 1.679 on the card (108 atoms at 3 cells), its
    cell lengths, and a seeded cotangent."""
    system = mt.System.from_lattice("fcc", n_cells, 1.679)
    rng = np.random.default_rng(seed)
    n = system.get_number_of_atoms()
    xyz = torch.tensor(system.positions + rng.normal(0, 0.05, (n, 3)),
                       dtype=torch.float32, device=cuda)
    w = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                     device=cuda)
    return system, np.diag(system.cell), xyz, w


@pytest.mark.parametrize("rep,attr", [(12, 6), (9, 6), (12, 0)])
def test_lj_kernels_match_plain(cuda, rep, attr):
    """K5, K6, K6b and K7 against their plain versions on the card, at 108
    atoms and 100 of them (the bounds mask); f32 sums of ~100 pair terms
    per row in another order: ~1e-6 relative."""
    system, cell, xyz108, w108 = _lj_inputs(cuda)
    sigma = torch.tensor(0.95, device=cuda)
    eps = torch.tensor(1.1, device=cuda)
    from mdgrad_tpu_torch.ops import pair as tp
    args = (cell, 2.4, sigma, eps, rep, attr)
    for n in (108, 100):
        xyz, w = xyz108[:n].contiguous(), w108[:n].contiguous()
        e, f = tp._launch_energy_forces(xyz, *args)
        e_ref, f_ref = tp.lj_energy_forces_plain(xyz, *args)
        scale = max(f_ref.abs().max().item(), 1.0)
        torch.testing.assert_close(f, f_ref, rtol=0, atol=1e-5 * scale)
        torch.testing.assert_close(e, e_ref, rtol=1e-4, atol=0)
        torch.testing.assert_close(tp._launch_force(xyz, *args), f_ref,
                                   rtol=0, atol=1e-5 * scale)
        got = tp._launch_force_vjp(xyz, w, *args)
        ref = tp.lj_force_vjp_plain(xyz, w, *args)
        torch.testing.assert_close(
            got[0], ref[0], rtol=0,
            atol=1e-5 * max(ref[0].abs().max().item(), 1.0))
        for a, b in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=0)
        got = tp._launch_force_param(xyz, *args)
        ref = tp.lj_force_param_plain(xyz, *args)
        torch.testing.assert_close(got[0], f_ref, rtol=0, atol=1e-5 * scale)
        for a, b in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=0)
    with pytest.raises(TypeError):
        tp._launch_force(xyz108.double(), cell, 2.4, sigma.double(),
                         eps.double())
    with pytest.raises(TypeError):
        tp.make_lj_force(cell, 2.4)(xyz108.double(), 0.95, 1.1)


def test_pallas_lj_pair_launches_force_and_vjp(cuda):
    """PallasLJPair's force and its gradient into (xyz, sigma, epsilon)
    on CUDA tensors launch K6 and K6b, never a plain version, and match
    autograd through the plain force."""
    system, cell, xyz, w = _lj_inputs(cuda, seed=1)
    inter = mt.ops.PallasLJPair(system, 2.4, sigma=0.95, epsilon=1.1,
                                device=cuda)
    x = xyz.clone().requires_grad_(True)
    wrt = [x, inter.sigma, inter.epsilon]
    ops.reset_counts()
    grads = torch.autograd.grad((inter.force(x, ()) * w).sum(), wrt)
    counts = ops.counts()
    assert counts["launches"]["lj_force"] == 1
    assert counts["launches"]["lj_force_vjp"] == 1
    assert sum(counts["plain_calls"].values()) == 0
    from mdgrad_tpu_torch.ops import pair as tp
    ref = torch.autograd.grad((tp.lj_force_plain(
        x, cell, 2.4, inter.sigma, inter.epsilon) * w).sum(), wrt)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * max(b.abs().max().item(), 1.0))


@pytest.mark.parametrize("cluster", [True, False], ids=["cluster", "grid"])
@pytest.mark.parametrize("case", csr_index_cases(), ids=lambda c: c[0])
def test_table_index_csr_kernel_matches_plain(cuda, case, cluster):
    """The CSR kernel, its cluster build (where the case fits it; the
    grid build past its capacity: the 4096-row tables, 48668 rows, a key
    of more than 65536 edges, each side of a digit) and its grid build
    forced, is integer-equal to the plain build and gives the same
    integers twice; K2b gives the same bits through either CSR."""
    _, idx_np, n = case
    idx = torch.tensor(idx_np, device=cuda)
    ops.reset_counts()
    order, rowptr = tg._launch_table_index_csr(idx, n, cluster=cluster)
    assert ops.counts()["launches"]["table_index_csr"] == 1
    ref_order, ref_rowptr = tg.table_index_csr_plain(idx, n)
    assert torch.equal(order, ref_order) and torch.equal(rowptr, ref_rowptr)
    again = tg._launch_table_index_csr(idx, n, cluster=cluster)
    assert torch.equal(again[0], order) and torch.equal(again[1], rowptr)
    g = torch.tensor(np.random.default_rng(9).normal(size=(len(idx_np), 16)),
                     dtype=torch.float32, device=cuda)
    out = []
    for csr in ((order, rowptr), (ref_order, ref_rowptr)):
        index = tg.TableIndex(idx, n)
        index._csr = csr
        out.append(tg._launch_table_scatter(g, index))
    assert torch.equal(out[0], out[1])


def test_table_index_csr_four_digits(cuda):
    """Past 2^24 rows the grid build takes four 8-bit passes (the cases
    above reach three): integer-equal to the plain build, twice."""
    n = 2 ** 24 + 5
    idx = torch.tensor(np.random.default_rng(10).integers(
        -1, n + 2, size=20000), dtype=torch.int32, device=cuda)
    ref = tg.table_index_csr_plain(idx, n)
    for _ in range(2):
        got = tg._launch_table_index_csr(idx, n)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_table_index_builds_its_csr_on_the_card(cuda):
    idx = torch.tensor(dict((name, idx) for name, idx, _
                            in csr_index_cases())["rows_past_capacity"],
                       device=cuda)
    ops.reset_counts()
    order, rowptr = tg.TableIndex(idx, 512).csr()
    counts = ops.counts()
    assert counts["launches"]["table_index_csr"] == 1
    assert counts["plain_calls"]["table_index_csr"] == 0
    assert order.is_cuda and rowptr.shape == (513,)


def test_table_index_csr_path(cuda):
    """The build the library takes is the one ``table_index_csr_path``
    names, on each side of the cluster build's capacity: the cluster
    build at every water table (K = 16 to 72 at n = 512) up to 65536
    edges and 2047 rows, the grid past either."""
    from mdgrad_tpu_torch.ops import _build
    lib = _build.library()
    max_e, max_n = tg.CSR_CLUSTER_MAX_EDGES, tg.CSR_CLUSTER_MAX_ROWS
    for e, n in [(512 * k, 512) for k in (16, 40, 48, 56, 72)] + [
            (max_e, 512), (max_e + 1, 512), (8192, max_n),
            (8192, max_n + 1), (max_e, max_n), (max_e + 1, max_n + 1)]:
        path = tg.table_index_csr_path(e, n)
        assert path == ("cluster" if lib.mdg_table_index_csr_cluster(e, n)
                        else "grid")
    assert tg.table_index_csr_path(512 * 72, 512) == "cluster"
    assert tg.table_index_csr_path(max_e + 1, 512) == "grid"
    assert tg.table_index_csr_path(8192, max_n + 1) == "grid"


SCATTER_F = (*GATHER_F, 256)   # 256: more than one warp a row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", GATHER_LAYOUTS)
@pytest.mark.parametrize("f", SCATTER_F)
def test_table_scatter_kernel_on_edge_cases(cuda, f, layout, dtype):
    """K2b, f32 and bf16 (split=False, f32 sums out), against its plain
    version within 1e-5 of max(|ref|, 1) (f32 sums in another order than
    index_add's), the same bits twice: the 8-byte lanes (2 f32 or 4 bf16,
    aligned) and the scalar instantiation (F = 1, 3, bf16 at F = 130, or a
    view at a 4- or 2-byte offset) on the four sentinel layouts, with
    four empty rows, one row of more than 64 edges (three 32-edge
    batches, the last one short) and in-degrees that are not multiples
    of the 32-row batch.  Both instantiations add each feature in
    ascending edge order, so the view gives the aligned copy's bits."""
    rng = np.random.default_rng(14)
    n, n_out, k = 37, 29, 40
    idx_np = gather_index(rng, layout, n, n_out, k)
    idx_np[np.isin(idx_np, [5, 11, 17, 23])] = 6
    degree = np.bincount(idx_np[(idx_np >= 0) & (idx_np < n)], minlength=n)
    assert degree[5] == degree[11] == 0 and degree[6] > 64
    assert (degree % 32 != 0).any()
    idx = torch.tensor(idx_np, device=cuda)
    index = tg.TableIndex(idx, n)
    split = dtype == torch.float32
    e = idx_np.size
    buf = torch.tensor(rng.normal(size=1 + e * f), dtype=torch.float32,
                       device=cuda).to(dtype)
    view = buf[1:].view(e, f)
    assert view.is_contiguous() and view.data_ptr() % 8 != 0
    ref = tg.table_scatter_plain(view.float(), idx, n)
    outs = []
    for g in (view.clone(), view):
        got = tg._launch_table_scatter(g, index, split)
        assert got.dtype == torch.float32 and got.shape == (n, f)
        torch.testing.assert_close(
            got, ref, rtol=0, atol=1e-5 * max(ref.abs().max().item(), 1.0))
        assert torch.equal(got, tg._launch_table_scatter(g, index, split))
        outs.append(got)
    assert torch.equal(outs[0], outs[1])
    assert not outs[0][5].any() and not outs[0][11].any()


# K5, K6 and K6b: three modes of the i < j walk (K7, the fourth, has its
# own test below)
HALF_WALKS = ("lj_energy_forces", "lj_force", "lj_force_vjp")


def _check_half_walks(xyz, w, args, names=HALF_WALKS):
    """``names`` against their plain versions: vectors within 1e-5 of
    max(|ref|, 1), scalars within 1e-4 relative (f32 sums of ~100 pair
    terms per atom in another order), the same bits on a second call.
    {name: (vector, plain vector)}."""
    from mdgrad_tpu_torch.ops import pair as tp
    out = {}
    for name in names:
        launch, plain = tp._KERNELS[name]
        vec = (xyz, w) if name == "lj_force_vjp" else (xyz,)
        got = split(name, launch(*vec, *args))
        ref = split(name, plain(*vec, *args))
        again = split(name, launch(*vec, *args))
        torch.testing.assert_close(
            got[0], ref[0], rtol=0,
            atol=1e-5 * max(ref[0].abs().max().item(), 1.0), msg=name)
        for a, b in zip(got[1], ref[1]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=0, msg=name)
        for a, b in zip((got[0], *got[1]), (again[0], *again[1])):
            assert torch.equal(a, b), name
        out[name] = got[0], ref[0]
    return out


@pytest.mark.parametrize("n_cells,n,unwrap", [
    (3, 2, False), (3, 100, False), (3, 108, False), (7, 1372, False),
    (10, 4000, False), (13, 8788, False), (7, 1372, True)])
def test_lj_force_kernel_matches_plain(cuda, n_cells, n, unwrap):
    """K6's i < j walk, and K5 and K6b on the same template, against their
    plain versions (``_check_half_walks``), each giving the same bits on a
    second call; unwrapped positions (moved by -2 to 2 cells) make the
    blocks take the IEEE image."""
    from mdgrad_tpu_torch.ops import _build, pair as tp
    assert _build.library().mdg_force_tile() == tp.FORCE_TILE
    _, cell, xyz, w = _lj_inputs(cuda, n_cells)
    xyz, w = xyz[:n].contiguous(), w[:n].contiguous()
    if unwrap:
        xyz = torch.tensor(unwrapped(xyz.cpu().numpy(), cell), device=cuda)
    _check_half_walks(xyz, w, (cell, 2.5, torch.tensor(0.95, device=cuda),
                               torch.tensor(1.1, device=cuda)))


@pytest.mark.parametrize("case", lj_edge_cases(),
                         ids=lambda c: f"L{c[0]}-axis{c[1]}")
def test_lj_force_kernel_on_image_edges(cuda, case):
    """K6, K5 and K6b take the same image decisions as the plain versions
    at d = +-L/2, one ulp on each side, at the thresholds and past a box
    length."""
    _, _, xyz_np, cell, cutoff, sigma = case
    xyz = torch.tensor(xyz_np, device=cuda)
    _check_half_walks(xyz, pair_image_w(xyz, cell), (
        cell, cutoff, torch.tensor(sigma, dtype=torch.float32, device=cuda),
        torch.tensor(1.0, device=cuda)))


def test_lj_half_walks_at_the_cutoff_edge(cuda):
    """Pairs whose r^2 lies within an ulp of cutoff^2, out by the plain
    versions' stepwise sum and in by a fused one: K5, K6 and K6b leave out
    exactly the pairs the plain versions leave out (one pair counts)."""
    xyz_np, cell, _ = cutoff_edge_case(2.5)
    xyz = torch.tensor(xyz_np, device=cuda)
    res = _check_half_walks(xyz, pair_image_w(xyz, cell), (
        cell, 2.5, torch.tensor(0.9, device=cuda),
        torch.tensor(1.0, device=cuda)))
    for name, (got, ref) in res.items():
        live = ref.abs().sum(1) > 0
        assert int(live.sum()) == 2, name
        assert torch.equal(got.abs().sum(1) > 0, live), name


def test_lj_force_param_kernel_on_walk_edges(cuda):
    """K7, mode 3 of the i < j walk, against its plain version where the
    walk's corners lie: N = 2, positions unwrapped by -2 to 2 cells (the
    IEEE image), the minimum image's edges, and the cutoff edge, where it
    leaves out exactly the pairs its plain version leaves out; the same
    bits on a second call."""
    params = (torch.tensor(0.95, device=cuda), torch.tensor(1.1, device=cuda))
    only = ("lj_force_param",)
    _, cell, xyz, _ = _lj_inputs(cuda, 7)
    _check_half_walks(xyz[:2].contiguous(), None, (cell, 2.5, *params), only)
    far = torch.tensor(unwrapped(xyz.cpu().numpy(), cell), device=cuda)
    _check_half_walks(far, None, (cell, 2.5, *params), only)
    for _, _, xyz_np, cell, cutoff, sigma in lj_edge_cases():
        _check_half_walks(torch.tensor(xyz_np, device=cuda), None, (
            cell, cutoff,
            torch.tensor(sigma, dtype=torch.float32, device=cuda),
            torch.tensor(1.0, device=cuda)), only)
    xyz_np, cell, _ = cutoff_edge_case(2.5)
    (got, ref), = _check_half_walks(torch.tensor(xyz_np, device=cuda), None, (
        cell, 2.5, torch.tensor(0.9, device=cuda),
        torch.tensor(1.0, device=cuda)), only).values()
    live = ref.abs().sum(1) > 0
    assert int(live.sum()) == 2
    assert torch.equal(got.abs().sum(1) > 0, live)


def test_lj_scratch_is_ops_pair_mirror(cuda):
    """The library's mdg_lj_scratch, by which the wrappers size their
    buffers, is ops/pair.py's lj_scratch for every kernel and size, and
    refuses a bad mode, n or buffer."""
    from mdgrad_tpu_torch.ops import _build, pair as tp
    lib = _build.library()
    for mode, name in enumerate(tp._MODES):
        for n in (1, 2, 63, 64, 65, 100, 1372, 4000, 8788):
            assert tuple(lib.mdg_lj_scratch(mode, n, which)
                         for which in (0, 1)) == tp.lj_scratch(name, n)
    assert lib.mdg_lj_scratch(4, 10, 0) == -1
    assert lib.mdg_lj_scratch(0, 0, 0) == -1
    assert lib.mdg_lj_scratch(0, 10, 2) == -1


def test_ewald_f32_on_the_card_matches_cpu_f64(cuda):
    """The molten salt's Ewald (216 ions, a = 6.2 A, r_cut 9.114 A, 618
    half-space k-vectors) in float32 on the card against float64 on the
    CPU at the same melt-like positions: U within 1e-6 of |U|, forces
    within 1e-4 of the largest (the CPU's own float32 lies 4e-8 and 2e-6
    away).  TF32 in the phase product misses both: at the melt of
    ``chip_smoke.py``'s phase 4m it lies 1.5e-5 and 4.5e-3 away (H100)."""
    from mdgrad_tpu_torch.train import fit_salt as fs
    system = fs.rocksalt_melt(rng=np.random.default_rng(0))
    pos = system.get_positions() + 0.6 * np.random.default_rng(1).normal(
        size=(216, 3))
    pattern = np.where(system.get_atomic_numbers() == 11, 1.0, -1.0)
    out = {}
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        ew = fs.ScaledChargeEwald(system, pattern, 0.8, r_cut=9.114,
                                  device=device).to(dtype)
        assert ew.nvecs.shape == (618, 3)
        x = torch.tensor(pos, dtype=dtype, device=device, requires_grad=True)
        u = ew.energy(x, ())
        u.backward()
        out[dtype] = (u.item(), x.grad.double().cpu())
    (u32, g32), (u64, g64) = out[torch.float32], out[torch.float64]
    assert abs(u32 - u64) <= 1e-6 * abs(u64)
    assert (g32 - g64).abs().max() <= 1e-4 * g64.abs().max()


def test_profiling_trace_records_the_card(cuda, tmp_path):
    """``profiling.trace`` records the card's kernels and ``busy_us``
    reads their busy time; ``time_fn`` synchronizes on a card output."""
    from mdgrad_tpu_torch import profiling
    x = torch.randn(1 << 20, device=cuda)
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(3):
            x = x * 1.0001
        torch.cuda.synchronize()
    busy, n = profiling.busy_us(prof.events(),
                                torch.autograd.DeviceType.CUDA)
    assert n >= 3 and busy > 0
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert profiling.time_fn(lambda: x * 2.0, iters=3) > 0


def test_sharded_schnet_nccl_world_of_one(cuda, tmp_path):
    """A 32-atom SchNet epoch through ``ShardedGNNPotentials`` in an NCCL
    world of one equals the unsharded epoch (loss and parameter
    gradients to 1e-5 of the largest), and launches K1, K2a, K2b and the
    CSR build."""
    import torch.distributed as dist
    from mdgrad_tpu_torch.parallel import ShardedGNNPotentials, make_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh({"sp": 1})
        got = {}
        for sharded in (True, False):
            s = mt.System.from_lattice("fcc", 2, 1.76)
            s.set_temperature(1.0 / mt.units.kB,
                              rng=np.random.default_rng(0))
            gnn = mt.SchNet({"n_atom_basis": 16, "n_filters": 16,
                             "n_gaussians": 8, "n_convolutions": 2,
                             "cutoff": 1.6})
            inter = mt.GNNPotentials(s, gnn, cutoff=1.6, nbr_mode="table",
                                     k_max=16, device=cuda)
            if sharded:
                inter = ShardedGNNPotentials(inter, mesh)
            integ = mt.NoseHooverChain(inter, s, T=1.0 / mt.units.kB,
                                       num_chains=3, Q=50.0, adjoint=True,
                                       device=cuda)
            sim = mt.Simulation(s, integ)
            state, aux = sim.initial_state()
            ops.reset_counts()
            traj, _ = sim.epoch_fn(dt=0.005, frequency=5)(
                state, aux, integ.default_ctrl())
            loss = (traj.q[-1] ** 2).sum()
            loss.backward()
            if sharded:
                inter.reduce_grads()
            got[sharded] = (loss.detach(), torch.cat([
                (torch.zeros_like(p) if p.grad is None else p.grad)
                .reshape(-1) for p in gnn.parameters()]), ops.counts())
        for name in ("gather_mul_reduce", "table_gather", "table_scatter",
                     "table_index_csr"):
            assert got[True][2]["launches"][name] > 0, name
        assert abs(got[True][0] - got[False][0]) <= 1e-5 * abs(got[False][0])
        scale = got[False][1].abs().max()
        assert scale > 0
        assert (got[True][1] - got[False][1]).abs().max() <= 1e-5 * scale
    finally:
        dist.destroy_process_group()
