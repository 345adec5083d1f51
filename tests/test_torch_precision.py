"""bf16 and 'mixed' SchNet in the port against the JAX package.

The 32-atom system of tests/test_schnet.py's precision tests (FCC 2^3 at
a = 2.9, displaced by 0.08 from a numpy seed; SchNet 32/32/16, 2
convolutions, cutoff 2.5), weights from the JAX init through
``nn/convert.py``.  bf16 rounds at other places in JAX's three
aggregation modes, so each comparison names its JAX mode: the port's
kernel modes against JAX ``gather_mode='pallas'`` (its Pallas kernels in
interpret mode, ``split=False``), the port's ``'gather'`` against JAX's.
The bound of each kernel-mode comparison is a quarter of JAX's own
difference between that dtype and f32 on the same inputs.

Also: the dense layer's two-op rounding, the bf16 shifted softplus and
its derivative, the ``split=False`` plain versions of K1, K2a and K2b
against the JAX ones, the port-only mirrors of
``test_bf16_compute_dtype_close_to_f32`` and
``test_mixed_precision_between_bf16_and_f32``, and one bf16 training
epoch's SchNet gradient against the JAX ``epoch_fn``'s.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.interface import GNNPotentials as GNNPotentialsJ
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.interface import Stack as StackJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.nn.layers import shifted_softplus as shifted_softplus_j
from mdgrad_tpu.ops import pallas_gather as pg
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import ops, units
from mdgrad_tpu_torch.data.registry import get_unit_len
from mdgrad_tpu_torch.nn.convert import (schnet_params_from_numpy,
                                         stack_params_from_numpy)
from mdgrad_tpu_torch.nn.layers import shifted_softplus
from mdgrad_tpu_torch.nn.schnet import linear
from mdgrad_tpu_torch.ops import gather as tg
from mdgrad_tpu_torch.train import fit_rdf

fit_rdf_j = importlib.import_module("mdgrad_tpu.train.fit_rdf")
PARAMS = {"n_atom_basis": 32, "n_filters": 32, "n_gaussians": 16,
          "n_convolutions": 2, "cutoff": 2.5}
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def xyz():
    s = SystemJ.from_lattice("fcc", 2, 2.9)
    rng = np.random.default_rng(5)
    return (s.get_positions()
            + 0.08 * rng.standard_normal((32, 3))).astype(np.float32)


def _jax_ef(xyz, cdt, mode):
    inter = GNNPotentialsJ(SystemJ.from_lattice("fcc", 2, 2.9), SchNetJ(
        {**PARAMS, "compute_dtype": cdt, "gather_mode": mode}), cutoff=2.5)
    p = inter.init_params()
    x = jnp.asarray(xyz)
    u, g = jax.value_and_grad(inter.energy, argnums=1)(p, x,
                                                       inter.aux_init(x))
    return float(u), -np.asarray(g), p


def _port_ef(xyz, cdt, mode, params):
    inter = mt.GNNPotentials(mt.System.from_lattice("fcc", 2, 2.9),
                             mt.SchNet({**PARAMS, "compute_dtype": cdt,
                                        "gather_mode": mode}),
                             cutoff=2.5, device="cpu")
    if params is not None:
        inter.gnn.load_state_dict(schnet_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params)))
    x = torch.tensor(xyz, requires_grad=True)
    u = inter.energy(x, inter.aux_init(x))
    (g,) = torch.autograd.grad(u, x)
    return u.item(), -g.numpy()


@pytest.fixture(scope="module")
def jax_results(xyz):
    """{(compute_dtype, gather_mode): (U, F, params)} of the JAX package
    (one init: every entry has the same weights)."""
    return {key: _jax_ef(xyz, *key) for key in (
        ("float32", "pallas"), ("bf16", "pallas"), ("mixed", "pallas"),
        ("bf16", "gather"))}


def test_dense_bf16_rounds_as_flax():
    """flax ``Dense(dtype=bf16)`` rounds the product to bf16 and then adds
    the bias in bf16; ``linear`` does the same in two ops and matches it
    but where the two f32 sums over 128 products, taken in other orders,
    round to neighbouring bf16 values (measured 2 of 81920 outputs, each
    one ulp of the product before the bias; bound 0.1%, within one ulp of
    the largest output).  ``F.linear`` fuses the bias and rounds once: it
    differs in more than 5% of the outputs (measured 27.5%)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((640, 128)).astype(np.float32)
    dense = fnn.Dense(128, dtype=jnp.bfloat16)
    p = dense.init(jax.random.PRNGKey(1), x)["params"]
    p = {"kernel": p["kernel"],
         "bias": jnp.asarray(rng.standard_normal(128), jnp.float32)}
    ref = np.asarray(dense.apply({"params": p}, x).astype(jnp.float32))
    layer = torch.nn.Linear(128, 128)
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(np.asarray(p["kernel"]).T))
        layer.bias.copy_(torch.tensor(np.asarray(p["bias"])))
    xt = torch.tensor(x)
    got = linear(layer, xt, BF16)
    assert got.dtype == BF16
    got = got.detach().float().numpy()
    assert (got != ref).mean() <= 1e-3
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())
    fused = torch.nn.functional.linear(xt.to(BF16), layer.weight.to(BF16),
                                       layer.bias.to(BF16))
    assert (fused.detach().float().numpy() != ref).mean() > 0.05


def test_shifted_softplus_bf16_matches_jax():
    """The bf16 shifted softplus, its derivative and second derivative
    give JAX's bits (jax.nn.softplus is logaddexp(x, 0) with a custom_jvp,
    rounded after every op)."""
    x = (np.random.default_rng(1).standard_normal(4096) * 6).astype(
        np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    f = lambda v: shifted_softplus_j(v).sum()
    d1 = jax.grad(f)
    d2 = jax.grad(lambda v: d1(v).astype(jnp.float32).sum())
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(BF16)
    xt.requires_grad_(True)
    y = shifted_softplus(xt)
    (g1,) = torch.autograd.grad(y.sum(), xt, create_graph=True)
    (g2,) = torch.autograd.grad(g1.float().sum(), xt)
    for got, ref in ((y, shifted_softplus_j(xj)), (g1, d1(xj)),
                     (g2, d2(xj))):
        assert got.dtype == BF16
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


def _index_case(n=37, k=12, n_out=29, seed=2):
    idx = np.random.default_rng(seed).integers(0, n + 3, size=n_out * k)
    return idx.astype(np.int32), n, k, n_out


def _bf16_pair(a):
    """(jnp bf16, torch bf16) of the same values."""
    aj = jnp.asarray(a).astype(jnp.bfloat16)
    return aj, torch.tensor(np.asarray(aj.astype(jnp.float32))).to(BF16)


def _eq_or_ulp(got, ref, ulps=1):
    """Equal up to ``ulps`` bf16 ulps of each value (sums of the same f32
    terms in another order, rounded once to bf16), or f32 order noise."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, rtol=ulps * 2.0 ** -7,
                               atol=1e-6 * scale)


def test_split_false_plain_versions_match_jax():
    """K1, K2a and K2b's ``split=False`` plain versions and their vjps
    against the JAX functions (interpret mode, split=False) on the same
    inputs, sentinels < 0, == n and > n included: K2a bit for bit, K1 and
    the f32-input K2b within one bf16 ulp / f32 order."""
    idx, n, k, n_out = _index_case()
    rng = np.random.default_rng(3)
    vj, vt = _bf16_pair(rng.standard_normal((n, 24)))
    wj, wt = _bf16_pair(rng.standard_normal((n_out * k, 24)))
    gf = rng.standard_normal((n_out * k, 24)).astype(np.float32)
    ctj, ctt = _bf16_pair(rng.standard_normal((n_out, 24)))
    idxj = jnp.asarray(idx)
    index = tg.TableIndex(torch.tensor(idx), n)
    # K2a: a copy of bf16 rows, f32 rows rounded to bf16 and widened back
    np.testing.assert_array_equal(
        tg.table_gather(vt, index, False).float().numpy(),
        np.asarray(pg.table_gather(vj, idxj, False, True).astype(
            jnp.float32)))
    got = tg.table_gather(torch.tensor(gf[:n]), index, False)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        pg.table_gather(jnp.asarray(gf[:n]), idxj, False, True)))
    # K2b on f32 g (the K1 backward's case): bf16 rounding, f32 sums
    got = tg.table_scatter(torch.tensor(gf), index, False)
    assert got.dtype == torch.float32
    _eq_or_ulp(got.numpy(), pg.table_scatter(jnp.asarray(gf), idxj, n,
                                             False, True))
    # K1 forward and vjp (the JAX _gmr_bwd, cast for cast)
    out_j, vjp_j = jax.vjp(
        lambda v, w: pg.gather_mul_reduce(v, w, idxj, k, False, True),
        vj, wj)
    dv_j, dw_j = vjp_j(ctj)
    v, w = vt.clone().requires_grad_(), wt.clone().requires_grad_()
    out = tg.gather_mul_reduce(v, w, index, k, False)
    dv, dw = torch.autograd.grad(out, (v, w), ctt)
    for got, ref in ((out, out_j), (dv, dv_j), (dw, dw_j)):
        assert got.dtype == BF16
        _eq_or_ulp(got.detach().float().numpy(), ref.astype(jnp.float32))


def test_bf16_scatter_rounds_once():
    """A deliberate deviation (ROADMAP Queue 3): with bf16 ``g`` the JAX
    K2b adds its 512-edge tiles into a bf16 output, rounding once per
    tile; the port sums each row in f32 and rounds once.  Over 4 tiles the
    port stays within one bf16 ulp of the exact sum and JAX within four."""
    idx, n, _, _ = _index_case(n=16, k=128, n_out=16, seed=4)   # 2048 edges
    gj, gt = _bf16_pair(np.random.default_rng(5).standard_normal(
        (idx.size, 8)))
    exact = np.zeros((n + 1, 8))
    np.add.at(exact, np.minimum(idx, n), np.asarray(
        gj.astype(jnp.float32), np.float64))
    exact = exact[:n]
    got = tg.table_scatter(gt, tg.TableIndex(torch.tensor(idx), n), False)
    ref = pg.table_scatter(gj, jnp.asarray(idx), n, False, True)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    tol = 2.0 ** -8 * np.abs(exact) + 1e-6
    assert (np.abs(got.float().numpy() - exact) <= tol).all()
    assert (np.abs(np.asarray(ref.astype(jnp.float32)) - exact)
            <= 4 * 2.0 ** -7 * np.abs(exact).max()).all()


@pytest.mark.parametrize("cdt", ["bf16", "mixed"])
def test_schnet_matches_jax_pallas(xyz, jax_results, cdt):
    """Energy and forces in bf16 and 'mixed' (the port's kernel mode,
    here K1's plain version) against JAX ``'pallas'`` in the same dtype,
    within a quarter of JAX's own difference between that dtype and f32.
    Measured on the CPU: bf16 energy equal, forces 2.0e-4 against JAX's
    |bf16 - f32| 4.4e-3; mixed 1.8e-7 against 1.35e-3."""
    u32, f32, params = jax_results["float32", "pallas"]
    uj, fj, _ = jax_results[cdt, "pallas"]
    ops.reset_counts()
    ut, ft = _port_ef(xyz, cdt, "auto", params)
    calls = ops.counts()
    if cdt == "bf16":   # the split=False plain versions, forward and force
        assert calls["plain_calls_bf16"] == {
            "gather_mul_reduce": 2, "table_gather": 2, "table_scatter": 2}
        assert calls["plain_calls"]["gather_mul_reduce"] == 0
    else:
        assert sum(calls["plain_calls_bf16"].values()) == 0
        assert calls["plain_calls"]["gather_mul_reduce"] == 2
    own_f = np.abs(fj - f32).max()
    own_u = abs(uj - u32)
    assert own_f > 0 and own_u > 0
    assert abs(ut - uj) <= 0.25 * own_u
    assert np.abs(ft - fj).max() <= 0.25 * own_f


def test_schnet_gather_mode_bf16_matches_jax_gather(xyz, jax_results):
    """The port's 'gather' (K1's plain version called directly, each
    product rounded to bf16) against JAX 'gather' in bf16: the same
    roundings, so f32-order agreement (measured 1.4e-7 of forces ~1)."""
    uj, fj, params = jax_results["bf16", "gather"]
    ut, ft = _port_ef(xyz, "bf16", "gather", params)
    np.testing.assert_allclose(ut, uj, rtol=1e-6)
    np.testing.assert_allclose(ft, fj, atol=1e-5 * np.abs(fj).max())


def test_bf16_compute_dtype_close_to_f32(xyz):
    """Mirror of tests/test_schnet.py's test on the port alone."""
    us = {cdt: _port_ef(xyz, cdt, "auto", None)[0]
          for cdt in ("float32", "bf16")}
    assert np.isfinite(us["bf16"])
    np.testing.assert_allclose(us["bf16"], us["float32"], rtol=2e-2)


def test_mixed_precision_between_bf16_and_f32(xyz):
    """Mirror of tests/test_schnet.py's test on the port alone: 'mixed'
    tracks f32 forces far closer than bf16 does."""
    res = {cdt: _port_ef(xyz, cdt, "auto", None)
           for cdt in ("float32", "mixed", "bf16")}
    assert np.isfinite(res["mixed"][0])
    f32 = res["float32"][1]
    f_mixed = np.abs(res["mixed"][1] - f32).max()
    f_bf16 = np.abs(res["bf16"][1] - f32).max()
    assert f_mixed < 0.6 * f_bf16


# the water fit's shape at narrow width, cut to a 10-step epoch
L_WATER = get_unit_len(0.99749, 18.01528, 8)
WATER = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
         "n_convolutions": 2, "cutoff": 6.0}
TAG, NBINS, TAU, FRAME_SKIP = "H20_0.997_298K", 109, 11, 5


def _water(cls):
    s = cls.from_lattice("diamond", 2, L_WATER, symbol="O")
    s.masses = np.full(64, 18.01528)
    s.set_temperature(298.0, rng=np.random.default_rng(0))
    return s


def _jax_epoch_grads(cdt):
    s = _water(SystemJ)
    stack = StackJ({
        "nn": GNNPotentialsJ(s, SchNetJ({**WATER, "gather_mode": "pallas",
                                         "compute_dtype": cdt}),
                             cutoff=6.0, capacity_slack=1.25),
        "prior": PairPotentialsJ(s, potentials_j.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense")})
    integ = NoseHooverChainJ(stack, s, T=298.0, Q=50.0, num_chains=5,
                             adjoint=True)
    sim = SimulationJ(s, integ)
    _, g_target, obs = fit_rdf_j.get_observer(s, TAG, NBINS,
                                              backend="pallas")
    vg, _ = fit_rdf_j._make_epoch_loss(sim, obs, g_target, s, TAU,
                                       0.5 * units_j.fs, FRAME_SKIP)
    state, aux = sim.initial_state()
    (loss, _), grads = vg(sim.params, state, aux, integ.default_ctrl())
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return as_np(sim.params), float(loss), as_np(grads["nn"])


def _flat(tree):
    return np.concatenate([tree[k].numpy().ravel() for k in sorted(tree)])


def test_bf16_epoch_gradient_matches_jax():
    """One bf16 training epoch (10 steps of the 64-site water SchNet fit,
    the replay adjoint, the force's grad-of-grad through the split=False
    plain versions, the RDF loss) against the JAX ``_make_epoch_loss``
    with ``gather_mode='pallas'`` in interpret mode.  The bound is bf16's
    own scale: each parameter's gradient, against JAX's own |bf16 - f32|
    difference of that parameter.  Weights within 0.6 of it (measured at
    most 0.47, the readout's last layer).  Every parameter within 1.25 of
    it: JAX on the CPU sums a bf16 bias gradient (the transpose of the
    broadcast add) in bf16 partial sums, the port in f32 (ROADMAP Queue 3),
    which sets the edge filters' biases of the first convolution, summed
    over every edge (measured 0.94 and 1.02).  The loss to rtol 5e-6
    (measured 1.0e-6; its own bf16 - f32 difference is 1.2e-6)."""
    params_j, loss_j, grads_j = _jax_epoch_grads("bf16")
    _, _, grads_32 = _jax_epoch_grads("float32")
    s = _water(mt.System)
    stack = mt.Stack({
        "nn": mt.GNNPotentials(s, mt.SchNet({**WATER,
                                             "compute_dtype": "bf16"}),
                               cutoff=6.0, capacity_slack=1.25, device="cpu"),
        "prior": mt.PairPotentials(s, mt.potentials.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense",
            device="cpu")})
    stack.load_state_dict(stack_params_from_numpy(params_j, stack))
    fit_rdf.fit_parameters(stack)
    integ = mt.NoseHooverChain(stack, s, T=298.0, Q=50.0, num_chains=5,
                               device="cpu")
    sim = mt.Simulation(s, integ)
    _, g_target, obs = fit_rdf.get_observer(s, TAG, NBINS, backend="pallas",
                                            device="cpu")
    loss_fn = fit_rdf.make_epoch_loss(sim, obs, g_target, s, TAU,
                                      0.5 * units.fs, FRAME_SKIP)
    ops.reset_counts()
    loss, _ = loss_fn(*sim.initial_state(), integ.default_ctrl())
    assert ops.counts()["plain_calls"]["gather_mul_reduce"] == 0
    np.testing.assert_allclose(loss.item(), loss_j, rtol=5e-6)
    got = {name: torch.zeros_like(p) if p.grad is None else p.grad
           for name, p in stack.models["nn"].gnn.named_parameters()}
    ref = schnet_params_from_numpy(grads_j)
    ref_32 = schnet_params_from_numpy(grads_32)
    assert got.keys() == ref.keys()
    for name in ref:
        err = (got[name] - ref[name]).abs().max().item()
        own = (ref[name] - ref_32[name]).abs().max().item()
        ratio = 0.6 if name.endswith("weight") else 1.25
        assert err <= ratio * own + 1e-9, (name, err, own)
