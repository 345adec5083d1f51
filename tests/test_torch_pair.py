"""The port's LJ pair kernels' plain versions (mdgrad_tpu_torch/ops/pair.py:
K5 energy and forces, K6 force, K6b its vjp, K7 force and parameter sums)
against the JAX package's Pallas kernels in interpret mode and its dense
XLA path, on the perturbed 108-atom FCC box of tests/test_pallas.py; and
the i < j decomposition that the one CUDA walk of all four kernels takes
(its sums, its block map, its scratch sizes), which runs here with no
card.

float32 comparisons run the same inputs through both packages; float64
ones run the JAX side inside ``jax.enable_x64(True)`` (never the global
flag) against its dense autodiff force.
"""

import ast
import functools
import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.ops import pallas_pair as pallas_pair_j
from mdgrad_tpu.ops.pallas_pair import lj_energy_forces as lj_energy_forces_j
from mdgrad_tpu.ops.pallas_pair import make_lj_force as make_lj_force_j
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import ops
from mdgrad_tpu_torch.ops import pair
from mdgrad_tpu_torch.ops.time_pair import lj_edge_cases

REPO = pathlib.Path(__file__).resolve().parent.parent
CUTOFF = 2.4
SIGMA, EPS = 0.95, 1.1


@pytest.fixture(scope="module")
def fcc():
    """(cell lengths (3,), perturbed positions (108, 3)) as float64 numpy,
    the inputs of tests/test_pallas.py::perturbed_fcc."""
    s = SystemJ.from_lattice("fcc", 3, 1.679)
    rng = np.random.default_rng(1)
    xyz = s.get_positions() + rng.normal(0, 0.05, (108, 3))
    return np.array(np.diag(s.get_cell())), xyz


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def _jax_dense_force(cell, cutoff, rep, attr):
    """The JAX package's dense force -dU/dxyz of PairPotentials(LJFamily),
    a function of (xyz, sigma, eps)."""
    s = SystemJ(np.zeros((108, 3)), np.diag(cell))
    dense = PairPotentialsJ(s, potentials_j.LJFamily(
        rep_pow=rep, attr_pow=attr), cutoff=cutoff, mode="dense")

    def force(xyz, sigma, eps):
        p = {"sigma": sigma, "epsilon": eps}
        return -jax.grad(dense.energy, argnums=1)(p, xyz, ())

    return dense, force


@pytest.mark.parametrize("rep,attr", [(12, 6), (9, 6), (12, 0)])
def test_energy_forces_match_jax_kernel(fcc, rep, attr):
    """K5's plain version against the Pallas kernel (interpret mode): f32
    sums of ~6000 pair terms in another order."""
    cell, xyz = fcc
    e_j, f_j = lj_energy_forces_j(jnp.asarray(xyz), cell, CUTOFF, SIGMA, EPS,
                                  rep_pow=rep, attr_pow=attr, interpret=True)
    ops.reset_counts()
    e, f = pair.lj_energy_forces(_t(xyz), cell, CUTOFF, SIGMA, EPS, rep,
                                 attr)
    assert ops.counts()["plain_calls"]["lj_energy_forces"] == 1
    assert f.shape == (108, 3) and e.shape == ()
    np.testing.assert_allclose(e.item(), float(e_j), rtol=1e-5)
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0,
                               atol=1e-4 * np.abs(f_j).max())


def test_padding_independence(fcc):
    """100 of the 108 atoms: the kernel pads to its tile and masks the
    ghosts, the port masks by bounds; both equal the dense 100-atom
    energy."""
    cell, xyz = fcc
    sub = xyz[:100]
    e_j, f_j = lj_energy_forces_j(jnp.asarray(sub), cell, CUTOFF, 1.0, 1.0,
                                  interpret=True)
    e, f = pair.lj_energy_forces(_t(sub), cell, CUTOFF, 1.0, 1.0)
    assert f.shape == (100, 3)
    dense = PairPotentialsJ(SystemJ(sub, np.diag(cell)),
                            potentials_j.LennardJones(1.0, 1.0),
                            cutoff=CUTOFF, mode="dense")
    e_dense = float(dense.energy(dense.init_params(), jnp.asarray(sub), ()))
    np.testing.assert_allclose(e.item(), float(e_j), rtol=1e-5)
    np.testing.assert_allclose(e.item(), e_dense, rtol=1e-5)
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0,
                               atol=1e-4 * np.abs(f_j).max())
    # the first 100 rows of the 108-atom call differ: the 8 atoms count
    _, f108 = pair.lj_energy_forces(_t(xyz), cell, CUTOFF, 1.0, 1.0)
    assert (f108[:100] - f).abs().max() > 1e-3


def test_force_and_vjp_match_jax_make_lj_force(fcc):
    """K6 and its K6b backward against make_lj_force(interpret=True):
    forward, and the gradient of (w . F) into (xyz, sigma, eps) with w
    from rng 7, at test_pallas.py::test_make_lj_force_custom_vjp_matches_
    dense's tolerances (f32 in another order)."""
    cell, xyz = fcc
    force_j = make_lj_force_j(jnp.asarray(cell), CUTOFF, interpret=True)
    w = np.random.default_rng(7).normal(size=(108, 3))
    sigma_j, eps_j = jnp.float32(SIGMA), jnp.float32(EPS)
    xyz_j, w_j = jnp.asarray(xyz, jnp.float32), jnp.asarray(w, jnp.float32)
    f_j = np.asarray(force_j(xyz_j, sigma_j, eps_j))
    g_j = jax.grad(lambda x, s, e: (w_j * force_j(x, s, e)).sum(),
                   argnums=(0, 1, 2))(xyz_j, sigma_j, eps_j)

    force = pair.make_lj_force(cell, CUTOFF)
    x = _t(xyz, grad=True)
    sigma, eps = _t(SIGMA, grad=True), _t(EPS, grad=True)
    ops.reset_counts()
    f = force(x, sigma, eps)
    g = torch.autograd.grad((_t(w) * f).sum(), (x, sigma, eps))
    plain = ops.counts()["plain_calls"]
    assert plain["lj_force"] == 1 and plain["lj_force_vjp"] == 1
    np.testing.assert_allclose(f.detach().numpy(), f_j, rtol=2e-3,
                               atol=2e-5 * np.abs(f_j).max())
    for a, b, name in zip(g, g_j, ("xyz", "sigma", "eps")):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3,
                                   atol=2e-5 * scale, err_msg=name)


@pytest.mark.parametrize("rep,attr", [(12, 6), (9, 6), (12, 0)])
def test_force_param_matches_jax_dense_f64(fcc, rep, attr):
    """K7's plain version against the JAX dense PairPotentials(LJFamily) in
    float64: its forces against -dU/dxyz, dU/dsigma against jax.grad in
    sigma, U/eps against the energy over eps (rel 1e-10)."""
    cell, xyz = fcc
    with jax.enable_x64(True):
        dense, force_jf = _jax_dense_force(cell, CUTOFF, rep, attr)
        p = {"sigma": jnp.float64(SIGMA), "epsilon": jnp.float64(EPS)}
        x_j = jnp.asarray(xyz, jnp.float64)
        u_j, g_j = jax.value_and_grad(dense.energy)(p, x_j, ())
        f_j = np.asarray(force_jf(x_j, p["sigma"], p["epsilon"]))
        u_j, dsig_j = float(u_j), float(g_j["sigma"])
    f, dsig, ueps = pair.lj_force_param(_t(xyz, torch.float64), cell, CUTOFF,
                                        SIGMA, EPS, rep, attr)
    assert not f.requires_grad
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0,
                               atol=1e-10 * np.abs(f_j).max())
    np.testing.assert_allclose(dsig.item(), dsig_j, rtol=1e-10)
    np.testing.assert_allclose(ueps.item(), u_j / EPS, rtol=1e-10)


def _jax_force_param_kernel(xyz, cell, cutoff, sigma, eps, rep, attr):
    """The JAX package's ``_force_param_kernel`` (K7's Pallas body) in
    interpret mode, called with the specs ``make_lj_force._call`` gives its
    kernels, two (8, 128) scalar outputs summed: (forces (N, 3), dU/dsigma,
    U/eps) as numpy.  ``make_lj_force`` itself never calls it."""
    tile_r, tile_c = pallas_pair_j.TILE_R, pallas_pair_j.TILE_C
    n = xyz.shape[0]
    n_pad = pallas_pair_j._round_up(max(n, tile_r), tile_c)
    xyz_t = jnp.zeros((3, n_pad), jnp.float32).at[:, :n].set(
        jnp.asarray(xyz, jnp.float32).T)
    params = jnp.asarray([sigma, eps, cutoff], jnp.float32)
    grid = n_pad // tile_r
    row_spec = pl.BlockSpec((3, tile_r), lambda i: (0, i),
                            memory_space=pltpu.VMEM)
    scalar_spec = pl.BlockSpec((8, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)
    scalar_shape = jax.ShapeDtypeStruct((grid * 8, 128), jnp.float32)
    kernel = functools.partial(pallas_pair_j._force_param_kernel, rep, attr,
                               n_pad // tile_c, n)
    f, dsig, ueps = pl.pallas_call(
        kernel, grid=(grid,),
        in_specs=[row_spec,
                  pl.BlockSpec((3, n_pad), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=[row_spec, scalar_spec, scalar_spec],
        out_shape=[jax.ShapeDtypeStruct((3, n_pad), jnp.float32),
                   scalar_shape, scalar_shape],
        interpret=True)(xyz_t, xyz_t, jnp.asarray(cell, jnp.float32),
                        params)
    return np.asarray(f[:, :n].T), float(dsig.sum()), float(ueps.sum())


@pytest.mark.parametrize("rep,attr", [(12, 6), (9, 6), (12, 0)])
@pytest.mark.parametrize("n", [100, 108])
def test_force_param_matches_jax_pallas_kernel(fcc, n, rep, attr):
    """K7's plain version against the JAX ``_force_param_kernel`` itself
    in interpret mode, at 108 atoms and 100 of them (the kernel pads to
    its tile and masks the ghosts): f32 sums in another order, at
    test_energy_forces_match_jax_kernel's bounds."""
    cell, xyz = fcc
    xyz = xyz[:n].astype(np.float32)
    f_j, dsig_j, ueps_j = _jax_force_param_kernel(xyz, cell, CUTOFF, SIGMA,
                                                  EPS, rep, attr)
    ops.reset_counts()
    f, dsig, ueps = pair.lj_force_param(_t(xyz), cell, CUTOFF, SIGMA, EPS,
                                        rep, attr)
    assert ops.counts()["plain_calls"]["lj_force_param"] == 1
    assert f.shape == (n, 3) and dsig_j != 0 and ueps_j != 0
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0,
                               atol=1e-4 * np.abs(f_j).max())
    np.testing.assert_allclose(dsig.item(), dsig_j, rtol=1e-5)
    np.testing.assert_allclose(ueps.item(), ueps_j, rtol=1e-5)


def test_force_and_vjp_match_jax_dense_f64(fcc):
    """The plain force and its vjp (K6, K6b's plain versions) against the
    JAX dense autodiff force and jax.vjp of it, float64: rel 1e-10."""
    cell, xyz = fcc
    w = np.random.default_rng(7).normal(size=(108, 3))
    with jax.enable_x64(True):
        _, force_jf = _jax_dense_force(cell, CUTOFF, 12, 6)
        args = (jnp.asarray(xyz, jnp.float64), jnp.float64(SIGMA),
                jnp.float64(EPS))
        f_j, vjp = jax.vjp(force_jf, *args)
        g_j = [np.asarray(a) for a in vjp(jnp.asarray(w, jnp.float64))]
        f_j = np.asarray(f_j)
    x = _t(xyz, torch.float64)
    sigma, eps = _t(SIGMA, torch.float64), _t(EPS, torch.float64)
    f = pair.lj_force_plain(x, cell, CUTOFF, sigma, eps)
    g = pair.lj_force_vjp_plain(x, _t(w, torch.float64), cell, CUTOFF, sigma,
                                eps)
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0,
                               atol=1e-10 * np.abs(f_j).max())
    for a, b, name in zip(g, g_j, ("xyz", "sigma", "eps")):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-10 * np.abs(b).max(),
                                   err_msg=name)


def test_lj_force_gradcheck_f64_and_first_order_only():
    """gradcheck of the differentiable force in (xyz, sigma, eps), float64,
    32 atoms; its backward is once-differentiable, so a second backward
    through it raises, as the JAX custom_vjp allows no second order."""
    s = mt.System.from_lattice("fcc", 2, 1.679)
    rng = np.random.default_rng(4)
    xyz = _t(s.get_positions() + rng.normal(0, 0.05, (32, 3)), torch.float64,
             grad=True)
    sigma, eps = _t(0.95, torch.float64, True), _t(1.1, torch.float64, True)
    force = pair.make_lj_force(np.diag(s.get_cell()), 1.6)
    assert torch.autograd.gradcheck(force, (xyz, sigma, eps))
    # a cotangent that requires grad, so the backward's output carries the
    # error node instead of no graph at all
    w = _t(rng.normal(size=(32, 3)), torch.float64, grad=True)
    (gx,) = torch.autograd.grad((force(xyz, sigma, eps) * w).sum(), xyz,
                                create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()


def test_pair_module_imports_no_jax():
    tree = ast.parse((REPO / "mdgrad_tpu_torch/ops/pair.py").read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""]
                 if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "mdgrad_tpu"), name


def test_pallas_lj_pair_on_cpu_counts_plain_calls(fcc):
    cell, xyz = fcc
    s = mt.System.from_lattice("fcc", 3, 1.679)
    inter = mt.ops.PallasLJPair(s, CUTOFF, sigma=SIGMA, epsilon=EPS,
                                device="cpu")
    assert {n for n, _ in inter.named_parameters()} == {"sigma", "epsilon"}
    x = _t(xyz, grad=True)
    ops.reset_counts()
    e = inter.energy(x.detach(), ())
    f = inter.force(x, ())
    torch.autograd.grad(f.sum(), [x, inter.sigma, inter.epsilon])
    c = ops.counts()
    assert sum(c["launches"].values()) == 0
    assert c["plain_calls"]["lj_energy_forces"] == 1
    assert c["plain_calls"]["lj_force"] == 1
    assert c["plain_calls"]["lj_force_vjp"] == 1
    e_ref, f_ref = pair.lj_energy_forces(x.detach(), cell, CUTOFF, SIGMA, EPS)
    assert e.item() == e_ref.item()
    torch.testing.assert_close(f.detach(), f_ref, rtol=0, atol=0)


def test_non_diagonal_cell_raises():
    s = mt.System.from_lattice("fcc", 3, 1.679)
    s.cell = s.cell + np.array([[0.0, 0.3, 0.0], [0, 0, 0], [0, 0, 0]])
    with pytest.raises(NotImplementedError, match="diagonal"):
        mt.ops.PallasLJPair(s, CUTOFF, device="cpu")


def test_energy_backward_raises(fcc):
    """K5's energy has no gradient: its backward raises and names the
    differentiable force, never differentiating the plain version."""
    cell, xyz = fcc
    x = _t(xyz, grad=True)
    e, _ = pair.lj_energy_forces(x, cell, CUTOFF, SIGMA, EPS)
    with pytest.raises(NotImplementedError, match="PallasLJPair.force"):
        e.backward()
    s = mt.System.from_lattice("fcc", 3, 1.679)
    inter = mt.ops.PallasLJPair(s, CUTOFF, device="cpu")
    with pytest.raises(NotImplementedError, match="no gradient"):
        torch.autograd.grad(inter.energy(x, ()), inter.sigma)


@pytest.mark.parametrize("L", [1.0, 11.75, 16.79, 21.827])
def test_image_thresholds_exhaustive(L):
    """Every float32 d within 64 ulps of +-L/2 and +-3L/2: the shift that
    K6 takes from the thresholds (IEEE past t2) equals torch.round(d / L),
    and d minus it times L has the same bits as the plain minimum image."""
    t1, t2 = pair.image_thresholds(L)
    L32 = np.float32(L)
    band = []
    for c in (L32 / 2, np.float32(1.5) * L32):
        ints = np.float32(c).view(np.int32) + np.arange(-64, 65,
                                                        dtype=np.int32)
        band.append(ints.view(np.float32))
    d = np.concatenate(band)
    d = np.concatenate([d, -d])
    ref_shift = torch.round(torch.tensor(d) / torch.tensor(L32)).numpy()
    fast = np.where(d >= t1, 1, np.where(d <= -t1, -1, 0))
    shift = np.where(np.abs(d) >= t2, ref_shift, fast)
    np.testing.assert_array_equal(shift, ref_shift)
    # t2 is where the shift first reaches 2: every |d| past it takes IEEE
    assert (np.abs(ref_shift[np.abs(d) >= t2]) == 2).all()
    assert (np.abs(ref_shift[(np.abs(d) < t2) & (np.abs(d) > L32)]) == 1).all()
    image = (torch.tensor(d) - torch.tensor(shift.astype(np.float32)) * L32)
    plain = (torch.tensor(d)
             - torch.round(torch.tensor(d) / torch.tensor(L32)) * L32)
    np.testing.assert_array_equal(image.numpy().view(np.int32),
                                  plain.numpy().view(np.int32))


@pytest.mark.parametrize("case", lj_edge_cases(),
                         ids=lambda c: f"L{c[0]}-axis{c[1]}")
def test_force_on_image_edges_matches_jax(case):
    """The plain K6 (lj_force_plain) against make_lj_force(interpret=True)
    on pairs at d = +-L/2, one ulp on each side, at the image thresholds
    and past a box length: the same image decisions on both sides, at
    test_force_and_vjp_match_jax_make_lj_force's tolerances."""
    _, _, xyz, cell, cutoff, sigma = case
    force_j = make_lj_force_j(jnp.asarray(cell, jnp.float32), cutoff,
                              interpret=True)
    f_j = np.asarray(force_j(jnp.asarray(xyz), jnp.float32(sigma),
                             jnp.float32(1.0)))
    f = pair.lj_force_plain(torch.tensor(xyz), cell, cutoff,
                            torch.tensor(sigma, dtype=torch.float32),
                            torch.tensor(1.0))
    scale = np.abs(f_j).max()
    assert scale > 0
    np.testing.assert_allclose(f.numpy(), f_j, rtol=2e-3,
                               atol=2e-5 * scale)


# ---- the i < j decomposition of K5, K6, K6b and K7 (csrc/pair.cu) ------

def _half_walk(xyz, w, cell, cutoff, sigma, eps, rep, attr):
    """K5's, K6b's and K7's sums as the CUDA kernel takes them, over i < j
    pairs only (float64 here): each pair's term T_ij = h (W_ij . d_ij) d_ij
    + g W_ij to the row and -T_ij to the column, d(W.F)/dsigma and
    d(W.F)/deps as +sum (dg/dsigma, g / eps) (W_ij . d_ij), the force -g d
    to the row and +g d to the column, u, du/dsigma and u / eps once (the
    ordered sums' 1/2 dropped with the second visit).  (E, F, vjp,
    dsigma, deps, dU/dsigma, U/eps)."""
    n = xyz.shape[0]
    i, j = torch.triu_indices(n, n, 1)
    L = torch.tensor(np.asarray(cell), dtype=xyz.dtype)
    d = xyz[i] - xyz[j]
    d = d - torch.round(d / L) * L
    keep = (d * d).sum(-1) < torch.tensor(cutoff, dtype=xyz.dtype) ** 2
    i, j, d = i[keep], j[keep], d[keep]
    inv_r2 = 1 / (d * d).sum(-1)
    sr = sigma * torch.sqrt(inv_r2)
    sr_r, sr_a = sr ** rep, sr ** attr
    g0 = 4 * (-rep * sr_r + attr * sr_a) * inv_r2
    g = eps * g0
    h = 4 * eps * (rep * (rep + 2) * sr_r - attr * (attr + 2) * sr_a) \
        * inv_r2 * inv_r2
    dgds = 4 * eps * (-rep * rep * sr_r + attr * attr * sr_a) * inv_r2 / sigma
    w_ij = w[j] - w[i]
    wd = (w_ij * d).sum(-1)
    t = (h * wd)[:, None] * d + g[:, None] * w_ij
    zero = torch.zeros_like(xyz)
    vjp = zero.index_add(0, i, t).index_add(0, j, -t)
    gd = g[:, None] * d
    f = zero.index_add(0, i, -gd).index_add(0, j, gd)
    e = (4 * eps * (sr_r - sr_a)).sum()
    dudsig = (4 * eps * (rep * sr_r - attr * sr_a) / sigma).sum()
    return (e, f, vjp, (dgds * wd).sum(), (g0 * wd).sum(), dudsig,
            (4 * (sr_r - sr_a)).sum())


@pytest.mark.parametrize("rep,attr", [(12, 6), (9, 6), (12, 0)])
@pytest.mark.parametrize("n", [2, 100, 108])
def test_half_walk_matches_plain_and_jax(fcc, n, rep, attr):
    """The i < j sums reproduce the plain versions of K5 and K6b in
    float64 (rel 1e-10) and the JAX lj_energy_forces and make_lj_force
    vjp in interpret mode in float32 (the bounds of the tests above: f32
    sums in another order)."""
    cell, xyz = fcc
    xyz = xyz[:n].astype(np.float32)
    w = np.random.default_rng(7).normal(size=(n, 3)).astype(np.float32)
    x64, w64 = _t(xyz, torch.float64), _t(w, torch.float64)
    sigma, eps = _t(SIGMA, torch.float64), _t(EPS, torch.float64)
    e, f, vjp, dsig, deps, _, _ = _half_walk(x64, w64, cell, CUTOFF, sigma,
                                             eps, rep, attr)
    e_p, f_p = pair.lj_energy_forces_plain(x64, cell, CUTOFF, sigma, eps,
                                           rep, attr)
    ref = pair.lj_force_vjp_plain(x64, w64, cell, CUTOFF, sigma, eps, rep,
                                  attr)
    assert float(e_p) != 0 and float(ref[1]) != 0
    for got, want in ((f, f_p), (vjp, ref[0])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-10 * want.abs().max().item())
    for got, want in ((e, e_p), (dsig, ref[1]), (deps, ref[2])):
        np.testing.assert_allclose(got.item(), want.item(), rtol=1e-10)

    e_j, f_j = lj_energy_forces_j(jnp.asarray(xyz), cell, CUTOFF, SIGMA, EPS,
                                  rep_pow=rep, attr_pow=attr, interpret=True)
    np.testing.assert_allclose(e.item(), float(e_j), rtol=1e-5)
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0,
                               atol=1e-4 * np.abs(f_j).max())
    force_j = make_lj_force_j(jnp.asarray(cell), CUTOFF, rep_pow=rep,
                              attr_pow=attr, interpret=True)
    g_j = jax.grad(lambda x, s, e: (jnp.asarray(w) * force_j(x, s, e)).sum(),
                   argnums=(0, 1, 2))(jnp.asarray(xyz), jnp.float32(SIGMA),
                                      jnp.float32(EPS))
    for a, b, name in zip((vjp, dsig, deps), g_j, ("xyz", "sigma", "eps")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3,
                                   atol=2e-5 * max(np.abs(b).max(), 1e-8),
                                   err_msg=name)


@pytest.mark.parametrize("rep,attr", [(12, 6), (9, 6), (12, 0)])
@pytest.mark.parametrize("n", [2, 100, 108])
def test_half_walk_force_param_matches_plain_and_jax(fcc, n, rep, attr):
    """K7's i < j sums, each pair's dU/dsigma and U/eps terms taken once,
    reproduce its plain version (half of each term over ordered pairs) in
    float64 (rel 1e-10) and the JAX ``_force_param_kernel`` in interpret
    mode in float32 (rtol 1e-5: f32 sums in another order)."""
    cell, xyz = fcc
    xyz = xyz[:n].astype(np.float32)
    x64 = _t(xyz, torch.float64)
    sigma, eps = _t(SIGMA, torch.float64), _t(EPS, torch.float64)
    _, f, _, _, _, dsig, ueps = _half_walk(x64, torch.zeros_like(x64), cell,
                                           CUTOFF, sigma, eps, rep, attr)
    f_p, dsig_p, ueps_p = pair.lj_force_param_plain(x64, cell, CUTOFF, sigma,
                                                    eps, rep, attr)
    assert float(dsig_p) != 0 and float(ueps_p) != 0
    np.testing.assert_allclose(f.numpy(), f_p.numpy(), rtol=0,
                               atol=1e-10 * f_p.abs().max().item())
    for got, want in ((dsig, dsig_p), (ueps, ueps_p)):
        np.testing.assert_allclose(got.item(), want.item(), rtol=1e-10)
    _, dsig_j, ueps_j = _jax_force_param_kernel(xyz, cell, CUTOFF, SIGMA, EPS,
                                                rep, attr)
    np.testing.assert_allclose(dsig.item(), dsig_j, rtol=1e-5)
    np.testing.assert_allclose(ueps.item(), ueps_j, rtol=1e-5)


def _block_tiles(b):
    """(R, C) of block b, R <= C, b = C (C + 1) / 2 + R, as lj_half_kernel
    finds them: a float32 square root, then integer corrections."""
    f = np.float32
    C = int((np.sqrt(f(8) * f(b) + f(1)) - f(1)) * f(0.5))
    while (C + 1) * (C + 2) // 2 <= b:
        C += 1
    while C * (C + 1) // 2 > b:
        C -= 1
    return b - C * (C + 1) // 2, C


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 100, 1372, 4000])
def test_half_walk_block_map_covers_each_pair_once(n):
    """A model of lj_half_kernel's walk: block b takes the 64-atom tile
    pair (R, C); warp (wr, wc) the 32-atom tile pair (2 R + wr, 2 C + wc),
    warp (1, 0) idle on a diagonal block; lane a takes column (a + s) mod
    32 at step s, steps 0-31, or on a diagonal tile steps 1-15 and step 16
    from lanes 0-15.  Every unordered pair of real atoms is walked exactly
    once and no atom with itself; at each step the lanes' columns differ
    (one add per column); and each (slot, atom) of the vector scratch is
    written by exactly one block."""
    tile, wt = pair.FORCE_TILE, pair.FORCE_TILE // 2
    tiles = -(-n // tile)
    lanes = np.arange(wt)
    keys, slots = [], []
    for b in range(tiles * (tiles + 1) // 2):
        R, C = _block_tiles(b)
        assert 0 <= R <= C < tiles
        for wr in (0, 1):
            for wc in (0, 1):
                if R == C and wr > wc:
                    continue
                diag = R == C and wr == wc
                steps = ([(s, wt) for s in range(1, wt // 2)]
                         + [(wt // 2, wt // 2)] if diag
                         else [(s, wt) for s in range(wt)])
                for s, active in steps:
                    cols = (lanes[:active] + s) % wt
                    assert len(set(cols)) == active
                    row = R * tile + wr * wt + lanes[:active]
                    col = C * tile + wc * wt + cols
                    real = (row < n) & (col < n)
                    row, col = row[real], col[real]
                    assert (row != col).all()
                    keys.append(np.minimum(row, col) * n
                                + np.maximum(row, col))
        atoms = np.arange(tile)
        slots += [(C, p) for p in R * tile + atoms if p < n]
        if R != C:
            slots += [(R, p) for p in C * tile + atoms if p < n]
    keys = np.concatenate(keys)
    assert keys.size == n * (n - 1) // 2
    assert np.unique(keys).size == keys.size
    assert len(slots) == len(set(slots)) == tiles * n


def test_lj_scratch_mirror_sizes_the_launch_buffers():
    """``_launch`` takes its buffers from ``_scratch``, sized by the
    library's mdg_lj_scratch: with a library that answers by ops/pair.py's
    lj_scratch, every kernel's buffers hold exactly the mirror's float
    counts (K6 none for scalars).  The mirror's tile is csrc/pair.cu's
    constant, and its block counts the ones the source states (253 at N =
    1372 and 2016 at 4000, the one i < j walk of all four kernels; the
    ordered-pair tile is gone)."""
    src = (REPO / "mdgrad_tpu_torch/csrc/pair.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    warp_tile = int(const["kWarpTile"])
    assert "kPairTile" not in src and "mdg_pair_tile" not in src
    assert const["kForceTile"] == "2 * kWarpTile"
    assert 2 * warp_tile == pair.FORCE_TILE

    class Library:
        @staticmethod
        def mdg_lj_scratch(mode, n, which):
            return pair.lj_scratch(pair._MODES[mode], n)[which]

    for name in pair._MODES:
        for n in (1, 2, 63, 64, 65, 100, 1372, 4000):
            part, block = pair._scratch(Library, name, n, "cpu")
            want = pair.lj_scratch(name, n)
            assert part.numel() == want[0]
            assert (block is None) == (name == "lj_force")
            assert want[1] == (0 if block is None else block.numel())
    assert pair.lj_scratch("lj_force_vjp", 1372) == (22 * 1372 * 3, 2 * 253)
    assert pair.lj_scratch("lj_energy_forces", 4000) == (63 * 4000 * 3, 2016)
    assert pair.lj_scratch("lj_force", 4000) == (63 * 4000 * 3, 0)
    assert pair.lj_scratch("lj_force_param", 4000) == (63 * 4000 * 3,
                                                       2 * 2016)
    assert pair.lj_scratch("lj_force_param", 1372) == (22 * 1372 * 3,
                                                       2 * 253)
