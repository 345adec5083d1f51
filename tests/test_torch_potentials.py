"""The port's pair-potential zoo (mdgrad_tpu_torch/potentials.py) against
the JAX package's (mdgrad_tpu/potentials.py), and the JAX suite's
potential tests (tests/test_potentials.py, tests/test_fit.py's
GaussianCore test) run on the port.

Every potential's u and du/dr (and dU/d(parameter)) on distances made
with numpy from a seed agree in float32 within 1e-5 of max(|ref|, 1):
the same formulas, each side rounding in its own order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as pj
from mdgrad_tpu_torch import potentials as pt

TOL = 1e-5


def _close(got, ref, what):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref,
                                                             dtype=np.float64)
    scale = max(np.abs(ref).max(), 1.0)
    err = np.abs(got - ref).max()
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL * scale:.3e}"


def _r(lo, hi, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(lo, hi, n)).astype(np.float32)[:, None]


# (name, JAX potential, port potential, r range): every class of the zoo
# at non-default constants
CASES = [
    ("LennardJones", lambda m: m.LennardJones(0.9, 1.3), (0.8, 2.5)),
    ("LennardJones69", lambda m: m.LennardJones69(1.1, 0.7), (0.9, 2.5)),
    ("LJFamily", lambda m: m.LJFamily(0.9, 2.0, attr_pow=3, rep_pow=6),
     (0.7, 2.5)),
    ("ExcludedVolume", lambda m: m.ExcludedVolume(0.9, 0.4, power=10),
     (0.7, 2.5)),
    ("GaussianCore", lambda m: m.GaussianCore(0.55, 2.0), (0.0, 3.0)),
    ("Buck", lambda m: m.Buck(A=2.0, B=1.5, C=0.5), (0.8, 3.0)),
    ("Yukawa", lambda m: m.Yukawa(epsilon=2.0, kappa=1.2, sigma=0.8),
     (0.5, 3.0)),
    ("Morse", lambda m: m.Morse(D=1.0, a=1.3, r0=1.1), (0.5, 3.0)),
    ("ModifiedMorse+", lambda m: m.ModifiedMorse(a=2.0, phi=1.5),
     (0.6, 2.5)),
    ("ModifiedMorse-", lambda m: m.ModifiedMorse(a=2.0, phi=-1.5),
     (0.6, 2.5)),
    ("Harmonic", lambda m: m.Harmonic(k=3.0), (-2.0, 2.0)),
    ("CubicSpline", lambda m: m.CubicSpline(np.linspace(0.5, 3.0, 40),
                                            np.sin(np.linspace(0.5, 3.0,
                                                               40))),
     (0.3, 3.2)),
    ("boltzmann_inversion_spline",
     lambda m: m.boltzmann_inversion_spline(
         np.linspace(0.8, 3.0, 60),
         np.exp(-((np.linspace(0.8, 3.0, 60) - 1.5) ** 2)), kT=2.0),
     (0.8, 3.0)),
    ("spline_overlap", lambda m: m.spline_overlap(K=4.0, V0=1.5,
                                                  n_splines=200),
     (0.1, 10.0)),
]


def _jax_params(m):
    return m.init_params() if hasattr(m, "init_params") else {}


@pytest.mark.parametrize("name,make,r_range", CASES,
                         ids=[c[0] for c in CASES])
def test_potential_and_force_match_jax(name, make, r_range):
    """u(r), du/dr and dU/d(each parameter) of the port against the JAX
    form, in float32."""
    mj, mt = make(pj), make(pt)
    r = _r(*r_range)
    p = _jax_params(mj)
    u_j = mj(p, jnp.asarray(r))
    du_j = jax.grad(lambda x: mj(p, x).sum())(jnp.asarray(r))
    rt = torch.tensor(r, requires_grad=True)
    u = mt(rt)
    (du,) = torch.autograd.grad(u.sum(), rt, retain_graph=True)
    _close(u.detach().numpy(), u_j, f"{name} u")
    _close(du.numpy(), du_j, f"{name} du/dr")
    names = [k for k, _ in mt.named_parameters()]
    assert sorted(names) == sorted(p), name
    if names:
        g_j = jax.grad(lambda q: mj(q, jnp.asarray(r)).sum())(p)
        g = torch.autograd.grad(u.sum(), list(mt.parameters()))
        for k, gk in zip(names, g):
            _close(gk.numpy(), g_j[k], f"{name} dU/d{k}")


@pytest.mark.parametrize("kind", ["cubic", "linear"])
def test_pair_tab_matches_jax(kind):
    """PairTab with a random table: u, du/dr and dU/dtab in float32; the
    cubic path's (nbins, nbins) solve matrix in full f32."""
    rng = np.random.default_rng(1)
    tab = rng.normal(size=48).astype(np.float32)
    mj, mt = pj.PairTab(nbins=48, rc=2.5, kind=kind), \
        pt.PairTab(nbins=48, rc=2.5, kind=kind)
    with torch.no_grad():
        mt.tab.copy_(torch.tensor(tab))
    r = _r(0.0, 2.6, 200, seed=2)     # past rc: clipped
    p = {"tab": jnp.asarray(tab)}
    u_j = mj(p, jnp.asarray(r))
    du_j = jax.grad(lambda x: mj(p, x).sum())(jnp.asarray(r))
    g_j = jax.grad(lambda q: mj(q, jnp.asarray(r)).sum())(p)["tab"]
    rt = torch.tensor(r, requires_grad=True)
    u = mt(rt)
    du, g = torch.autograd.grad(u.sum(), [rt, mt.tab])
    _close(u.detach().numpy(), u_j, "u")
    _close(g.numpy(), g_j, "dU/dtab")
    # du/dr away from the knots, where both sides take one segment
    h = 2.5 / 47
    off_knot = np.abs(r[:, 0] / h - np.round(r[:, 0] / h)) > 1e-3
    off_knot &= r[:, 0] < 2.5
    _close(du.numpy()[off_knot], np.asarray(du_j)[off_knot], "du/dr")
    with pytest.raises(ValueError, match="kind"):
        pt.PairTab(nbins=8, kind="quadratic")


@pytest.mark.parametrize("cls", ["Toy2d", "LEPS"])
def test_2d_surfaces_match_jax(cls):
    """Toy2d and LEPS on 2-D points: u and its gradient in float32."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0.5, 2.0, (32, 2)).astype(np.float32)
    mj, mt = getattr(pj, cls)(), getattr(pt, cls)()
    u_j = mj({}, jnp.asarray(xy))
    g_j = jax.grad(lambda x: mj({}, x).sum())(jnp.asarray(xy))
    x = torch.tensor(xy, requires_grad=True)
    u = mt(x)
    (g,) = torch.autograd.grad(u.sum(), x)
    _close(u.detach().numpy(), u_j, f"{cls} u")
    _close(g.numpy(), g_j, f"{cls} grad")
    assert mt(torch.tensor([0.5, 0.5])).shape == (1,)


def test_natural_cubic_coeffs_match_jax():
    x = np.linspace(0.3, 2.0, 17)
    y = np.cos(3 * x)
    for a, b in zip(pt._natural_cubic_coeffs(x, y),
                    pj._natural_cubic_coeffs(x, y)):
        np.testing.assert_array_equal(a, b)


def test_lennard_jones_69_is_an_lj_family():
    assert isinstance(pt.LennardJones69(), pt.LJFamily)
    assert isinstance(pt.LennardJones(), pt.LJFamily)


# ---- tests/test_potentials.py and the GaussianCore test, on the port -------

def finite_diff(f, x, eps=1e-4):
    return (f(x + eps) - f(x - eps)) / (2 * eps)


def test_lennard_jones_minimum():
    lj = pt.LennardJones(sigma=1.0, epsilon=1.0)
    rmin = torch.tensor(2 ** (1 / 6), requires_grad=True)
    u = lj(rmin)
    assert abs(u.item() + 1.0) < 1e-6
    (g,) = torch.autograd.grad(u, rmin)
    assert abs(g.item()) < 1e-4


@pytest.mark.parametrize("cls,kw", [
    (pt.LennardJones, {}),
    (pt.LennardJones69, {}),
    (pt.LJFamily, dict(attr_pow=6, rep_pow=12)),
    (pt.ExcludedVolume, dict(power=10)),
    (pt.Buck, dict(A=2.0, B=1.5, C=0.5)),
    (pt.Yukawa, dict(epsilon=2.0, kappa=1.2)),
    (pt.Morse, dict(D=1.0, a=1.3, r0=1.1)),
])
def test_force_matches_finite_difference(cls, kw):
    m = cls(**kw)
    r0 = 1.3
    r = torch.tensor(r0, requires_grad=True)
    (g,) = torch.autograd.grad(m(r).sum(), r)
    with torch.no_grad():
        fd = finite_diff(lambda x: m(torch.tensor(x)).sum().item(), r0)
    np.testing.assert_allclose(g.item(), fd, rtol=2e-3, atol=5e-3)


def test_param_gradients_flow():
    lj = pt.LennardJones()
    lj(torch.tensor(1.2)).sum().backward()
    assert abs(lj.sigma.grad.item()) > 0
    assert abs(lj.epsilon.grad.item()) > 0


def test_pair_tab_interpolation():
    tab = pt.PairTab(nbins=100, rc=2.0)
    with torch.no_grad():
        tab.tab.copy_(torch.linspace(0.0, 1.0, 100))  # u(r) = r/2 on [0,2]
    r = torch.tensor([[0.5], [1.0]])
    np.testing.assert_allclose(tab(r).detach().numpy(), [[0.25], [0.5]],
                               atol=1e-6)


def test_cubic_spline_matches_data():
    x = np.linspace(0.5, 3.0, 50)
    sp = pt.CubicSpline(x, np.sin(x))
    xq = torch.tensor([0.7, 1.5, 2.9])
    np.testing.assert_allclose(sp(xq).numpy(), np.sin(xq.numpy()),
                               atol=1e-4)


def test_boltzmann_inversion():
    r = np.linspace(0.8, 3.0, 60)
    g = np.exp(-((r - 1.5) ** 2))
    sp = pt.boltzmann_inversion_spline(r, g, kT=2.0)
    assert abs(sp(torch.tensor(1.5)).item()) < 1e-2


def test_toy2d_and_leps_shapes():
    for m in (pt.Toy2d(), pt.LEPS()):
        assert m(torch.tensor([[0.5, 0.5], [1.0, 1.0]])).shape == (2,)


def test_pairtab_cubic_interpolates_smooth_function():
    """The cubic PairTab fits a smooth function far better than the linear
    one, with dU/dr continuous across knots and gradients into the
    table."""
    rc = 2.5
    tab_c = pt.PairTab(nbins=64, rc=rc, kind="cubic")
    tab_l = pt.PairTab(nbins=64, rc=rc, kind="linear")

    def f(r):
        return np.sin(3 * r) * np.exp(-r)

    y = torch.tensor(f(tab_c.x.numpy()))
    with torch.no_grad():
        tab_c.tab.copy_(y)
        tab_l.tab.copy_(y)
    r = torch.tensor(np.linspace(0.05, rc - 0.05, 400), dtype=torch.float32)
    with torch.no_grad():
        err_c = np.abs(tab_c(r).numpy() - f(r.numpy())).max()
        err_l = np.abs(tab_l(r).numpy() - f(r.numpy())).max()
    assert err_c < err_l / 10
    assert err_c < 2e-4
    x_knot = tab_c.x[20].item()
    eps = 1e-4
    xs = torch.tensor([x_knot - eps, x_knot + eps], requires_grad=True)
    (du,) = torch.autograd.grad(tab_c(xs).sum(), xs)
    assert abs(du[0].item() - du[1].item()) < 5e-3
    (tab_c(r) ** 2).sum().backward()
    assert tab_c.tab.grad.abs().max().item() > 0


def test_gaussian_core_prior_bounded():
    gc = pt.GaussianCore(sigma=0.55, epsilon=2.0)
    with torch.no_grad():
        vals = gc(torch.linspace(1e-4, 5.0, 64)[:, None]).squeeze(-1).numpy()
    assert vals.max() <= 2.0 + 1e-6
    assert vals[-1] < 1e-8
    assert (np.diff(vals) <= 0).all()
