"""The port's fixed-grid ODE solvers (md/tinydiffeq.py) and the RK4 path
of its integrators (``rk4_step``, ``method="rk4"``) against the JAX
package: ``test_adjoint.py::test_tinydiffeq_arbitrary_grid`` and
``test_integrators.py::test_rk4_on_harmonic_oscillator`` on the port,
``odeint`` against the JAX ``odeint`` for euler, midpoint and rk4 on a
tuple state with gradients, and NVE and the Nose-Hoover chain stepped by
RK4 against the JAX integrators, all in float64 (JAX inside
``jax.enable_x64(True)``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import system as system_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.md import NVE as NVEJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md.tinydiffeq import odeint as odeint_j
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch.md.integrators import NVEState, NVTState, rk4_step
from mdgrad_tpu_torch.md.tinydiffeq import odeint

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tinydiffeq_arbitrary_grid():
    """On a geometric grid: dy/dt = -a y to 1e-5, euler at first order,
    the gradient through the solve, and a dict state (the harmonic
    oscillator)."""
    t = torch.tensor(np.geomspace(1e-3, 2.0, 24) - 1e-3, dtype=F64)
    a = 1.3
    y = odeint(lambda tt, y: -a * y, torch.tensor(1.0, dtype=F64), t,
               method="rk4", substeps=4)
    np.testing.assert_allclose(y.numpy(), np.exp(-a * t.numpy()), rtol=1e-5)
    exact = np.exp(-a * 2.0)
    e8, e16 = (abs(odeint(lambda tt, y: -a * y, torch.tensor(1.0, dtype=F64),
                          t, method="euler", substeps=s)[-1].item() - exact)
               for s in (8, 16))
    assert 0.35 < e16 / e8 < 0.65
    aa = torch.tensor(a, dtype=F64, requires_grad=True)
    odeint(lambda tt, y: -aa * y, torch.tensor(1.0, dtype=F64), t,
           substeps=4)[-1].backward()
    # the discrete solve's own O(h^4) truncation is in the gradient
    np.testing.assert_allclose(aa.grad.item(), -2.0 * np.exp(-a * 2.0),
                               rtol=2e-3)
    t2 = torch.tensor([0.0, 0.3, 0.9, 1.0, 2.2], dtype=F64)
    s = odeint(lambda tt, s: {"q": s["p"], "p": -s["q"]},
               {"q": torch.tensor(1.0, dtype=F64),
                "p": torch.tensor(0.0, dtype=F64)}, t2, substeps=16)
    np.testing.assert_allclose(s["q"].numpy(), np.cos(t2.numpy()),
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown method"):
        odeint(lambda tt, y: y, torch.tensor(1.0), t2, method="bogus")


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_odeint_matches_jax_with_gradients(method):
    """A damped, time-forced oscillator on a tuple state (x, v) over a
    non-uniform grid, 3 substeps: the trajectory within 1e-13 and the
    gradients of a trajectory loss with respect to the parameters, y0 and
    the grid within 1e-11 relative of JAX's."""
    t_np = np.array([0.0, 0.1, 0.35, 0.4, 0.9, 1.3, 2.0])
    x0, v0, k, c = 0.7, -0.2, 2.3, 0.4

    def field(lib):
        def f(tt, y, kk, cc):
            x, v = y
            return (v, -kk * x - cc * v + lib.sin(3.0 * tt))
        return f

    def loss_t(kk, cc, xx, tt):
        f = field(torch)
        traj = odeint(lambda s, y: f(s, y, kk, cc),
                      (xx, torch.tensor(v0, dtype=F64)), tt, method=method,
                      substeps=3)
        return (traj[0] ** 2).sum() + (traj[0] * traj[1]).sum(), traj

    leaves = [torch.tensor(v, dtype=F64, requires_grad=True)
              for v in (k, c, x0)]
    tt = torch.tensor(t_np, requires_grad=True)
    loss, traj = loss_t(*leaves, tt)
    grads = torch.autograd.grad(loss, [*leaves, tt])
    with jax.enable_x64(True):
        f = field(jnp)

        def loss_j(kk, cc, xx, tj):
            tr = odeint_j(lambda s, y: f(s, y, kk, cc),
                          (xx, jnp.asarray(v0)), tj, method=method,
                          substeps=3)
            return (tr[0] ** 2).sum() + (tr[0] * tr[1]).sum(), tr

        (l_j, tr_j), g_j = jax.value_and_grad(
            loss_j, argnums=(0, 1, 2, 3), has_aux=True)(
                jnp.asarray(k), jnp.asarray(c), jnp.asarray(x0),
                jnp.asarray(t_np))
        tr_j = [np.asarray(a) for a in tr_j]
        g_j = [np.asarray(g) for g in g_j]
    assert tr_j[0].dtype == np.float64 and traj[0].shape == (7,)
    for a, b in zip(traj, tr_j):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=1e-13)
    for a, b in zip(grads, g_j):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-11 * max(np.abs(b).max(), 1.0))


def test_rk4_on_harmonic_oscillator():
    """RK4 integrates x'' = -x over one period: amplitude kept to 1e-4."""
    dt = 0.05
    state = NVEState(v=torch.zeros(1, dtype=F64), q=torch.ones(1, dtype=F64))
    n = int(round(2 * np.pi / dt))
    for i in range(n):
        state = rk4_step(lambda s, t: NVEState(v=-s.q, q=s.v), state, i * dt,
                         dt)
    assert abs(state.q.item() - np.cos(n * dt)) < 1e-4


def _lj_pair(lib_sys, make_pair, lj, seed=2):
    s = lib_sys.System.from_lattice("fcc", 2, 1.679)
    s.set_temperature(1.0 / mt.units.kB, rng=np.random.default_rng(seed))
    return s, make_pair(s, lj)


@pytest.mark.parametrize("kind", ["nve", "nhc"])
def test_md_rk4_matches_jax(kind):
    """A 32-atom LJ box stepped 12 times by RK4 (``default_method`` rk4,
    so the state carries no force cache), in float64: positions,
    velocities and bath momenta within 1e-12, and the gradient of a loss
    on the last positions with respect to sigma and epsilon within 1e-9
    relative of JAX's."""
    n, dt = 12, 0.005
    s_t, pair_t = _lj_pair(mt, lambda s, lj: mt.PairPotentials(
        s, lj, cutoff=1.6, mode="dense", device="cpu"),
        mt.potentials.LennardJones(1.0, 1.0))
    pair_t.double()
    if kind == "nve":
        integ = mt.NVE(pair_t, s_t, device="cpu", dtype=F64)
    else:
        integ = mt.NoseHooverChain(pair_t, s_t, T=1.0 / mt.units.kB, Q=5.0,
                                   num_chains=3, device="cpu", dtype=F64)
    integ.default_method = "rk4"
    state, ctrl = integ.initial_state(), integ.default_ctrl()
    assert type(state) is (NVEState if kind == "nve" else NVTState)
    states = [state]
    for i in range(n):
        state = integ.step(state, (), ctrl, dt, create_graph=True, t=i * dt)
        states.append(state)
    loss = (state.q ** 2).sum() + (state.v ** 2).sum()
    params = list(pair_t.parameters())
    grads = torch.autograd.grad(loss, params)
    with jax.enable_x64(True):
        s_j, pair_j = _lj_pair(system_j, lambda s, lj: PairPotentialsJ(
            s, lj, cutoff=1.6, mode="dense"),
            potentials_j.LennardJones(1.0, 1.0))
        if kind == "nve":
            integ_j = NVEJ(pair_j, s_j)
        else:
            integ_j = NoseHooverChainJ(pair_j, s_j, T=1.0 / mt.units.kB,
                                       Q=5.0, num_chains=3)
        integ_j.default_method = "rk4"

        def run(p):
            st, out = integ_j.initial_state(), []
            for i in range(n):
                st = integ_j.step(p, st, (), integ_j.default_ctrl(), i * dt,
                                  dt)
                out.append(st)
            return ((st.q ** 2).sum() + (st.v ** 2).sum()), out

        (l_j, states_j), g_j = jax.value_and_grad(run, has_aux=True)(
            integ_j.init_params())
    for a, b in zip(states[1:], states_j):
        for field in a._fields:
            np.testing.assert_allclose(getattr(a, field).detach().numpy(),
                                       np.asarray(getattr(b, field)),
                                       rtol=0, atol=1e-12)
    for p, g, name in zip(params, grads, ("sigma", "epsilon")):
        want = float(g_j[name])
        assert abs(want) > 0
        np.testing.assert_allclose(g.item(), want, rtol=1e-9)
