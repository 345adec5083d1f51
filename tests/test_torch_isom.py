"""Quantum isomerization in the port (md/isomerization.py, train/isom.py)
against the JAX package: the four tests of tests/test_isom.py on the
port, the toy (D = 8) trajectory and e_field gradient against JAX in
float64, the field's grid index and on/off flag at every RK4 stage time
of the full retinal run against JAX's float32 arithmetic, ``calc_yields``
on the 716-dim retinal operators, and a 2-epoch ``fit_isomerization`` at
D = 716 against the JAX driver.  The retinal run reads the operators in
place from mdgrad_tpu/data/targets/isom."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu.md.adjoint import make_odeint as make_odeint_j
from mdgrad_tpu.md.integrators import rk4_step as rk4_step_j
from mdgrad_tpu.md.isomerization import Isomerization as IsomerizationJ
from mdgrad_tpu.train import isom as isom_j
from mdgrad_tpu_torch.md.isomerization import Isomerization, quantum_yield
from mdgrad_tpu_torch.md.tinydiffeq import rk4_step
from mdgrad_tpu_torch.train import isom


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_operators(dim=8, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((dim, dim))
    m = rng.standard_normal((dim, dim))
    t_field = np.linspace(0.0, 5.0, 50)
    return (h + h.T) / 2, (m + m.T) / 2, t_field, 0.3 * np.sin(t_field)


def make_toy(dim=8, seed=0, dtype=torch.float32):
    ham, dipole, t_field, e_t = toy_operators(dim, seed)
    return Isomerization(ham, dipole, t_field, e_t, max_e_t=5.0,
                         device="cpu", dtype=dtype)


def run(ode_obj, n_steps, dt=0.01):
    return isom.make_epoch(ode_obj, n_steps, dt)(
        [ode_obj.e_field], ode_obj.initial_state(), (), {})[0]


def run_j(ode_obj, params, n_steps, dt=0.01):
    def step_fn(p, s, aux, ctrl, i):
        return ode_obj.step(p, s, aux, ctrl, i * dt, dt)
    ode = make_odeint_j(step_fn, lambda s, a: a, n_steps, adjoint=True)
    return ode(params, ode_obj.initial_state(), (), {})[0]


def toy_ops(dim=8):
    prod = np.zeros((dim, dim))
    prod[3, 3] = 1.0
    reac = np.zeros((dim, dim))
    reac[0, 0] = 1.0
    return prod, reac


def test_norm_conservation():
    with torch.no_grad():
        traj = run(make_toy(), 400)
    norms = (traj.psi ** 2).sum(-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-3)


def test_matches_exact_propagator_field_free():
    """With E = 0, psi(t) = exp(-i H t) psi(0); RK4 must track it."""
    dim = 6
    rng = np.random.default_rng(1)
    h = rng.standard_normal((dim, dim))
    ham = (h + h.T) / 2
    ode_obj = Isomerization(ham, np.zeros((dim, dim)), np.linspace(0, 1, 10),
                            np.zeros(10), max_e_t=-1.0, device="cpu")
    n, dt = 200, 0.01
    with torch.no_grad():
        traj = run(ode_obj, n, dt)
    w, v = np.linalg.eigh(ham)
    psi0 = np.zeros(dim)
    psi0[0] = 1.0
    psi_exact = v @ (np.exp(-1j * w * n * dt) * (v.T @ psi0))
    got = traj.psi[-1].numpy()
    np.testing.assert_allclose(got[:dim] + 1j * got[dim:], psi_exact,
                               atol=1e-4)


def test_yield_gradients_flow_to_field():
    ode_obj = make_toy()
    prod, reac = (torch.tensor(a, dtype=torch.float32) for a in toy_ops())
    traj = run(ode_obj, 200)
    ys = isom.calc_yields(traj.psi, prod, reac)
    isom.objective(ys[3], look_back=100).backward()
    g = ode_obj.e_field.grad
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_retinal_short_run():
    """The retinal problem cut to 500 of 30479 steps: yields in [0, 1],
    finite mean yields (the JAX test skips without a mounted copy of the
    data; the port reads the JAX package's vendored operators)."""
    out = isom.fit_isomerization(n_epochs=2, lr=1e-2, n_steps=500,
                                 look_back=200, log=lambda *a: None,
                                 device="cpu")
    assert len(out["q_yields"]) == 2
    assert all(np.isfinite(v) for v in out["q_yields"])
    y4 = out["yields_t"][3]
    assert np.nanmax(y4) <= 1.0 + 1e-5 and np.nanmin(y4) >= -1e-5


def test_toy_trajectory_and_field_gradient_match_jax_f64():
    """D = 8, 300 RK4 steps through the replay adjoint in float64 on both
    sides: the trajectory within 1e-12 and d(objective)/d(e_field) within
    1e-10 relative to its largest entry (roundoff of two float64
    programs).  The objective is yield 1 of random projector-like
    operators (yield 4 of the toy projectors is 1 at every frame)."""
    n, dt, dim = 300, 0.01, 8
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, dim, dim))
    prod, reac = a @ a.T / dim, b @ b.T / dim
    ode_t = make_toy(dtype=torch.float64)
    traj = run(ode_t, n, dt)
    ys = isom.calc_yields(traj.psi, torch.tensor(prod), torch.tensor(reac))
    isom.objective(ys[0], look_back=100).backward()
    with jax.enable_x64(True):
        ode_j = IsomerizationJ(*toy_operators(dim)[:4], max_e_t=5.0)

        def loss(p):
            tr = run_j(ode_j, p, n, dt)
            y = isom_j.calc_yields(tr.psi, jnp.asarray(prod),
                                   jnp.asarray(reac))
            return isom_j.objective(y[0], look_back=100), tr.psi

        (lj, psi_j), g_j = jax.value_and_grad(loss, has_aux=True)(
            ode_j.init_params())
        psi_j, g_j = np.asarray(psi_j), np.asarray(g_j["e_field"])
    assert psi_j.dtype == np.float64
    np.testing.assert_allclose(traj.psi.detach().numpy(), psi_j, rtol=0,
                               atol=1e-12)
    g = ode_t.e_field.grad.numpy()
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(g, g_j, rtol=0,
                               atol=1e-10 * np.abs(g_j).max())
    # quantum_yield of the projector on state 3 is |psi_3|^2
    psi = traj.psi.detach()
    np.testing.assert_allclose(
        quantum_yield(psi, torch.tensor(toy_ops(dim)[0]), dim).numpy(),
        (psi[:, 3] ** 2 + psi[:, dim + 3] ** 2).numpy(), atol=1e-14)


def test_field_index_matches_jax_at_every_rk4_stage():
    """The retinal run's 30479 steps: at each of the four RK4 stage times
    (t, t + dt/3, t + 2 dt/3, t + dt) of every step, the port's grid index
    and on/off flag equal the JAX package's float32 ones exactly.  Both
    sides make the stage times with their own ``rk4_step`` on the vector
    of step times."""
    t_field, e_t, n_steps = isom.initialize_Et()
    assert n_steps == 30479 and t_field.shape == (6095,)
    ode_t = Isomerization(np.zeros((2, 2)), np.zeros((2, 2)), t_field, e_t,
                          max_e_t=float(t_field.max()), device="cpu")
    stages_t, stages_j = [], []

    def record(into):
        def derivs(s, t):
            into.append(t)
            return s
        return derivs

    rk4_step(record(stages_t), torch.zeros(1),
             ode_t.time(np.arange(n_steps), isom.DT), isom.DT)
    ode_j = IsomerizationJ(np.zeros((2, 2)), np.zeros((2, 2)), t_field,
                           e_t, max_e_t=float(t_field.max()))
    rk4_step_j(record(stages_j), jnp.zeros(1),
               jnp.arange(n_steps) * isom_j.DT, isom_j.DT)
    # e_field = 1..M: field_at gives index + 1 while on, 0 while off
    marks = {"e_field": jnp.arange(1, ode_j.n_field + 1, dtype=jnp.float32)}
    n_off = 0
    for t_t, t_j in zip(stages_t, stages_j):
        assert t_t.dtype == torch.float32 and t_j.dtype == jnp.float32
        np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
        idx, on = ode_t.field_index(t_t)
        got = np.where(on.numpy(), idx.numpy() + 1, 0)
        want = np.asarray(ode_j.field_at(marks, t_j))
        np.testing.assert_array_equal(got, want)
        n_off += int((~on).sum())
    # the field switches off halfway through the run
    assert 0 < n_off < 4 * n_steps


def test_calc_yields_on_retinal_operators_matches_jax():
    """Four yield definitions of 64 random normalised frames at D = 716 in
    float32: within 2e-5 relative of the JAX package's (the reductions
    of 716 terms differ in order)."""
    q = isom.make_quants()
    assert q["dim"] == 716 and q["ham"].dtype == np.float32
    rng = np.random.default_rng(5)
    psi = rng.standard_normal((64, 2 * 716)).astype(np.float32)
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    got = isom.calc_yields(torch.tensor(psi), torch.tensor(q["prod_op"]),
                           torch.tensor(q["reac_op"]))
    qj = isom_j.make_quants()
    want = isom_j.calc_yields(jnp.asarray(psi), jnp.asarray(qj["prod_op"]),
                              jnp.asarray(qj["reac_op"]))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5,
                                   atol=2e-5 * np.abs(b).max())


def test_fit_isomerization_matches_jax_at_716():
    """``fit_isomerization`` on the retinal operators (rounded to float32,
    as both drivers load them), 2 SGD epochs of 150 steps, look_back 100,
    in float64 on both sides: the mean yields within 1e-9 relative and the
    field's change over the fit within 1e-8 of its largest entry of the
    JAX driver's (float64 roundoff over 150 RK4 steps of 716-dim
    products; in float32 the yields, ~1e-4 here, agree to ~1e-4 only)."""
    kw = dict(n_epochs=2, lr=1e-2, n_steps=150, look_back=100,
              log=lambda *a: None)
    out = isom.fit_isomerization(device="cpu", dtype=torch.float64, **kw)
    with jax.enable_x64(True):
        out_j = isom_j.fit_isomerization(**kw)
        e_j = np.asarray(out_j["e_field"])
    assert out["e_field"].dtype == np.float64 and e_j.dtype == np.float64
    np.testing.assert_allclose(out["q_yields"], out_j["q_yields"], rtol=1e-9)
    e0 = isom.initialize_Et()[1]
    d, d_j = out["e_field"] - e0, e_j - e0
    assert np.abs(d).max() > 0
    np.testing.assert_allclose(d, d_j, rtol=0, atol=1e-8 * np.abs(d_j).max())
