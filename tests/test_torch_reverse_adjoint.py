"""The port's reverse-time adjoint (``make_odeint(...,
reverse_step_fn=...)``, ``integrator.adjoint == "reverse"`` through
``Simulation.epoch_fn``) against the replay adjoint and against the JAX
package's reverse-time adjoint (tests/test_adjoint.py:138 mirrored).

The forward keeps the endpoints only; the backward re-integrates at -dt
from the last state and takes each step's vector-Jacobian product at the
reconstructed state.  Reconstruction drifts at the rate of float roundoff,
so the gradients agree with the replay's to roundoff in float64 (held to
1e-8 here) and to a looser bound in float32 (2e-3, as JAX's own test).
The system: tests/test_adjoint.py's 32 FCC atoms at a = 1.679, LJ (0.95,
1.0) at cutoff 1.6, NVE, dt 0.002, 29 steps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.md import NVE as NVEJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import units
from mdgrad_tpu_torch.md.adjoint import make_odeint
from mdgrad_tpu_torch.ops import PallasLJPair

SIGMA = float(np.float32(0.95))   # the port's parameters are float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(cls):
    s = cls.from_lattice("fcc", 2, 1.679)
    s.set_temperature(1.0 / units.kB, rng=np.random.default_rng(7))
    return s


def _port(adjoint, dtype=torch.float64, nhc=False, pallas=False):
    s = _system(mt.System)
    if pallas:
        pair = PallasLJPair(s, cutoff=1.6, sigma=SIGMA, epsilon=1.0,
                            device="cpu")
    else:
        pair = mt.PairPotentials(s, mt.potentials.LennardJones(SIGMA, 1.0),
                                 cutoff=1.6, mode="dense",
                                 device="cpu").to(dtype)
    if nhc:
        integ = mt.NoseHooverChain(pair, s, T=1.0 / units.kB, Q=5.0,
                                   num_chains=3, adjoint=adjoint,
                                   device="cpu", dtype=dtype)
    else:
        integ = mt.NVE(pair, s, adjoint=adjoint, device="cpu", dtype=dtype)
    return pair, integ, mt.Simulation(s, integ)


def _params(pair):
    if isinstance(pair, PallasLJPair):
        return pair.sigma, pair.epsilon
    return pair.model.sigma, pair.model.epsilon


def _run(adjoint, **kw):
    """(traj, d/d(sigma, eps), d/dq0) of (q_T^2).sum() + (v_T^2).sum()."""
    pair, integ, sim = _port(adjoint, **kw)
    state, aux = sim.initial_state()
    q0 = state.q.clone().requires_grad_(True)
    traj, _ = sim.epoch_fn(0.002, 30)(state._replace(q=q0), aux,
                                      integ.default_ctrl())
    loss = (traj.q[-1] ** 2).sum() + (traj.v[-1] ** 2).sum()
    loss.backward()
    return (traj, torch.stack([p.grad for p in _params(pair)]).double(),
            q0.grad)


def test_reverse_matches_replay_f64():
    """NVE: the reverse-time gradients in (sigma, eps) and in the initial
    positions equal the replay's to 1e-8, the forward's last state to
    1e-12; the reverse traj holds 2 frames.  (The Nose-Hoover step at -dt
    does not undo the step exactly -- its half kicks read the bath at
    other points -- so there the reverse-time gradient is an
    approximation, in both packages: see the next test.)"""
    t_rev, g_rev, q_rev = _run("reverse")
    t_rep, g_rep, q_rep = _run(True)
    assert t_rev.q.shape[0] == 2 and t_rep.q.shape[0] == 30
    np.testing.assert_allclose(t_rev.q[-1].detach().numpy(),
                               t_rep.q[-1].detach().numpy(), rtol=0,
                               atol=1e-12)
    assert np.all(np.abs(g_rep.numpy()) > 0)
    np.testing.assert_allclose(g_rev.numpy(), g_rep.numpy(), rtol=1e-8)
    np.testing.assert_allclose(q_rev.numpy(), q_rep.numpy(), rtol=0,
                               atol=1e-8 * np.abs(q_rep.numpy()).max())


@pytest.mark.parametrize("nhc", [False, True], ids=["nve", "nhc"])
def test_reverse_matches_jax_reverse_f64(nhc):
    """The port's reverse-time gradient equals JAX's reverse-time
    ``jax.grad`` through its ``epoch_fn`` (float64), for NVE and for a
    Nose-Hoover chain (Q 5, 3 links), whose reconstruction both packages
    take the same way."""
    with jax.enable_x64(True):
        sj = _system(SystemJ)
        pair_j = PairPotentialsJ(sj, potentials_j.LennardJones(SIGMA, 1.0),
                                 cutoff=1.6, mode="dense")
        if nhc:
            integ_j = NoseHooverChainJ(pair_j, sj, T=1.0 / units_j.kB,
                                       Q=5.0, num_chains=3,
                                       adjoint="reverse")
        else:
            integ_j = NVEJ(pair_j, sj, adjoint="reverse")
        sim_j = SimulationJ(sj, integ_j)
        ode = sim_j.epoch_fn(dt=0.002, frequency=30)
        state, aux = sim_j.initial_state()

        def loss(p):
            traj, _ = ode(p, state, aux, integ_j.default_ctrl())
            return (traj.q[-1] ** 2).sum() + (traj.v[-1] ** 2).sum()

        g = jax.grad(loss)(sim_j.params)
        ref = np.array([float(g["sigma"]), float(g["epsilon"])])
    _, g_rev, _ = _run("reverse", nhc=nhc)
    np.testing.assert_allclose(g_rev.numpy(), ref, rtol=1e-8)
    if nhc:
        _, g_rep, _ = _run(True, nhc=True)
        np.testing.assert_allclose(g_rev.numpy(), g_rep.numpy(), rtol=1e-3)


def test_reverse_on_the_lj_kernels_f32():
    """``PallasLJPair`` (the K6 force and its K6b vjp, plain versions on
    the CPU) in float32: the reverse-time gradient against the replay's,
    to JAX's own tolerance (rtol 2e-3)."""
    _, g_rev, _ = _run("reverse", dtype=torch.float32, pallas=True)
    _, g_rep, _ = _run(True, dtype=torch.float32, pallas=True)
    np.testing.assert_allclose(g_rev.numpy(), g_rep.numpy(), rtol=2e-3,
                               atol=1e-6)


def test_reverse_needs_refresh_every_step():
    """``update_freq != 1`` raises, as in the JAX package; the sampling
    path (no grad) returns the two endpoints too."""
    with pytest.raises(ValueError, match="topology_update_freq == 1"):
        make_odeint(lambda *a: None, lambda s, a: a, 5, update_freq=2,
                    adjoint=True, reverse_step_fn=lambda *a: None)
    _, integ, sim = _port("reverse")
    state, aux = sim.initial_state()
    with torch.no_grad():
        traj, _ = sim.epoch_fn(0.002, 30)(state, aux, {})
    _, _, sim_rep = _port(True)
    with torch.no_grad():
        t_rep, _ = sim_rep.epoch_fn(0.002, 30)(state, aux, {})
    assert traj.q.shape[0] == 2
    np.testing.assert_array_equal(traj.q[-1].numpy(), t_rep.q[-1].numpy())
