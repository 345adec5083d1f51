"""The port's LJ slice against the JAX package: NVE, the fused-kernel
interaction ``PallasLJPair`` (its kernels' plain versions on the CPU)
sampling and differentiated through the replay adjoint into (sigma,
epsilon), and the README quickstart.

All on the 108-atom FCC box at a = 1.679 of tests/test_pallas.py.
float64 comparisons run the JAX side inside ``jax.enable_x64(True)``
(never the global flag); float32 ones hold the port to the JAX Pallas
path in interpret mode.
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
from mdgrad_tpu.nn.layers import GaussianSmearing as GaussianSmearingJ
from mdgrad_tpu.observables import rdf as rdf_j
from mdgrad_tpu.ops.pallas_pair import PallasLJPair as PallasLJPairJ
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import ops, units


def _fcc(cls, seed):
    """108-atom FCC at a = 1.679, T = 1 in energy units from ``seed``;
    positions perturbed as tests/test_pallas.py::perturbed_fcc does."""
    s = cls.from_lattice("fcc", 3, 1.679)
    s.positions = s.positions + np.random.default_rng(1).normal(
        0, 0.05, (108, 3))
    s.set_temperature(1.0 / units.kB, rng=np.random.default_rng(seed))
    return s


def _rdf_j(s, nbins, r_range):
    """The JAX rdf with its Gaussian centres spread to the float32 last bin
    edge, as the JAX package does without x64 and the port always does: in
    x64 its edge is float64, which moves the centres by ~1e-8 and an RDF
    loss by ~1e-6 relative."""
    obs = rdf_j(s, nbins=nbins, r_range=r_range)
    obs.smear = GaussianSmearingJ(r_range[0], float(np.float32(obs.bins[-1])),
                                  nbins)
    return obs


def _f64(module, **values):
    """``module.double()`` with its parameters set to ``values`` exactly
    (they are created float32, as the JAX package's are without x64)."""
    module = module.double()
    with torch.no_grad():
        for name, value in values.items():
            module.get_parameter(name).fill_(value)
    return module


def test_nve_dense_matches_jax_f64():
    """20 NVE steps under a dense LennardJones pair, float64 on both sides:
    positions and velocities agree to rel 1e-10 (roundoff only)."""
    with jax.enable_x64(True):
        s = _fcc(SystemJ, 3)
        pair = PairPotentialsJ(s, potentials_j.LennardJones(0.95, 1.0),
                               cutoff=2.4, mode="dense")
        traj_j = SimulationJ(s, NVEJ(pair, s, adjoint=False)).simulate(
            steps=21, dt=0.002, frequency=21)
        q_j, v_j = np.asarray(traj_j.q), np.asarray(traj_j.v)
    s = _fcc(mt.System, 3)
    pair = _f64(mt.PairPotentials(s, mt.potentials.LennardJones(), cutoff=2.4,
                                  mode="dense", device="cpu"),
                **{"model.sigma": 0.95, "model.epsilon": 1.0})
    integ = mt.NVE(pair, s, adjoint=False, device="cpu", dtype=torch.float64)
    sim = mt.Simulation(s, integ)
    traj = sim.simulate(steps=21, dt=0.002, frequency=21)
    assert type(traj).__name__ == "NVEStateF" and traj.q.shape == (21, 108, 3)
    assert len(sim.log["positions"]) == 1 and list(sim.log) == [
        "velocities", "positions"]
    for got, ref in ((traj.q, q_j), (traj.v, v_j)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())


def test_pallas_lj_pair_runs_nve_md():
    """PallasLJPair drives NVE through Simulation.simulate: the integrator
    takes its force (K6's plain version here, once per step and once per
    epoch entry); energy is conserved to 1e-2 as in
    tests/test_pallas.py::test_pallas_interaction_runs_md, and the
    trajectory follows the JAX Pallas path (interpret mode): float32 over
    19 steps, ~1e-7; the bound is 1e-5."""
    s_j = _fcc(SystemJ, 3)
    pair_j = PallasLJPairJ(s_j, cutoff=2.4, sigma=1.0, epsilon=1.0,
                           interpret=True)
    traj_j = SimulationJ(s_j, NVEJ(pair_j, s_j, adjoint=False)).simulate(
        steps=20, dt=0.002, frequency=20)
    s = _fcc(mt.System, 3)
    pair = mt.ops.PallasLJPair(s, cutoff=2.4, sigma=1.0, epsilon=1.0,
                               device="cpu")
    sim = mt.Simulation(s, mt.NVE(pair, s, adjoint=False, device="cpu"))
    ops.reset_counts()
    traj = sim.simulate(steps=20, dt=0.002, frequency=20)
    calls = ops.counts()["plain_calls"]
    assert calls["lj_force"] == 20 and calls["lj_energy_forces"] == 0
    assert calls["lj_force_vjp"] == 0
    assert bool(torch.isfinite(traj.q).all())
    m = torch.tensor(s.get_masses(), dtype=torch.float32)[:, None]
    with torch.no_grad():
        e0, e1 = (float(0.5 * (m * traj.v[k] ** 2).sum()
                        + pair.energy(traj.q[k], ())) for k in (0, -1))
    assert abs(e1 - e0) / abs(e0) < 1e-2, (e0, e1)
    np.testing.assert_allclose(traj.q.numpy(), np.asarray(traj_j.q),
                               atol=1e-5)


def _chain_loss_jax(pair, s):
    """tests/test_pallas.py::test_differentiable_pallas_force_in_md_adjoint's
    loss: one NVE epoch of 7 steps (dt 0.003) through the replay adjoint,
    the RDF (24 bins over 0.8-2.3) of the last frame."""
    sim = SimulationJ(s, NVEJ(pair, s, adjoint=True))
    ode = sim.epoch_fn(dt=0.003, frequency=8)
    state, aux = sim.initial_state()
    obs = _rdf_j(s, 24, (0.8, 2.3))

    def loss(p):
        traj, _ = ode(p, state, aux, {})
        return (obs(traj.q[-1])[2] ** 2).mean()

    g = jax.grad(loss)(sim.params)
    return {k: float(g[k]) for k in ("sigma", "epsilon")}


def _chain_grads(pair, s, dtype):
    sim = mt.Simulation(s, mt.NVE(pair, s, adjoint=True, device="cpu",
                                  dtype=dtype))
    ode = sim.epoch_fn(dt=0.003, frequency=8)
    state, aux = sim.initial_state()
    obs = mt.observables.rdf(s, nbins=24, r_range=(0.8, 2.3), device="cpu")
    traj, _ = ode(state, aux, {})
    (obs(traj.q[-1])[2] ** 2).mean().backward()
    return {k: getattr(pair, k).grad.item() for k in ("sigma", "epsilon")}


def test_differentiable_chain_matches_jax_pallas():
    """RDF loss -> replay adjoint -> the differentiable force (K6 forward,
    K6b backward, their plain versions) -> d/d(sigma, epsilon), float32,
    against the JAX Pallas path in interpret mode at the JAX test's
    tolerance (rtol 5e-3): the force's vjp is the only second-order
    piece, and it runs once per replayed step."""
    s_j = _fcc(SystemJ, 2)
    g_j = _chain_loss_jax(PallasLJPairJ(s_j, cutoff=2.4, sigma=0.95,
                                        epsilon=1.0, interpret=True), s_j)
    s = _fcc(mt.System, 2)
    pair = mt.ops.PallasLJPair(s, cutoff=2.4, sigma=0.95, epsilon=1.0,
                               device="cpu")
    ops.reset_counts()
    g = _chain_grads(pair, s, torch.float32)
    calls = ops.counts()["plain_calls"]
    # forward: the entry prime and 7 steps; replay: 7 steps; one vjp per
    # replayed step and one for the primed entry force
    assert calls["lj_force"] == 8 + 7 and calls["lj_force_vjp"] == 8
    for k in ("sigma", "epsilon"):
        assert g[k] != 0.0
        np.testing.assert_allclose(g[k], g_j[k], rtol=5e-3, atol=1e-7)


def test_differentiable_chain_f64_matches_jax_dense():
    """The same chain in float64: PallasLJPair's plain kernels against the
    JAX dense LennardJones path's autodiff force (rel 1e-8; the observable's
    Gaussian basis is float32 on both sides)."""
    with jax.enable_x64(True):
        s_j = _fcc(SystemJ, 2)
        g_j = _chain_loss_jax(PairPotentialsJ(
            s_j, potentials_j.LennardJones(0.95, 1.0), cutoff=2.4,
            mode="dense"), s_j)
    s = _fcc(mt.System, 2)
    pair = _f64(mt.ops.PallasLJPair(s, cutoff=2.4, device="cpu"),
                sigma=0.95, epsilon=1.0)
    g = _chain_grads(pair, s, torch.float64)
    for k in ("sigma", "epsilon"):
        np.testing.assert_allclose(g[k], g_j[k], rtol=1e-8)


def _quickstart_jax(integrator):
    """README.md's quickstart, seeded: ExcludedVolume, 50 steps of sampling,
    then the RDF loss's gradient through one epoch of 49 steps."""
    s = SystemJ.from_lattice("fcc", 3, 1.679)
    s.set_temperature(1.0 / units_j.kB, rng=np.random.default_rng(0))
    pair = PairPotentialsJ(s, potentials_j.ExcludedVolume(
        sigma=0.9, epsilon=1.0, power=12), cutoff=2.5)
    if integrator == "nhc":
        integ = NoseHooverChainJ(pair, s, T=1.0 / units_j.kB, Q=50.0,
                                 num_chains=5, adjoint=True)
    else:
        integ = NVEJ(pair, s, adjoint=True)
    sim = SimulationJ(s, integ)
    traj = sim.simulate(steps=50, dt=0.01, frequency=50)
    obs = _rdf_j(s, 100, (0.75, 2.5))
    ode = sim.epoch_fn(dt=0.01, frequency=50)
    state, aux = sim.initial_state()

    def loss(params):
        t, _ = ode(params, state, aux, integ.default_ctrl())
        return ((obs(t.q[::5])[2] - 1.0) ** 2).mean()

    value, g = jax.value_and_grad(loss)(sim.params)
    return (np.asarray(traj.q), float(value),
            {k: float(g[k]) for k in ("sigma", "epsilon")})


@pytest.mark.parametrize("integrator", ["nhc", "nve"])
def test_readme_quickstart_matches_jax_f64(integrator):
    """README.md's quickstart (Nose-Hoover chain) and BASELINE.json config 1
    (the same with NVE) in float64: the sampled trajectory to rel 1e-10,
    the RDF loss and its gradient into (sigma, epsilon) to rel 1e-8 (the
    observable's Gaussian basis is float32 on both sides)."""
    with jax.enable_x64(True):
        q_j, loss_j, g_j = _quickstart_jax(integrator)
    s = mt.System.from_lattice("fcc", 3, 1.679)
    s.set_temperature(1.0 / units.kB, rng=np.random.default_rng(0))
    pair = _f64(mt.PairPotentials(s, mt.potentials.ExcludedVolume(power=12),
                                  cutoff=2.5, device="cpu"),
                **{"model.sigma": 0.9, "model.epsilon": 1.0})
    kw = {"adjoint": True, "device": "cpu", "dtype": torch.float64}
    if integrator == "nhc":
        integ = mt.NoseHooverChain(pair, s, T=1.0 / units.kB, Q=50.0,
                                   num_chains=5, **kw)
    else:
        integ = mt.NVE(pair, s, **kw)
    sim = mt.Simulation(s, integ)
    traj = sim.simulate(steps=50, dt=0.01, frequency=50)
    np.testing.assert_allclose(traj.q.numpy(), q_j, rtol=0,
                               atol=1e-10 * np.abs(q_j).max())
    obs = mt.observables.rdf(s, nbins=100, r_range=(0.75, 2.5), device="cpu")
    ode = sim.epoch_fn(dt=0.01, frequency=50)
    state, aux = sim.initial_state()
    t, _ = ode(state, aux, integ.default_ctrl())
    loss = ((obs(t.q[::5])[2] - 1.0) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-8)
    for k in ("sigma", "epsilon"):
        got = getattr(pair.model, k).grad.item()
        assert got != 0.0
        np.testing.assert_allclose(got, g_j[k], rtol=1e-8)
