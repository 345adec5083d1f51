"""The port's multiple-time-step Nose-Hoover chain
(``md/integrators.py::MTSNoseHooverChain``): ``TestMTS`` of
tests/test_integrators.py on the port, the trajectory against the JAX
``MTSNoseHooverChain`` in float64 (JAX inside ``jax.enable_x64(True)``),
the replay adjoint's gradient against direct backprop through the outer
steps (the inner loop is not stored; the replay re-runs it), and the
forces an outer step evaluates."""

import numpy as np
import jax
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import system as system_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.interface import Stack as StackJ
from mdgrad_tpu.md import MTSNoseHooverChain as MTSJ
from mdgrad_tpu.md import Simulation as SimulationJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import thermo, units

F64 = torch.float64
# exact in float32, so the float64 runs of both packages start alike
LJ, PRIOR = (1.0, 1.0), (0.875, 0.0625)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(lib=mt):
    s = lib.System.from_lattice("fcc", 3, 1.679)
    s.set_temperature(1.0 / units.kB, rng=np.random.default_rng(3))
    return s


def _build(n_inner, dtype=torch.float32, adjoint=True, prior=(0.9, 0.05),
           single_rate=False):
    s = _system()
    stack = mt.Stack({
        "lj": mt.PairPotentials(s, mt.potentials.LennardJones(*LJ),
                                cutoff=2.5, mode="dense", device="cpu"),
        "pair": mt.PairPotentials(s, mt.potentials.ExcludedVolume(
            sigma=prior[0], epsilon=prior[1], power=12), cutoff=2.5,
            mode="dense", device="cpu")})
    stack.to(dtype)
    kw = dict(T=1.0 / units.kB, Q=50.0, num_chains=3, adjoint=adjoint,
              device="cpu", dtype=dtype)
    if single_rate:
        return s, stack, mt.NoseHooverChain(stack, s, **kw)
    return s, stack, mt.MTSNoseHooverChain(stack, s, fast_keys=("pair",),
                                           n_inner=n_inner, **kw)


def _final_q(n_inner, dt, steps, single_rate=False):
    s, _, integ = _build(n_inner, single_rate=single_rate)
    traj = mt.Simulation(s, integ).simulate(steps=steps, dt=dt,
                                            frequency=steps)
    return traj.q[-1].numpy()


def test_converges_to_single_rate():
    """At one outer dt the k = 2 split tracks the single-rate chain to the
    float32 noise floor (5e-4), at dt 0.004 and 0.001."""
    for dt in (0.004, 0.001):
        err = np.abs(_final_q(2, dt, 16)
                     - _final_q(1, dt, 16, single_rate=True)).max()
        assert err < 5e-4, (dt, err)


def test_temperature_control():
    s, _, integ = _build(4)
    sim = mt.Simulation(s, integ)
    for _ in range(6):
        traj = sim.simulate(steps=100, dt=0.005, frequency=10)
    temps = [thermo.temperature(traj.v[i], s.get_masses(), dim=3).item()
             for i in range(traj.v.shape[0])]
    assert abs(np.mean(temps[3:]) - 1.0) < 0.25, temps


def _rdf_loss_grads(integ, s):
    sim = mt.Simulation(s, integ)
    obs = mt.observables.rdf(s, nbins=50, r_range=(0.75, 2.5), device="cpu")
    state, aux = sim.initial_state()
    traj, _ = sim.epoch_fn(dt=0.005, frequency=10)(state, aux,
                                                   integ.default_ctrl())
    loss = ((obs(traj.q[::2])[2] - 1.0) ** 2).mean()
    params = list(integ.model.parameters())
    return loss.item(), torch.autograd.grad(loss, params)


def test_adjoint_gradients_flow():
    """Gradients of an RDF loss through 9 outer steps reach both the slow
    and the fast model's parameters, finite."""
    s, stack, integ = _build(2)
    _, grads = _rdf_loss_grads(integ, s)
    assert all(torch.isfinite(g).all() for g in grads)
    names = [n for n, _ in stack.named_parameters()]
    g = dict(zip(names, grads))
    assert g["models.lj.model.epsilon"].abs() > 0
    assert g["models.pair.model.epsilon"].abs() > 0


def test_replay_matches_direct_backprop_f64():
    """The replay adjoint re-runs each outer step, inner loop included, at
    create_graph: its gradient equals direct backprop through the steps
    to 1e-11 relative in float64."""
    out = []
    for adjoint in (True, False):
        s, _, integ = _build(3, dtype=F64, adjoint=adjoint, prior=PRIOR)
        out.append(_rdf_loss_grads(integ, s))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-13)
    for a, b in zip(out[0][1], out[1][1]):
        assert b.abs() > 0
        np.testing.assert_allclose(a.item(), b.item(), rtol=1e-11)


def test_trajectory_matches_jax_f64():
    """8 outer steps at k = 2 and dt 0.005 from the same seeded state in
    float64: positions, velocities, bath momenta and the cached slow force
    within 1e-11 of the JAX package's."""
    s, _, integ = _build(2, dtype=F64, prior=PRIOR)
    traj = mt.Simulation(s, integ).simulate(steps=8, dt=0.005, frequency=8)
    with jax.enable_x64(True):
        s_j = _system(system_j)
        stack_j = StackJ({
            "lj": PairPotentialsJ(s_j, potentials_j.LennardJones(*LJ),
                                  cutoff=2.5, mode="dense"),
            "pair": PairPotentialsJ(s_j, potentials_j.ExcludedVolume(
                sigma=PRIOR[0], epsilon=PRIOR[1], power=12), cutoff=2.5,
                mode="dense")})
        integ_j = MTSJ(stack_j, s_j, T=1.0 / units.kB, fast_keys=("pair",),
                       n_inner=2, Q=50.0, num_chains=3)
        traj_j = SimulationJ(s_j, integ_j).simulate(steps=8, dt=0.005,
                                                    frequency=8)
        traj_j = jax.tree_util.tree_map(np.asarray, traj_j)
    assert traj_j.q.dtype == np.float64
    for field in ("q", "v", "pv", "f"):
        np.testing.assert_allclose(getattr(traj, field).numpy(),
                                   getattr(traj_j, field), rtol=0,
                                   atol=1e-11)


def test_forces_per_outer_step():
    """One outer step at k = 3 evaluates the slow force once and the fast
    force k + 1 times; the cache holds the slow force alone."""
    s, stack, integ = _build(3)
    calls = {"lj": 0, "pair": 0}
    for key, child in stack.models.items():
        real = child.energy

        def counted(*a, key=key, real=real, **kw):
            calls[key] += 1
            return real(*a, **kw)
        child.energy = counted
    state, aux = integ.prime_state(integ.initial_state(), integ.aux_init(
        torch.tensor(s.get_positions(), dtype=torch.float32)))
    assert calls == {"lj": 1, "pair": 0}
    new = integ.step(state, aux, integ.default_ctrl(), 0.005)
    assert calls == {"lj": 2, "pair": 4}
    slow = -torch.autograd.grad(
        stack.models["lj"].energy(new.q.requires_grad_(True), ()), new.q)[0]
    np.testing.assert_allclose(new.f.numpy(), slow.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(TypeError):
        mt.MTSNoseHooverChain(stack.models["lj"], s, T=1.0, device="cpu")
    with pytest.raises(ValueError):
        mt.MTSNoseHooverChain(stack, s, T=1.0, fast_keys=("nope",),
                              device="cpu")
