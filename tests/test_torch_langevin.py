"""The port's BAOAB ``Langevin`` against the JAX package's
(tests/test_md_extras.py:28-72 mirrored).

The port draws its noise from a ``torch.Generator`` seeded per step, not
from JAX's threefry, so the parity tests pass JAX's own draws in through
``noise_fn`` (``normal(fold_in(PRNGKey(seed), noise_step0 + i))``).  The
system is tests/test_md_extras.py's: 108 FCC atoms at a = 1.679, LJ at
cutoff 2.4, dense.  Trajectories and gradients compare in float64, the
JAX side inside ``jax.enable_x64(True)``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.md import Langevin as LangevinJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import thermo, units

SIGMA = float(np.float32(0.95))   # the port's parameters are float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(cls):
    s = cls.from_lattice("fcc", 3, 1.679)
    s.set_temperature(0.8 / units.kB, rng=np.random.default_rng(11))
    return s


def _jax_noise(seed):
    """``noise_fn`` giving the JAX package's draws in float64."""
    key = jax.random.PRNGKey(seed)

    def noise_fn(index, shape):
        with jax.enable_x64(True):
            z = jax.random.normal(jax.random.fold_in(key, np.uint32(index)),
                                  shape, dtype=jnp.float64)
            return torch.tensor(np.asarray(z))
    return noise_fn


def _port(adjoint=False, seed=5, friction=0.1, noise_fn=None, T=1.0,
          dtype=torch.float64):
    s = _system(mt.System)
    pair = mt.PairPotentials(s, mt.potentials.LennardJones(sigma=SIGMA),
                             cutoff=2.4, mode="dense", device="cpu")
    integ = mt.Langevin(pair.to(dtype), s, T=T / units.kB,
                        friction=friction, adjoint=adjoint, seed=seed,
                        noise_fn=noise_fn, device="cpu", dtype=dtype)
    return s, pair, integ, mt.Simulation(s, integ)


def test_trajectory_matches_jax_with_its_noise():
    """Two 10-step epochs (the second's noise from ``noise_step0`` 9) equal
    JAX's to 1e-10 when the port draws JAX's noise."""
    with jax.enable_x64(True):
        sj = _system(SystemJ)
        pair_j = PairPotentialsJ(sj, potentials_j.LennardJones(sigma=SIGMA),
                                 cutoff=2.4, mode="dense")
        integ_j = LangevinJ(pair_j, sj, T=1.0 / units_j.kB, friction=0.1,
                            adjoint=False, seed=5)
        sim_j = SimulationJ(sj, integ_j)
        t1_j = sim_j.simulate(steps=10, dt=0.005, frequency=10)
        t2_j = sim_j.simulate(steps=10, dt=0.005, frequency=10)
        ref = [np.asarray(t.q) for t in (t1_j, t2_j)] + \
            [np.asarray(t.v) for t in (t1_j, t2_j)]
    _, _, _, sim = _port(noise_fn=_jax_noise(5))
    t1 = sim.simulate(steps=10, dt=0.005, frequency=10)
    t2 = sim.simulate(steps=10, dt=0.005, frequency=10)
    got = [t1.q, t2.q, t1.v, t2.v]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10)


def _loss(traj):
    return (traj.q[-1] ** 2).sum() + (traj.v[::3] ** 2).sum()


def test_replay_gradient_equals_direct_and_jax():
    """d/d(sigma, eps) of a loss on an 8-frame epoch: the replay adjoint
    (which re-runs each step, so redraws its noise) equals direct autograd
    to 1e-9, and JAX's ``jax.grad`` with the same noise."""
    grads = {}
    for adjoint in (True, False):
        _, pair, integ, sim = _port(adjoint=adjoint, noise_fn=_jax_noise(5))
        state, aux = sim.initial_state()
        traj, _ = sim.epoch_fn(0.005, 8)(state, aux, integ.default_ctrl())
        _loss(traj).backward()
        grads[adjoint] = torch.stack([pair.model.sigma.grad,
                                      pair.model.epsilon.grad])
    np.testing.assert_allclose(grads[True].numpy(), grads[False].numpy(),
                               rtol=1e-9)
    with jax.enable_x64(True):
        sj = _system(SystemJ)
        pair_j = PairPotentialsJ(sj, potentials_j.LennardJones(sigma=SIGMA),
                                 cutoff=2.4, mode="dense")
        integ_j = LangevinJ(pair_j, sj, T=1.0 / units_j.kB, friction=0.1,
                            adjoint=True, seed=5)
        sim_j = SimulationJ(sj, integ_j)
        ode = sim_j.epoch_fn(0.005, 8)
        state, aux = sim_j.initial_state()
        g = jax.grad(lambda p: _loss(ode(p, state, aux,
                                         integ_j.default_ctrl())[0]))(
            sim_j.params)
        ref = np.array([float(g["sigma"]), float(g["epsilon"])])
    assert np.all(np.abs(ref) > 0)
    np.testing.assert_allclose(grads[True].numpy(), ref, rtol=1e-8)


def test_default_noise_is_a_function_of_the_step_index():
    """The port's own draws: the same index gives the same bits, another
    index or seed other ones; the replay with them equals direct."""
    _, _, integ, _ = _port(seed=3, dtype=torch.float32)
    a, b = integ.noise_fn(7, (4, 3)), integ.noise_fn(8, (4, 3))
    assert torch.equal(a, integ.noise_fn(7, (4, 3)))
    assert not torch.equal(a, b)
    _, _, other, _ = _port(seed=4, dtype=torch.float32)
    assert not torch.equal(a, other.noise_fn(7, (4, 3)))
    grads = {}
    for adjoint in (True, False):
        _, pair, integ, sim = _port(adjoint=adjoint)
        state, aux = sim.initial_state()
        traj, _ = sim.epoch_fn(0.005, 8)(state, aux, integ.default_ctrl())
        _loss(traj).backward()
        grads[adjoint] = pair.model.sigma.grad.item()
    assert grads[True] != 0
    np.testing.assert_allclose(grads[True], grads[False], rtol=1e-9)


def test_langevin_controls_temperature():
    """Friction 5 holds the kinetic temperature within 15% of its target
    (1.1) over the last half of 5 x 120 steps, with the port's noise."""
    target = 1.1
    s, _, integ, sim = _port(friction=5.0, T=target, seed=3,
                             dtype=torch.float32)
    traj = None
    for _ in range(5):
        traj = sim.simulate(steps=120, dt=0.005, frequency=120)
    temps = [thermo.temperature(traj.v[i], s.get_masses()).item()
             for i in range(60, 119, 10)]
    assert abs(np.mean(temps) - target) / target < 0.15, temps


def test_langevin_noise_advances_between_epochs():
    """``noise_step0`` moves on by an epoch's steps: epoch 2 draws other
    noise than epoch 1, as JAX's does; ``update_T`` returns the new
    ctrl."""
    _, _, integ, sim = _port(dtype=torch.float32)
    t1 = sim.simulate(steps=10, dt=0.005, frequency=10)
    t2 = sim.simulate(steps=10, dt=0.005, frequency=10)
    assert not np.allclose((t1.v[1] - t1.v[0]).numpy(),
                           (t2.v[1] - t2.v[0]).numpy())
    ctrl = integ.advance_ctrl(integ.default_ctrl(), 9)
    assert ctrl["noise_step0"] == 9 and isinstance(ctrl["noise_step0"], int)
    new = integ.update_T(2.0 / units.kB)
    assert new["noise_step0"] == 0
    np.testing.assert_allclose(new["kT"].item(), 2.0)
