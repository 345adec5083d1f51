"""System, units, geometry, the dense pair interaction and the Nose-Hoover
chain sampling loop of the port against the JAX package.

The trajectory test runs both sides in float64 (JAX inside the
``jax.enable_x64(True)`` context manager -- this JAX's spelling of
``jax.experimental.enable_x64()`` -- never the global flag) with
``gather_mode='gather'`` on the JAX side."""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import system as system_j
from mdgrad_tpu import topology as topology_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.interface import GNNPotentials as GNNPotentialsJ
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.interface import Stack as StackJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.nn import SchNet as SchNetJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import system as system_t
from mdgrad_tpu_torch import topology, units
from mdgrad_tpu_torch.data.registry import get_unit_len
from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy

L_WATER = get_unit_len(0.99749, 18.01528, 8)


def test_units_match_jax():
    for name in ("fs", "ps", "kB", "second"):
        assert getattr(units, name) == getattr(units_j, name)


@pytest.mark.parametrize("kind,size", [("diamond", 2), ("fcc", 3),
                                       ("bcc", (2, 3, 1))])
def test_system_bitwise_for_the_same_seed(kind, size):
    st = system_t.System.from_lattice(kind, size, 3.1, symbol="O")
    sj = system_j.System.from_lattice(kind, size, 3.1, symbol="O")
    st.set_temperature(298.0, rng=np.random.default_rng(7))
    sj.set_temperature(298.0, rng=np.random.default_rng(7))
    for a, b in ((st.positions, sj.positions), (st.velocities, sj.velocities),
                 (st.masses, sj.masses), (st.cell, sj.cell),
                 (st.numbers, sj.numbers)):
        np.testing.assert_array_equal(a, b)
    assert st.temperature() == sj.temperature()
    shifted = st.positions + np.array([7.5, -3.0, 11.0])
    np.testing.assert_array_equal(
        system_t.wrap_positions(shifted, st.cell),
        system_j.wrap_positions(shifted, sj.cell))
    with pytest.raises(TypeError):
        system_t.check_system(sj)
    system_t.check_system(st)


@pytest.mark.parametrize("cell", [np.diag([5.0, 6.0, 7.0]),
                                  np.array([[5.0, 0.0, 0.0], [1.0, 6.0, 0.0],
                                            [0.5, 0.7, 7.0]])])
def test_min_image_and_distances_match_jax(cell):
    rng = np.random.default_rng(3)
    xyz = (rng.uniform(-0.2, 1.2, (40, 3)) @ cell).astype(np.float32)
    cell32 = cell.astype(np.float32)
    d_t, off_t = topology.displacement_matrix(torch.tensor(xyz),
                                              torch.tensor(cell32))
    d_j, off_j = topology_j.displacement_matrix(jnp.asarray(xyz),
                                                jnp.asarray(cell32))
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    r_t, v_t = topology.distance_matrix(torch.tensor(xyz),
                                        torch.tensor(cell32))
    r_j, v_j = topology_j.distance_matrix(jnp.asarray(xyz),
                                          jnp.asarray(cell32))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-6)
    assert bool(topology.image_drift(torch.tensor(xyz), torch.tensor(cell32))) \
        == bool(topology_j.image_drift(jnp.asarray(xyz), jnp.asarray(cell32)))
    assert bool(topology.image_drift(torch.tensor(xyz) + 3 * 7.0,
                                     torch.tensor(cell32)))


def test_pair_mask_capacity_and_aux_flags_match_jax():
    idx = (np.arange(5), np.arange(5, 12))
    ex = np.array([[0, 1], [2, 7]])
    np.testing.assert_array_equal(
        topology.pair_index_mask(12, idx, ex).numpy(),
        np.asarray(topology_j.pair_index_mask(12, idx, ex)))
    assert topology.pair_index_mask(12) is None
    s = system_t.System.from_lattice("fcc", 3, 1.679)
    xyz = s.get_positions().astype(np.float32)
    assert topology.estimate_capacity(
        torch.tensor(xyz), 1.5, torch.tensor(np.diag(s.cell))) == \
        topology_j.estimate_capacity(jnp.asarray(xyz), 1.5, s.cell)
    t = topology.generate_neighbor_table(
        torch.tensor(xyz), 1.5, torch.tensor(np.diag(s.cell)), 16)
    assert not topology.aux_overflow({"nn": t, "prior": ()})
    assert topology.aux_overflow({"nn": t._replace(overflow=torch.tensor(
        True)), "prior": ()})
    assert not topology.aux_drift({"nn": t})


def test_dense_pair_energy_forces_match_jax():
    s_t = system_t.System.from_lattice("fcc", 3, 1.679)
    s_j = system_j.System.from_lattice("fcc", 3, 1.679)
    rng = np.random.default_rng(1)
    xyz = (s_t.positions + rng.normal(0, 0.05, (108, 3))).astype(np.float32)
    pair_j = PairPotentialsJ(s_j, potentials_j.ExcludedVolume(
        sigma=0.9, epsilon=1.0, power=12), cutoff=2.5, mode="dense")
    pair_t = mt.PairPotentials(s_t, mt.potentials.ExcludedVolume(
        sigma=0.9, epsilon=1.0, power=12), cutoff=2.5, device="cpu")
    p = pair_j.init_params()
    u_j = float(pair_j.energy(p, jnp.asarray(xyz), ()))
    f_j = -np.asarray(jax.grad(pair_j.energy, argnums=1)(
        p, jnp.asarray(xyz), ()))
    x = torch.tensor(xyz, requires_grad=True)
    u_t = pair_t.energy(x, ())
    (g,) = torch.autograd.grad(u_t, x)
    # f32 sums over ~4000 pairs in another order
    np.testing.assert_allclose(u_t.item(), u_j, rtol=1e-5)
    np.testing.assert_allclose(-g.numpy(), f_j,
                               atol=1e-5 * np.abs(f_j).max())


WIDTHS = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 2, "cutoff": 6.0}


def _jax_nhc_run(steps, frequency):
    with jax.enable_x64(True):
        s = system_j.System.from_lattice("diamond", 2, L_WATER, symbol="O")
        s.masses = np.full(64, 18.01528)
        s.set_temperature(298.0, rng=np.random.default_rng(0))
        stack = StackJ({
            "nn": GNNPotentialsJ(s, SchNetJ({
                **WIDTHS, "gather_mode": "gather",
                "compute_dtype": jnp.float64}), cutoff=6.0,
                capacity_slack=1.25),
            "prior": PairPotentialsJ(s, potentials_j.ExcludedVolume(
                sigma=2.6, epsilon=0.01, power=12), cutoff=6.0,
                mode="dense")})
        integ = NoseHooverChainJ(stack, s, T=298.0, Q=50.0, num_chains=5,
                                 adjoint=False)
        sim = SimulationJ(s, integ)
        traj = sim.simulate(steps=steps, dt=0.5 * units_j.fs,
                            frequency=frequency)
        params = jax.tree_util.tree_map(np.asarray, sim.params)
        return (params, {k: np.stack(v) for k, v in sim.log.items()},
                jax.tree_util.tree_map(np.asarray, traj))


def test_nhc_trajectory_matches_jax_f64():
    """Water-shaped 64-site Stack{SchNet, ExcludedVolume} under the NHC
    (T=298 K, Q=50, 5 chains, dt=0.5 fs): 3 epochs x 9 steps in float64.
    The JAX SchNet still rounds its embedding and each convolution's
    output to float32 (nn/schnet.py casts them), so forces agree to ~1e-7
    relative, not 1e-15; over 27 steps positions, velocities and bath
    momenta then differ by ~1e-8 (measured on the CPU).  The 1e-6 bounds
    are ~100x that and far below one step's displacement (~4e-3 A)."""
    params, log_j, traj_j = _jax_nhc_run(steps=30, frequency=10)
    s = mt.System.from_lattice("diamond", 2, L_WATER, symbol="O")
    s.masses = np.full(64, 18.01528)
    s.set_temperature(298.0, rng=np.random.default_rng(0))
    stack = mt.Stack({
        "nn": mt.GNNPotentials(s, mt.SchNet({**WIDTHS, "gather_mode":
                                             "pallas"}),
                               cutoff=6.0, capacity_slack=1.25, device="cpu"),
        "prior": mt.PairPotentials(s, mt.potentials.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, device="cpu")})
    stack.load_state_dict(stack_params_from_numpy(params, stack))
    stack.double()
    integ = mt.NoseHooverChain(stack, s, T=298.0, Q=50.0, num_chains=5,
                               device="cpu", dtype=torch.float64)
    sim = mt.Simulation(s, integ)
    traj = sim.simulate(steps=30, dt=0.5 * units.fs, frequency=10)
    assert traj.q.shape == (10, 64, 3) and traj.q.dtype == torch.float64
    assert len(sim.log["positions"]) == 3 and not sim.overflowed
    np.testing.assert_allclose(traj.q.numpy(), traj_j.q, atol=1e-6)
    np.testing.assert_allclose(traj.v.numpy(), traj_j.v, atol=1e-6)
    np.testing.assert_allclose(traj.pv.numpy(), traj_j.pv, atol=1e-6)
    for key in ("positions", "velocities", "baths"):
        np.testing.assert_allclose(torch.stack(sim.log[key]).numpy(),
                                   log_j[key], atol=1e-6)
    # the host System follows the log, as in the JAX package
    np.testing.assert_allclose(s.positions, log_j["positions"][-1],
                               atol=1e-6)


def test_simulation_flags_overflow():
    s = mt.System.from_lattice("diamond", 2, L_WATER, symbol="O")
    s.set_temperature(298.0, rng=np.random.default_rng(0))
    gnn = mt.GNNPotentials(s, mt.SchNet(WIDTHS), cutoff=6.0, k_max=16,
                           device="cpu")
    sim = mt.Simulation(s, mt.NoseHooverChain(gnn, s, T=298.0, Q=50.0,
                                              device="cpu"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sim.simulate(steps=4, dt=0.5 * units.fs, frequency=4)
    assert sim.overflowed and not sim.drifted
    assert any("overflow" in str(x.message) for x in w)
