"""The Verlet skin and ``topology_update_freq > 1`` in the port against the
JAX package.

``GNNPotentials(skin=...)`` builds its (N, K) table at ``cutoff + skin``
and SchNet masks each edge by its current length, so a table refreshed
every few steps stays exact while no atom moves more than skin / 2.  The
systems: tests/test_schnet.py's 32-atom FCC box for the exactness mirror,
and the 64-site water of tests/test_torch_slice.py (SchNet 16/16/8,
cutoff 6.0, skin 0.5) for the rest; the JAX side runs
``gather_mode='gather'`` (exact f32, or f64 in the gradient test) and the
port its K1 wrapper (the plain version on CPU tensors).  Also: the
``fit_rdf`` driver with ``gnn_skin`` and ``topology_update_freq = 3``
against the JAX driver, as tests/test_torch_fit.py runs it.
"""

import importlib
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
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
from mdgrad_tpu.observables import rdf as rdf_j
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import units
from mdgrad_tpu_torch.data.registry import get_unit_len
from mdgrad_tpu_torch.nn.convert import (schnet_params_from_numpy,
                                         stack_params_from_numpy)
from mdgrad_tpu_torch.train import fit_rdf

fit_rdf_j = importlib.import_module("mdgrad_tpu.train.fit_rdf")
L_WATER = get_unit_len(0.99749, 18.01528, 8)
WIDTHS = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 2, "cutoff": 6.0}
SKIN = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _water(cls, seed=0):
    s = cls.from_lattice("diamond", 2, L_WATER, symbol="O")
    s.masses = np.full(64, 18.01528)
    s.set_temperature(298.0, rng=np.random.default_rng(seed))
    return s


def _prior_j():
    return potentials_j.ExcludedVolume(sigma=2.6, epsilon=0.01, power=12)


def _prior():
    return mt.potentials.ExcludedVolume(sigma=2.6, epsilon=0.01, power=12)


def _stack_j(s, skin):
    return StackJ({
        "nn": GNNPotentialsJ(s, SchNetJ({**WIDTHS, "gather_mode": "gather"}),
                             cutoff=6.0, capacity_slack=1.25, skin=skin),
        "prior": PairPotentialsJ(s, _prior_j(), cutoff=6.0, mode="dense")})


def _stack(s, skin, params):
    stack = mt.Stack({
        "nn": mt.GNNPotentials(s, mt.SchNet(WIDTHS), cutoff=6.0,
                               capacity_slack=1.25, skin=skin, device="cpu"),
        "prior": mt.PairPotentials(s, _prior(), cutoff=6.0, mode="dense",
                                   device="cpu")})
    stack.load_state_dict(stack_params_from_numpy(params, stack))
    return stack


def test_verlet_skin_exactness():
    """Mirror of tests/test_schnet.py::test_verlet_skin_exactness on the
    port: a table built at cutoff + skin from stale positions gives the
    fresh table's energy and forces while displacements stay < skin / 2."""
    s = mt.System.from_lattice("fcc", 2, 1.679)
    gnn = mt.SchNet({"n_atom_basis": 32, "n_filters": 32, "n_gaussians": 16,
                     "n_convolutions": 2, "cutoff": 1.3})
    fresh = mt.GNNPotentials(s, gnn, cutoff=1.3, device="cpu")
    skinned = mt.GNNPotentials(s, gnn, cutoff=1.3, skin=0.3, device="cpu")
    xyz0 = torch.tensor(s.get_positions(), dtype=torch.float32)
    rng = np.random.default_rng(9)
    xyz1 = (xyz0 + torch.tensor(rng.normal(0, 0.05, xyz0.shape),
                                dtype=torch.float32)).requires_grad_()
    u_fresh = fresh.energy(xyz1, fresh.aux_init(xyz1))
    u_stale = skinned.energy(xyz1, skinned.aux_init(xyz0))
    # tiny-total energies: tolerance dominated by f32 sum order
    np.testing.assert_allclose(u_stale.item(), u_fresh.item(), rtol=1e-4,
                               atol=1e-6)
    (f_fresh,) = torch.autograd.grad(u_fresh, xyz1)
    (f_stale,) = torch.autograd.grad(u_stale, xyz1)
    torch.testing.assert_close(f_stale, f_fresh, rtol=0,
                               atol=1e-4 * f_fresh.abs().max().item())


def test_skinned_gnn_matches_jax():
    """Skinned GNNPotentials, table from positions 0.1 A away (a stale
    table), energy and forces against JAX: the same k_max at cutoff +
    skin, f32 on both sides (1e-5 and 1e-4 of the largest force, the
    'gather' bounds of tests/test_torch_schnet.py)."""
    sj = _water(SystemJ)
    rng = np.random.default_rng(4)
    x0 = (sj.get_positions()
          + 0.1 * rng.standard_normal((64, 3))).astype(np.float32)
    x1 = (x0 + 0.1 * rng.standard_normal((64, 3))).astype(np.float32)
    inter_j = GNNPotentialsJ(sj, SchNetJ({**WIDTHS, "gather_mode":
                                          "gather"}), cutoff=6.0,
                             capacity_slack=1.25, skin=SKIN)
    p = inter_j.init_params()
    aux_j = inter_j.aux_init(jnp.asarray(x0))
    u_j, g_j = jax.value_and_grad(inter_j.energy, argnums=1)(
        p, jnp.asarray(x1), aux_j)
    inter = mt.GNNPotentials(_water(mt.System), mt.SchNet(WIDTHS),
                             cutoff=6.0, capacity_slack=1.25, skin=SKIN,
                             device="cpu")
    inter.gnn.load_state_dict(schnet_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p)))
    assert inter.k_max == inter_j.k_max
    x = torch.tensor(x1, requires_grad=True)
    u = inter.energy(x, inter.aux_init(torch.tensor(x0)))
    (g,) = torch.autograd.grad(u, x)
    np.testing.assert_allclose(u.item(), float(u_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g.numpy(), g_j,
                               atol=1e-4 * np.abs(g_j).max())


STEPS, FREQUENCY, UPDATE_FREQ = 22, 11, 3     # 2 epochs x 10 steps


@pytest.mark.parametrize("skin", [SKIN, 0.0], ids=["skin", "stale"])
def test_sampling_slice_every_third_step_matches_jax(skin):
    """The 64-site sampling slice with the table refreshed every 3rd step,
    with the skin (exact) and without (a stale table: any other refresh
    schedule than JAX's gives other forces), against JAX: positions after
    20 steps to 1e-5 A and g(r) to 1e-5 of its peak (the bounds of
    tests/test_torch_slice.py; measured ~1e-7 A)."""
    sj = _water(SystemJ)
    stack_j = _stack_j(sj, skin)
    integ_j = NoseHooverChainJ(stack_j, sj, T=298.0, Q=50.0, num_chains=5,
                               topology_update_freq=UPDATE_FREQ)
    sim_j = SimulationJ(sj, integ_j)
    sim_j.simulate(steps=STEPS, dt=0.5 * units_j.fs, frequency=FREQUENCY)
    frames_j = np.stack(sim_j.log["positions"])
    g_j = np.asarray(rdf_j(sj, 109, (1.8, 7.5))(jnp.asarray(frames_j))[2])
    s = _water(mt.System)
    stack = _stack(s, skin, jax.tree_util.tree_map(np.asarray,
                                                   sim_j.params))
    sim = mt.Simulation(s, mt.NoseHooverChain(
        stack, s, T=298.0, Q=50.0, num_chains=5,
        topology_update_freq=UPDATE_FREQ, device="cpu"))
    sim.simulate(steps=STEPS, dt=0.5 * units.fs, frequency=FREQUENCY)
    frames = torch.stack(sim.log["positions"])
    g = mt.observables.rdf(s, 109, (1.8, 7.5), device="cpu")(frames)[2]
    assert not sim.overflowed and not sim.drifted
    np.testing.assert_allclose(frames.numpy(), frames_j, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_j, atol=1e-5 * g_j.max())


TAU = 10                      # 9 steps: refreshes at steps 3 and 6


def test_replay_gradient_with_skin_matches_jax_f64():
    """d(final-state loss)/d(SchNet parameters) through one NHC epoch with
    the skin and the table refreshed every 3rd step: the port's replay
    adjoint against jax.grad through the JAX package's epoch_fn, float64
    on both sides but for what the JAX SchNet keeps in f32 even under x64
    (its f32 parameters, the embedding and each convolution's output):
    the loss to 1e-10, the gradients to 1e-4 of each one's largest entry
    (measured 1.7e-5 at most).  The port refreshes at the steps JAX's
    scan does: the entry prime, then steps 3 and 6 (``i % 3 == 0 and i >
    0``), in the forward; the replay re-uses the stored tables."""
    with jax.enable_x64(True):
        sj = _water(SystemJ)
        stack_j = _stack_j(sj, SKIN)
        integ_j = NoseHooverChainJ(stack_j, sj, T=298.0, Q=50.0,
                                   num_chains=5, adjoint=True,
                                   topology_update_freq=UPDATE_FREQ)
        sim_j = SimulationJ(sj, integ_j)
        ode_j = sim_j.epoch_fn(0.5 * units_j.fs, TAU)
        state_j, aux_j = sim_j.initial_state()
        ctrl_j = integ_j.default_ctrl()

        def loss_j(params):
            traj, _ = ode_j(params, state_j, aux_j, ctrl_j)
            return (traj.q[-1] ** 2).sum() + (traj.v[-1] ** 2).sum()

        value_j, grads_j = jax.value_and_grad(loss_j)(sim_j.params)
        value_j = float(value_j)
        params_np = jax.tree_util.tree_map(np.asarray, sim_j.params)
        grads_j = schnet_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, grads_j["nn"]))
    s = _water(mt.System)
    stack = _stack(s, SKIN, params_np).double()
    gnn = stack.models["nn"]
    refreshes = []
    real_update = gnn.aux_update

    def counted(xyz, aux):
        refreshes.append(xyz.shape)
        return real_update(xyz, aux)

    gnn.aux_update = counted
    integ = mt.NoseHooverChain(stack, s, T=298.0, Q=50.0, num_chains=5,
                               topology_update_freq=UPDATE_FREQ,
                               device="cpu", dtype=torch.float64)
    sim = mt.Simulation(s, integ)
    state, aux = sim.initial_state()
    refreshes.clear()
    traj, _ = sim.epoch_fn(0.5 * units.fs, TAU)(state, aux,
                                                integ.default_ctrl())
    assert len(refreshes) == 3         # the prime, steps 3 and 6
    loss = (traj.q[-1] ** 2).sum() + (traj.v[-1] ** 2).sum()
    params = dict(gnn.gnn.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    assert len(refreshes) == 3         # the replay builds no table
    np.testing.assert_allclose(loss.item(), value_j, rtol=1e-10)
    for (name, p), got in zip(params.items(), grads):
        ref = grads_j[name].double()
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * max(
            ref.abs().max().item(), 1e-30), msg=name)


# tests/test_torch_fit.py's fit: the tiny SchNet over a 32-atom LJ box,
# here with the skin and the table refreshed every 3rd step
ASSIGNMENTS = {
    "cutoff": 2.5, "nbins": 48, "opt_freq": 21, "lr": 1e-3,
    "epsilon": 0.4, "sigma": 0.9, "gaussian_width": 0.25,
    "n_atom_basis": "tiny", "n_filters": "tiny", "n_convolutions": 2,
}
SYS_PARAMS = {
    "size": 2, "dt": 0.005, "n_epochs": 2, "n_sim": 0,
    "data": ["ljtest"], "val": None, "anneal_flag": "False",
    "topology_update_freq": UPDATE_FREQ, "gnn_skin": 0.3, "frame_skip": 5,
    "test_nbins": 64,
}


@pytest.fixture(scope="module")
def lj_registry(tmp_path_factory):
    """tests/test_torch_fit.py's synthetic LJ target, simulated by the JAX
    package (a 32-atom FCC box in reduced units)."""
    tmp = tmp_path_factory.mktemp("targets")
    entry = {"rho": 0.845, "T": 1.2, "start": 0.75, "end": 2.5,
             "element": "H", "mass": 1.0, "N_unitcell": 4, "cell": "fcc",
             "reduced_units": True}
    reg = {"ljtest": entry}
    s = fit_rdf_j.get_system("ljtest", 2, reg, rng=np.random.default_rng(0))
    pair = PairPotentialsJ(s, potentials_j.LennardJones(1.0, 1.0),
                           cutoff=2.5)
    sim = SimulationJ(s, NoseHooverChainJ(pair, s, T=1.2, num_chains=3,
                                          Q=30.0, adjoint=False))
    obs = rdf_j(s, nbins=64, r_range=(0.75, 2.5))
    gs = [np.asarray(obs(sim.simulate(steps=40, dt=0.005,
                                      frequency=40).q[::5])[2])
          for _ in range(4)]
    fn = os.path.join(str(tmp), "rdf_target.csv")
    np.savetxt(fn, np.vstack([obs.r_axis, np.mean(gs, axis=0)]),
               delimiter=",")
    entry["fn"] = fn
    comps = fit_rdf_j.build_fit(ASSIGNMENTS, SYS_PARAMS, reg,
                                rng=np.random.default_rng(5))
    nn = jax.tree_util.tree_map(np.asarray, comps["params"]["nn"])
    pkl = os.path.join(str(tmp), "init.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"params": {"nn": nn}}, f)
    return reg, pkl


def test_fit_rdf_with_skin_matches_jax(lj_registry):
    """Two epochs of fit_rdf with gnn_skin 0.3 and topology_update_freq 3
    from one init_pkl against the JAX driver: the same k_max at cutoff +
    skin, epoch 0's loss to rtol 1e-4 and epoch 1's to 1e-3
    (tests/test_torch_fit.py's bounds: float32 on both sides, epoch 1
    after Adam's sign-like first step)."""
    reg, pkl = lj_registry
    sys_params = dict(SYS_PARAMS, init_pkl=pkl)
    logs_j, logs = [], []
    out_j = fit_rdf_j.fit_rdf(ASSIGNMENTS, sys_params, registry=reg,
                              rng=np.random.default_rng(1),
                              log=logs_j.append)
    comps = {}
    real = fit_rdf.build_fit

    def capture(*a, **kw):
        comps.update(real(*a, **kw))
        return comps

    fit_rdf.build_fit = capture
    try:
        out = fit_rdf.fit_rdf(ASSIGNMENTS, sys_params, registry=reg,
                              rng=np.random.default_rng(1), log=logs.append,
                              device="cpu")
    finally:
        fit_rdf.build_fit = real
    gnn = comps["sims"][0].integrator.model.models["nn"]
    comps_j = fit_rdf_j.build_fit(ASSIGNMENTS, sys_params, reg,
                                  rng=np.random.default_rng(1))
    gnn_j = comps_j["sims"][0].integrator.model.models["nn"]
    assert gnn.skin == gnn_j.skin == 0.3 and gnn.k_max == gnn_j.k_max
    assert comps["sims"][0].integrator.topology_update_freq == UPDATE_FREQ
    assert len(out["loss_log"]) == len(out_j["loss_log"]) == 2
    np.testing.assert_allclose(out["loss_log"][0], out_j["loss_log"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(out["loss_log"][1], out_j["loss_log"][1],
                               rtol=1e-3)
