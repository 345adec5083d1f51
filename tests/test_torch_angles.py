"""The port's angle and dihedral observables and the fit's angle target
against the JAX package: ``topology.neighbors_per_atom`` /
``angle_triples`` / ``wrap_bond_vectors``, ``observables.compute_angle``,
``angle_distribution``, ``Angles``, ``compute_dihe``,
``signed_dihedrals``, ``chain_quads`` and ``dihedral_distribution``
(tests/test_observables.py:69-131 mirrored), the angle targets of
``data/registry.py``, the water fit's epoch loss with the angle term
against ``_make_epoch_loss(angle_extra=...)``, and ``fit_rdf`` with
``angle_flag`` (tests/test_fit.py:331 mirrored).

Frames: 64 water O sites on the diamond lattice displaced by 0.3 A from a
numpy seed (angle cutoff 3.7, K = 24).  Single evaluations compare in
float32 (counts to 1e-5 of the largest bin; angles to 1e-5); position
gradients in float64, the JAX side inside ``jax.enable_x64(True)``.  The
neighbor tables of the two packages may order equal distances their own
way, so angles compare as sorted sets.
"""

import importlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import observables as obs_j
from mdgrad_tpu import topology as topology_j
from mdgrad_tpu.data import registry as registry_j
from mdgrad_tpu.interface import GNNPotentials as GNNPotentialsJ
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.interface import Stack as StackJ
from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import observables, topology, units
from mdgrad_tpu_torch.data import registry
from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy
from mdgrad_tpu_torch.train import fit_rdf

fit_rdf_j = importlib.import_module("mdgrad_tpu.train.fit_rdf")
L_WATER = registry.get_unit_len(0.99749, 18.01528, 8)
A_CUT, A_NBINS, A_RANGE, K = 3.7, 64, (0.5, np.pi), 24


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


def _frames(n_frames=3, seed=5):
    s = _water(SystemJ)
    rng = np.random.default_rng(seed)
    return (s.get_positions()[None]
            + 0.3 * rng.standard_normal((n_frames, 64, 3)))


def test_neighbors_per_atom_and_triples_match_jax():
    """The per-atom table holds JAX's neighbor set in every row, with the
    same validity and the same largest count; the (j, i, k) triples give
    JAX's multiset of apex angles."""
    xyz = _frames(1)[0].astype(np.float32)
    cell = np.diag(_water(SystemJ).get_cell())
    tab_j, valid_j, count_j = topology_j.neighbors_per_atom(
        jnp.asarray(xyz), A_CUT, jnp.asarray(np.diag(cell)), K)
    tab, valid, count = topology.neighbors_per_atom(
        torch.tensor(xyz), A_CUT, torch.tensor(cell, dtype=torch.float32), K)
    assert int(count) == int(count_j)
    np.testing.assert_array_equal(np.sort(tab.numpy(), 1),
                                  np.sort(np.asarray(tab_j), 1))
    np.testing.assert_array_equal(valid.numpy().sum(1),
                                  np.asarray(valid_j).sum(1))
    tri, mask = topology.angle_triples(tab, valid)
    tri_j, mask_j = topology_j.angle_triples(tab_j, valid_j)
    assert tri.shape == tuple(tri_j.shape) and int(mask.sum()) == int(
        mask_j.sum())
    got = {tuple(t) for t in tri.numpy()[mask.numpy()].tolist()}
    ref = {tuple(t) for t in np.asarray(tri_j)[np.asarray(mask_j)].tolist()}
    assert got == ref
    vec = torch.tensor([[0.6, -0.4, 0.1], [-0.55, 0.2, 0.5]]) * 10
    np.testing.assert_array_equal(
        topology.wrap_bond_vectors(vec, torch.tensor([10.0, 10.0, 10.0])),
        np.asarray(topology_j.wrap_bond_vectors(jnp.asarray(vec.numpy()),
                                                jnp.asarray([10.0] * 3))))


def test_angle_distribution_tetrahedral():
    """A perfect tetrahedron around a centre atom: its 6 angles at 109.47
    degrees and the histogram's peak there (tests/test_observables.py)."""
    c = np.array([[0.0, 0, 0]])
    t = 1.0 / np.sqrt(3)
    verts = np.array([[t, t, t], [t, -t, -t], [-t, t, -t], [-t, -t, t]])
    xyz = np.concatenate([c, verts]) + 5.0
    s = mt.System(xyz, np.diag([10.0] * 3))
    obs = observables.angle_distribution(s, nbins=64, angle_range=A_RANGE,
                                         cutoff=1.5, k_max=4, device="cpu")
    bins, count, (angles, mask, overflow) = obs(torch.tensor(
        xyz, dtype=torch.float32))
    assert not bool(overflow)
    got = angles.numpy()[mask.numpy()]
    tet = np.full(6, np.arccos(-1 / 3))
    assert (np.abs(np.sort(got)[-6:] - tet) < 1e-2).all()
    assert abs(float(bins[int(count.argmax())]) - np.arccos(-1 / 3)) < 0.15


def test_angle_distribution_matches_jax():
    """Counts, bins, the sorted masked angles and the overflow flag over
    three frames equal JAX's (float32); at K = 4 both flag overflow;
    ``Angles`` gives the cosines of the same set."""
    frames = _frames().astype(np.float32)
    sj, s = _water(SystemJ), _water(mt.System)
    a_j = obs_j.angle_distribution(sj, A_NBINS, A_RANGE, cutoff=A_CUT,
                                   k_max=K)
    a = observables.angle_distribution(s, A_NBINS, A_RANGE, cutoff=A_CUT,
                                       k_max=K, device="cpu")
    bins_j, count_j, (ang_j, mask_j, ov_j) = a_j(jnp.asarray(frames))
    bins, count, (ang, mask, ov) = a(torch.tensor(frames))
    np.testing.assert_allclose(bins.numpy(), np.asarray(bins_j), rtol=1e-6)
    np.testing.assert_allclose(count.numpy(), np.asarray(count_j),
                               atol=1e-5 * float(np.max(count_j)))
    assert bool(ov) == bool(ov_j) is False
    np.testing.assert_allclose(np.sort(ang.numpy()[mask.numpy()]),
                               np.sort(np.asarray(ang_j)[np.asarray(mask_j)]),
                               atol=1e-5)
    cos, m = observables.Angles(s, cutoff=A_CUT, k_max=K, device="cpu")(
        torch.tensor(frames))
    cos_j, m_j = obs_j.Angles(sj, cutoff=A_CUT, k_max=K)(jnp.asarray(frames))
    np.testing.assert_allclose(np.sort(cos.numpy()[m.numpy()]),
                               np.sort(np.asarray(cos_j)[np.asarray(m_j)]),
                               atol=1e-5)
    small = observables.angle_distribution(s, A_NBINS, A_RANGE, cutoff=A_CUT,
                                           k_max=4, device="cpu")
    small_j = obs_j.angle_distribution(sj, A_NBINS, A_RANGE, cutoff=A_CUT,
                                       k_max=4)
    assert bool(small(torch.tensor(frames))[2][2])
    assert bool(small_j(jnp.asarray(frames))[2][2])


def test_angle_and_dihedral_position_gradients_match_jax():
    """d/dxyz of a weighted sum of the angle histogram and of the
    dihedral histogram (chain quads of the same frames) against
    ``jax.grad``, float64."""
    frames = _frames(2)
    w = np.random.default_rng(1).standard_normal(A_NBINS)
    with jax.enable_x64(True):
        a_j = obs_j.angle_distribution(_water(SystemJ), A_NBINS, A_RANGE,
                                       cutoff=A_CUT, k_max=K)
        d_j = obs_j.dihedral_distribution(64, nbins=A_NBINS)
        g_a_j = np.asarray(jax.grad(lambda x: (a_j(x)[1] * w).sum())(
            jnp.asarray(frames)))
        g_d_j = np.asarray(jax.grad(lambda x: (d_j(x)[1] * w).sum())(
            jnp.asarray(frames)))
    a = observables.angle_distribution(_water(mt.System), A_NBINS, A_RANGE,
                                       cutoff=A_CUT, k_max=K, device="cpu")
    d = observables.dihedral_distribution(64, nbins=A_NBINS, device="cpu")
    wt = torch.tensor(w)
    for fn, ref in ((a, g_a_j), (d, g_d_j)):
        x = torch.tensor(frames, requires_grad=True)
        (g,) = torch.autograd.grad((fn(x)[1] * wt).sum(), x)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-9 * np.abs(ref).max())


def test_compute_angle_and_dihedrals_match_jax():
    """``compute_angle`` (linear: -1), ``compute_dihe`` (planar cis:
    |cos| = 1), ``signed_dihedrals``, ``chain_quads`` and
    ``dihedral_distribution`` against JAX on random frames (float32)."""
    cos = observables.compute_angle(
        torch.tensor([[[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0]]]),
        torch.tensor([[0, 0, 1, 2]]), np.diag([20.0] * 3), N=3)
    np.testing.assert_allclose(float(cos[0]), -1.0, atol=1e-6)
    planar = torch.tensor([[[0.0, 1, 0], [0, 0, 0], [1, 0, 0], [1, 1, 0]]])
    assert abs(abs(float(observables.compute_dihe(
        planar, torch.tensor([[0, 1, 2, 3]]))[0, 0])) - 1.0) < 1e-5
    rng = np.random.default_rng(5)
    xyz = rng.standard_normal((3, 12, 3)).astype(np.float32)
    quads = observables.chain_quads(12)
    np.testing.assert_array_equal(quads, obs_j.chain_quads(12))
    angle_list = np.array([[0, 1, 2, 3], [1, 4, 5, 6], [2, 7, 8, 11]])
    cell = np.diag([3.0] * 3)
    np.testing.assert_allclose(
        observables.compute_angle(torch.tensor(xyz), torch.tensor(
            angle_list), cell, 12).numpy(),
        np.asarray(obs_j.compute_angle(jnp.asarray(xyz), jnp.asarray(
            angle_list), cell, 12)), atol=1e-6)
    np.testing.assert_allclose(
        observables.compute_dihe(torch.tensor(xyz), torch.tensor(quads)),
        np.asarray(obs_j.compute_dihe(jnp.asarray(xyz), jnp.asarray(quads))),
        atol=1e-6)
    np.testing.assert_allclose(
        observables.signed_dihedrals(torch.tensor(xyz), quads),
        np.asarray(obs_j.signed_dihedrals(jnp.asarray(xyz),
                                          jnp.asarray(quads))), atol=1e-5)
    bins, counts, phi = observables.dihedral_distribution(
        12, nbins=32, device="cpu")(torch.tensor(xyz))
    bins_j, counts_j, phi_j = obs_j.dihedral_distribution(12, nbins=32)(
        jnp.asarray(xyz))
    np.testing.assert_allclose(bins.numpy(), np.asarray(bins_j), rtol=1e-6)
    np.testing.assert_allclose(counts.numpy(), np.asarray(counts_j),
                               atol=1e-6)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_j), atol=1e-5)


def test_angle_targets_match_jax():
    """``exp_angle_data`` on every water angle file equals JAX's; the
    registry points at the same files, read in place."""
    for cut in (2.7, 3.7):
        fn = registry.angle_data_dict["water"][cut]
        assert os.path.realpath(fn) == os.path.realpath(
            registry_j.angle_data_dict["water"][cut])
        np.testing.assert_allclose(
            registry.exp_angle_data(A_NBINS, A_RANGE, fn),
            registry_j.exp_angle_data(A_NBINS, A_RANGE, fn), rtol=1e-12)
    np.testing.assert_allclose(registry.exp_angle_data(32, (0.6, 3.0)),
                               registry_j.exp_angle_data(32, (0.6, 3.0)),
                               rtol=1e-12)


WIDTHS = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 2, "cutoff": 6.0}
TAG, NBINS, TAU, FRAME_SKIP = "H20_0.997_298K", 109, 11, 5


def test_epoch_loss_with_angle_term_matches_jax():
    """The water fit's epoch loss with the angle term (64 sites, SchNet
    16/16/8, 10 steps, frames 0, 5, 10; the 3.7 A target, weight 1) and
    its SchNet gradient against JAX's ``_make_epoch_loss(angle_extra=...)``
    through the replay adjoint, float32, ``gather_mode='gather'``: loss to
    rtol 1e-5, gradients to 1e-4 of their largest entry."""
    s_j = _water(SystemJ)
    stack_j = StackJ({
        "nn": GNNPotentialsJ(s_j, SchNetJ({**WIDTHS, "gather_mode":
                                           "gather"}), cutoff=6.0,
                             capacity_slack=1.25),
        "prior": PairPotentialsJ(s_j, potentials_j.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense")})
    integ_j = NoseHooverChainJ(stack_j, s_j, T=298.0, Q=50.0, num_chains=5,
                               adjoint=True)
    sim_j = SimulationJ(s_j, integ_j)
    _, g_target_j, rdf_obs_j = fit_rdf_j.get_observer(s_j, TAG, NBINS)
    a_target = registry_j.exp_angle_data(
        A_NBINS, A_RANGE, registry_j.angle_data_dict["water"][A_CUT])
    aobs_j = obs_j.angle_distribution(s_j, A_NBINS, A_RANGE, cutoff=A_CUT,
                                      k_max=K)
    vg, _ = fit_rdf_j._make_epoch_loss(
        sim_j, rdf_obs_j, g_target_j, s_j, TAU, 0.5 * units.fs, FRAME_SKIP,
        angle_extra=(aobs_j, jnp.asarray(a_target, jnp.float32), 1.0))
    state_j, aux_j = sim_j.initial_state()
    (loss_j, _), grads_j = vg(sim_j.params, state_j, aux_j,
                              integ_j.default_ctrl())
    params_j = jax.tree_util.tree_map(np.asarray, sim_j.params)

    s = _water(mt.System)
    stack = mt.Stack({
        "nn": mt.GNNPotentials(s, mt.SchNet(WIDTHS), cutoff=6.0,
                               capacity_slack=1.25, device="cpu"),
        "prior": mt.PairPotentials(s, mt.potentials.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense",
            device="cpu")})
    stack.load_state_dict(stack_params_from_numpy(params_j, stack))
    fit_rdf.fit_parameters(stack)
    integ = mt.NoseHooverChain(stack, s, T=298.0, Q=50.0, num_chains=5,
                               device="cpu")
    sim = mt.Simulation(s, integ)
    _, g_target, rdf_obs = fit_rdf.get_observer(s, TAG, NBINS, device="cpu")
    extra = fit_rdf._angle_extras({"angle_cutoff": A_CUT}, {
        "angle_flag": True}, [s], g_target, "cpu")[0]
    loss_fn = fit_rdf.make_epoch_loss(sim, rdf_obs, g_target, s, TAU,
                                      0.5 * units.fs, FRAME_SKIP,
                                      angle_extra=extra)
    state, aux = sim.initial_state()
    loss, _ = loss_fn(state, aux, integ.default_ctrl())
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    ref = stack_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         grads_j), stack)
    named = dict(stack.named_parameters())
    for name, p in named.items():
        if not p.requires_grad:
            continue
        want = ref[name].numpy()
        got = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    # the angle term is in the loss: it changes the value
    loss_no, _ = fit_rdf.make_epoch_loss(sim, rdf_obs, g_target, s, TAU,
                                         0.5 * units.fs, FRAME_SKIP,
                                         backward=False)(
        state, aux, integ.default_ctrl())
    assert loss.item() - loss_no.item() > 1e-6


def test_fit_rdf_with_angle_target(tmp_path):
    """tests/test_fit.py:331 on the port: a pair-MLP fit of a 32-atom LJ
    box with an angle target made by the same observable on the lattice,
    2 epochs; the inference reports a finite ``angle_mse`` over 24 bins."""
    reg = {"ljtest": {"rho": 0.845, "T": 1.2, "start": 0.75, "end": 2.5,
                      "element": "H", "mass": 1.0, "N_unitcell": 4,
                      "cell": "fcc", "reduced_units": True}}
    r = np.linspace(0.75, 2.5, 48)
    np.savetxt(tmp_path / "rdf.csv", np.vstack(
        [r, 1.0 + 0.5 * np.exp(-(r - 1.1) ** 2 / 0.02)]), delimiter=",")
    reg["ljtest"]["fn"] = str(tmp_path / "rdf.csv")
    sys0 = fit_rdf.get_system("ljtest", 2, reg, rng=np.random.default_rng(0))
    a_nbins, a_cut = 24, 1.5
    aobs = observables.angle_distribution(sys0, a_nbins, A_RANGE,
                                          cutoff=a_cut, k_max=24,
                                          device="cpu")
    _, count, _ = aobs(torch.tensor(sys0.get_positions(),
                                    dtype=torch.float32))
    deg = np.linspace(A_RANGE[0], A_RANGE[1], a_nbins) * 180 / np.pi
    fn = str(tmp_path / "angle_target.csv")
    np.savetxt(fn, np.vstack([deg, count.numpy() + 1e-4]).T, delimiter=",")
    assignments = {
        "cutoff": 2.5, "nbins": 48, "opt_freq": 15, "lr": 3e-3,
        "epsilon": 0.4, "sigma": 0.9, "power": 12,
        "gaussian_width": 0.1, "n_width": 24, "n_layers": 1,
        "nonlinear": "SELU", "angle_weight": 1.0, "angle_cutoff": a_cut,
        "angle_nbins": a_nbins, "angle_start": 0.5}
    sys_params = {
        "size": 2, "dt": 0.005, "n_epochs": 2, "n_sim": 1,
        "data": ["ljtest"], "val": None, "pair_flag": True,
        "anneal_flag": "False", "frame_skip": 5, "test_nbins": 48,
        "pretrain_iters": 20, "angle_flag": True, "angle_fn": fn,
        "angle_k_max": 24}
    out = fit_rdf.fit_rdf(assignments, sys_params, registry=reg,
                          rng=np.random.default_rng(1), log=lambda *a: None,
                          device="cpu")
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 2 and np.isfinite(out["loss_log"]).all()
    fin = out["final"]["ljtest"]
    assert "angle_mse" in fin and np.isfinite(fin["angle_mse"])
    assert fin["angle_sim"].shape == (a_nbins,)
    assert fin["angle_obs"].shape == (a_nbins,)
