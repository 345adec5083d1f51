"""The port's fitting driver against the JAX package's
(mdgrad_tpu_torch/train/fit_rdf.py against mdgrad_tpu/train/fit_rdf.py):
``get_system`` and the temperature helpers, the whole registry, the
optimizer's reduce-on-plateau scale and its clipped, scaled Adam step,
``build_fit`` plus the first epoch, and a 2-epoch ``fit_rdf``, both
packages starting from one ``init_pkl``.

The synthetic LJ registry is the one ``tests/test_fit.py`` builds (a
32-atom FCC box in reduced units, its target g(r) simulated by the JAX
package), written once and read by both.
"""

import importlib
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu.data import registry as registry_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.md import rethermalize as rethermalize_j
from mdgrad_tpu.observables import rdf as rdf_j
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch.data import registry
from mdgrad_tpu_torch.md import rethermalize
from mdgrad_tpu_torch.nn.convert import schnet_params_from_numpy
from mdgrad_tpu_torch.train.checkpoint import jax_params
from mdgrad_tpu_torch.train import fit_rdf

# the modules, not the functions the train package exports under their names
fit_rdf_j = importlib.import_module("mdgrad_tpu.train.fit_rdf")

# tests/test_fit.py::test_fit_rdf_gnn_smoke's fit: the tiny SchNet (64/64,
# 10 Gaussians, 2 convolutions) over the LJ box, 20-step epochs
ASSIGNMENTS = {
    "cutoff": 2.5, "nbins": 48, "opt_freq": 21, "lr": 1e-3,
    "epsilon": 0.4, "sigma": 0.9, "gaussian_width": 0.25,
    "n_atom_basis": "tiny", "n_filters": "tiny", "n_convolutions": 2,
}
SYS_PARAMS = {
    "size": 2, "dt": 0.005, "n_epochs": 2, "n_sim": 1,
    "data": ["ljtest"], "val": None, "anneal_flag": "False",
    "topology_update_freq": 1, "frame_skip": 5, "test_nbins": 64,
}



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the fits here are tiny, and the test workers
    share the machine's cores (many threads each would contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lj_registry(tmp_path_factory):
    """A ground-truth LJ target g(r) simulated by the JAX package and
    registered as a reduced-units entry (tests/test_fit.py:21-45)."""
    tmp = tmp_path_factory.mktemp("targets")
    rho, T = 0.845, 1.2
    entry = {"rho": rho, "T": T, "start": 0.75, "end": 2.5,
             "element": "H", "mass": 1.0, "N_unitcell": 4, "cell": "fcc",
             "reduced_units": True}
    reg = {"ljtest": entry}
    s = fit_rdf_j.get_system("ljtest", 2, reg, rng=np.random.default_rng(0))
    pair = PairPotentialsJ(s, potentials_j.LennardJones(1.0, 1.0),
                           cutoff=2.5)
    integ = NoseHooverChainJ(pair, s, T=T, num_chains=3, Q=30.0,
                             adjoint=False)
    sim = SimulationJ(s, integ)
    obs = rdf_j(s, nbins=64, r_range=(0.75, 2.5))
    gs = []
    for _ in range(4):
        traj = sim.simulate(steps=40, dt=0.005, frequency=40)
        gs.append(np.asarray(obs(traj.q[::5])[2]))
    fn = os.path.join(str(tmp), "rdf_target.csv")
    np.savetxt(fn, np.vstack([obs.r_axis, np.mean(gs, axis=0)]),
               delimiter=",")
    entry["fn"] = fn
    return reg


@pytest.fixture(scope="module")
def init_pkl(lj_registry, tmp_path_factory):
    """One pickle of JAX SchNet weights, ``{'params': {'nn': tree}}`` of
    dicts and numpy arrays, that both packages start from."""
    comps = fit_rdf_j.build_fit(ASSIGNMENTS, SYS_PARAMS, lj_registry,
                                rng=np.random.default_rng(5))
    nn = jax.tree_util.tree_map(np.asarray, comps["params"]["nn"])
    path = os.path.join(str(tmp_path_factory.mktemp("init")), "init.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": {"nn": nn}}, f)
    return path


def _first_epoch_j(reg, pkl):
    comps = fit_rdf_j.build_fit(ASSIGNMENTS, SYS_PARAMS, reg,
                                rng=np.random.default_rng(1))
    params = comps["params"]
    with open(pkl, "rb") as f:
        params["nn"] = jax.tree_util.tree_map(
            jnp.asarray, pickle.load(f)["params"]["nn"])
    sim = comps["sims"][0]
    vg, _ = fit_rdf_j._make_epoch_loss(
        sim, comps["observers"][0], comps["targets"][0], comps["systems"][0],
        ASSIGNMENTS["opt_freq"], SYS_PARAMS["dt"], SYS_PARAMS["frame_skip"])
    state, aux = sim.initial_state()
    (loss, _), grads = vg(params, state, aux, sim.integrator.default_ctrl())
    return float(loss), jax.tree_util.tree_map(np.asarray, grads["nn"])


def _first_epoch(reg, pkl):
    comps = fit_rdf.build_fit(ASSIGNMENTS, SYS_PARAMS, reg,
                              rng=np.random.default_rng(1), device="cpu")
    net = comps["net"]
    net.load_state_dict(schnet_params_from_numpy(
        jax_params(pkl, "nn")))
    sim = comps["sims"][0]
    loss_fn = fit_rdf.make_epoch_loss(
        sim, comps["observers"][0], comps["targets"][0], comps["systems"][0],
        ASSIGNMENTS["opt_freq"], SYS_PARAMS["dt"], SYS_PARAMS["frame_skip"])
    loss, _ = loss_fn(*sim.initial_state(), sim.integrator.default_ctrl())
    grads = {name: torch.zeros_like(p) if p.grad is None else p.grad
             for name, p in net.named_parameters()}
    return loss.item(), grads, comps


def test_get_system_and_temperatures_match_jax(lj_registry):
    """Positions, velocities, masses and cells from one seed, bit for bit,
    for reduced-units (the LJ box) and physical-units entries (water,
    a-Si, argon); the annealing schedule and the Kelvin conversion."""
    cases = [("ljtest", 2, lj_registry), ("H20_298K_redd", 2, None),
             ("Si_2.293_100K", 1, None), ("Argon_1.417_298k", 2, None)]
    for tag, size, reg in cases:
        s = fit_rdf.get_system(tag, size, reg, rng=np.random.default_rng(3))
        sj = fit_rdf_j.get_system(tag, size, reg,
                                  rng=np.random.default_rng(3))
        np.testing.assert_array_equal(s.get_positions(),
                                      np.asarray(sj.get_positions()))
        np.testing.assert_array_equal(s.get_velocities(),
                                      np.asarray(sj.get_velocities()))
        np.testing.assert_array_equal(s.get_masses(),
                                      np.asarray(sj.get_masses()))
        np.testing.assert_array_equal(s.get_cell(), np.asarray(sj.get_cell()))
        np.testing.assert_array_equal(s.get_atomic_numbers(),
                                      np.asarray(sj.get_atomic_numbers()))
        entry = (reg or registry.exp_rdf_data_dict)[tag]
        assert fit_rdf.registry_T_kelvin(entry) == \
            fit_rdf_j.registry_T_kelvin(entry)
    for i in range(0, 700, 37):
        assert fit_rdf.get_temp(500.0, 298.0, 700, i, 2.0) == \
            fit_rdf_j.get_temp(500.0, 298.0, 700, i, 2.0)
    assert registry.number_density_unit_len(0.845, 4) == \
        registry_j.number_density_unit_len(0.845, 4)


def test_rethermalize_and_update_T_match_jax(lj_registry):
    """rethermalize draws the JAX package's velocities from the same rng,
    zeroes the bath momenta and marks the force cache stale; update_T
    sets T and returns the new ctrl."""
    s = fit_rdf.get_system("ljtest", 2, lj_registry,
                           rng=np.random.default_rng(0))
    pair = mt.PairPotentials(s, mt.potentials.LennardJones(1.0, 1.0),
                             cutoff=2.5, device="cpu")
    integ = mt.NoseHooverChain(pair, s, T=300.0, num_chains=3, Q=30.0,
                               device="cpu")
    state, aux = integ.prime_state(integ.initial_state(), ())
    state = state._replace(pv=torch.ones(3))
    assert state.fv
    sj = fit_rdf_j.get_system("ljtest", 2, lj_registry,
                              rng=np.random.default_rng(0))
    integ_j = NoseHooverChainJ(PairPotentialsJ(
        sj, potentials_j.LennardJones(1.0, 1.0), cutoff=2.5), sj, T=300.0,
        num_chains=3, Q=30.0)
    state_j = integ_j.initial_state()
    kT = 1.2
    new = rethermalize(state, kT, s.get_masses(),
                       rng=np.random.default_rng(4), dim=3)
    new_j = rethermalize_j(state_j, kT, sj.get_masses(),
                           rng=np.random.default_rng(4), dim=3)
    assert new.v.dtype == torch.float32
    np.testing.assert_array_equal(new.v.numpy(), np.asarray(new_j.v))
    assert torch.equal(new.q, state.q) and not new.pv.any()
    assert new.fv is False
    ctrl = integ.update_T(150.0)
    assert integ.T == 150.0
    np.testing.assert_allclose(ctrl["kT"].item(),
                               float(integ_j.update_T(150.0)["kT"]),
                               rtol=1e-7)


def test_registry_entries_and_targets_match_jax():
    """Every entry of exp_rdf_data_dict (a-Si, water, argon) and of the
    scanned pair_data_dict equals the JAX registry's, the same files read
    in place, and every target on a 109-bin grid agrees to 1e-8 relative
    (the JAX package's float32 shell volumes against the port's float64
    ones; test_torch_train.py measures 3.4e-9).  The argon file is
    whitespace-delimited: the port reads it, the JAX package's
    get_observer (comma-delimited) raises.  The Morse and LJ-family files
    hold 60 values of g and no r, which get_exp_rdf cannot read in either
    package; they are read and counted."""
    assert len(registry.pair_data_dict) > 0
    n_g_only = 0
    for mine, ref in ((registry.exp_rdf_data_dict,
                       registry_j.exp_rdf_data_dict),
                      (registry.pair_data_dict, registry_j.pair_data_dict)):
        assert list(mine.keys()) == list(ref.keys())
        for tag, entry in mine.items():
            assert entry.keys() == ref[tag].keys(), tag
            for key, value in entry.items():
                if key.endswith("fn") and value is not None:
                    assert os.path.realpath(value) == \
                        os.path.realpath(ref[tag][key]), (tag, key)
                else:
                    assert value == ref[tag][key], (tag, key)
            data = registry.load_target(entry.get("fn") or entry["rdf_fn"])
            if data.ndim == 1:
                # g alone, no r column (the Morse and LJ-family files):
                # neither package's get_exp_rdf reads these
                assert data.shape == (60,), tag
                n_g_only += 1
                continue
            r_range = (entry["start"], entry["end"])
            x, g = registry.get_exp_rdf(data, 109, r_range)
            xj, gj = registry_j.get_exp_rdf(data, 109, r_range)
            np.testing.assert_array_equal(x, xj)
            np.testing.assert_allclose(g, gj, rtol=1e-8, err_msg=tag)
    assert n_g_only == 61
    argon = registry.exp_rdf_data_dict["Argon_1.417_298k"]["fn"]
    np.testing.assert_array_equal(registry.load_target(argon),
                                  np.loadtxt(argon))
    with pytest.raises(ValueError):
        np.loadtxt(argon, delimiter=",")


def _plateau_values():
    """Improvements, a plateau that halves the scale, improvements smaller
    than rtol (no improvement), one exactly at the threshold, and a long
    plateau that takes the scale to its floor."""
    vals = [10.0 - 0.5 * i for i in range(10)]
    vals += [5.5] * 30
    best = np.float32(5.5)
    vals += [float(best * np.float32(1 - 0.5e-4))] * 5
    edge = np.float32(np.float32(1 - 1e-4) * best - np.float32(1e-5))
    vals += [float(edge), float(np.nextafter(edge, np.float32(0)))]
    vals += [4.0, 3.0, float("nan"), 2.9]
    vals += [2.9] * 400
    return vals


def test_plateau_scale_matches_optax():
    """ReduceOnPlateau gives optax.contrib.reduce_on_plateau(factor=0.5,
    patience=25, min_scale=1e-4, atol=1e-5)'s scale at every step, bit
    for bit (both in float32), down to the floor."""
    rop = optax.contrib.reduce_on_plateau(factor=0.5, patience=25,
                                          min_scale=1e-4, atol=1e-5)
    params = {"w": jnp.zeros(3)}
    state = rop.init(params)

    @jax.jit
    def step(state, value):
        _, state = rop.update(params, state, params, value=value)
        return state.scale, state

    plateau = fit_rdf.ReduceOnPlateau(factor=0.5, patience=25,
                                      min_scale=1e-4, atol=1e-5)
    scales = []
    for value in _plateau_values():
        ref, state = step(state, jnp.asarray(value))
        got = plateau.update(value)
        assert got == float(ref), (len(scales), value, got, float(ref))
        scales.append(got)
    assert scales[0] == 1.0 and 0.5 in scales
    assert scales[-1] == float(np.float32(1e-4))
    # a snapshot restores the same sequence
    saved = plateau.state_dict()
    again = fit_rdf.ReduceOnPlateau(factor=0.5, patience=25,
                                    min_scale=1e-4, atol=1e-5)
    again.load_state_dict(saved)
    assert again.update(2.9) == plateau.update(2.9)


def test_fit_update_matches_optax_chain():
    """FitUpdate with a plateau against the JAX fit's optimizer:
    clip_by_global_norm(10) -> adam(lr) -> reduce_on_plateau, the update
    times step_scale.  Patience 2 so that the scale moves within 9 steps;
    the step scales are those of a NaN recovery (0.5, 0.25) and its
    regrowth.  Float32 formulas in another order: ~1 ulp of |p| < 4."""
    rng = np.random.default_rng(11)
    shapes = [(5, 3), (3,), (4, 4, 2)]
    p0 = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    grads = [[(rng.normal(size=sh) * s).astype(np.float32) for sh in shapes]
             for s in (0.5, 8.0, 2.0, 1.0, 0.1, 3.0, 1.0, 1.0, 0.3)]
    values = [3.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 0.5]
    step_scales = [1.0, 0.5, 0.63, 0.25, 0.315, 1.0, 1.0, 0.5, 1.0]
    lr = 1e-3
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(lr),
                      optax.contrib.reduce_on_plateau(
                          factor=0.5, patience=2, min_scale=1e-4, atol=1e-5))
    params_j = [jnp.asarray(x) for x in p0]
    state = opt.init(params_j)
    for g, v, sc in zip(grads, values, step_scales):
        upd, state = opt.update([jnp.asarray(x) for x in g], state,
                                params_j, value=jnp.asarray(v))
        upd = jax.tree_util.tree_map(lambda u: u * jnp.asarray(sc), upd)
        params_j = optax.apply_updates(params_j, upd)

    params = [torch.nn.Parameter(torch.tensor(x)) for x in p0]
    update = fit_rdf.FitUpdate(params, lr, 10.0, fit_rdf.ReduceOnPlateau(
        factor=0.5, patience=2, min_scale=1e-4, atol=1e-5))
    for g, v, sc in zip(grads, values, step_scales):
        for p, x in zip(params, g):
            p.grad = torch.tensor(x)
        update(v, sc)
    assert update.plateau.scale < 1.0
    for p, ref in zip(params, params_j):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=5e-7)


def test_first_epoch_matches_jax(lj_registry, init_pkl):
    """build_fit plus the first epoch of both packages from one init_pkl:
    the epoch loss to rtol 1e-4 and the SchNet gradient to 2e-3 of its
    largest entry (tests/test_torch_train.py's bounds: float32 on both
    sides, each summing in its own order; measured 2.4e-5 and 2.5e-5),
    and the same initial state."""
    loss_j, grads_j = _first_epoch_j(lj_registry, init_pkl)
    loss, grads, comps = _first_epoch(lj_registry, init_pkl)
    comps_j = fit_rdf_j.build_fit(ASSIGNMENTS, SYS_PARAMS, lj_registry,
                                  rng=np.random.default_rng(1))
    np.testing.assert_array_equal(
        comps["systems"][0].get_velocities(),
        np.asarray(comps_j["systems"][0].get_velocities()))
    assert comps["net"].convs[0].offsets.shape == (10,)   # 2.5 // 0.25
    assert comps["sims"][0].integrator.model.models["nn"].k_max == \
        comps_j["sims"][0].integrator.model.models["nn"].k_max
    np.testing.assert_allclose(loss, loss_j, rtol=1e-4)
    ref = schnet_params_from_numpy(grads_j)
    assert grads.keys() == ref.keys()
    flat_ref = np.concatenate([ref[k].numpy().ravel() for k in sorted(ref)])
    flat = np.concatenate([grads[k].numpy().ravel() for k in sorted(ref)])
    scale = np.abs(flat_ref).max()
    assert scale > 0 and np.isfinite(flat).all()
    np.testing.assert_allclose(flat, flat_ref, atol=2e-3 * scale, rtol=0)


@pytest.fixture(scope="module")
def fits(lj_registry, init_pkl):
    """A 2-epoch fit_rdf of each package from init_pkl, the same seed."""
    sys_params = dict(SYS_PARAMS, init_pkl=init_pkl)
    logs_j, logs = [], []
    out_j = fit_rdf_j.fit_rdf(ASSIGNMENTS, sys_params, registry=lj_registry,
                              rng=np.random.default_rng(1),
                              log=logs_j.append)
    out = fit_rdf.fit_rdf(ASSIGNMENTS, sys_params, registry=lj_registry,
                          rng=np.random.default_rng(1), log=logs.append,
                          device="cpu")
    return out_j, out, logs_j, logs


def test_fit_rdf_matches_jax(fits):
    """Two epochs of fit_rdf and the inference objective against the JAX
    package's from one init_pkl.  Epoch 0 runs from equal weights and
    states: its loss to rtol 1e-4.  Epoch 1 follows Adam's first step,
    which is sign-like (lr / (|g| / |g| + eps)): a gradient entry below
    the float32 error moves its weight by +-lr either way, so epoch 1's
    loss and the objective (64-bin MSE after 100 more steps) agree less
    closely.  Measured on the CPU: loss_log[0] 2.4e-5, loss_log[1]
    7.5e-6, the objective 6.6e-7 and js_log 3.8e-6 relative; epoch 1,
    the objective and js_log are held to 1e-3."""
    out_j, out, logs_j, logs = fits
    assert any("warm start" in str(m) for m in logs)
    assert len(out["loss_log"]) == len(out_j["loss_log"]) == 2
    np.testing.assert_allclose(out["loss_log"][0], out_j["loss_log"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(out["loss_log"][1], out_j["loss_log"][1],
                               rtol=1e-3)
    np.testing.assert_allclose(out["objective"], out_j["objective"],
                               rtol=1e-3)
    np.testing.assert_allclose(out["js_log"], out_j["js_log"], rtol=1e-3)
    fin, fin_j = out["final"]["ljtest"], out_j["final"]["ljtest"]
    assert fin["g_sim"].shape == (64,) and fin["g_sim"].dtype == np.float32
    np.testing.assert_array_equal(fin["r"], fin_j["r"])
    np.testing.assert_allclose(fin["g_obs"], fin_j["g_obs"], rtol=1e-6)
