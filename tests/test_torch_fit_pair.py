"""The port's pair fitting against the JAX package's: Boltzmann-inversion
targets and pretraining (mdgrad_tpu_torch/train/pretrain.py), ``fit_lj``
(train/fit_rdf_pair.py) and ``fit_rdf``'s pair-MLP and T-dependent
pair-MLP branches (train/fit_rdf.py), plus the JAX suite's pair-fit tests
(tests/test_fit.py) run on the port and ``scripts/run_lj_torch.py
--dry_run``.

The LJ targets are files written once from a JAX simulation (a 108-atom
FCC box at rho 0.845, T 1.2, reduced units), with a VACF and a pressure
target, so that both packages read the same targets.  Gradients and
first-epoch losses are compared in float64 on both sides
(``jax.enable_x64``), each test stating its bound; the 2-epoch fits in
float32.
"""

import importlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdgrad_tpu as mj
from mdgrad_tpu import thermo as thermo_j
from mdgrad_tpu.train import pretrain as pretrain_j
from mdgrad_tpu_torch import units
from mdgrad_tpu_torch.interface import PairPotentials
from mdgrad_tpu_torch.nn import PairMLP, TPairMLP
from mdgrad_tpu_torch.nn.convert import pair_mlp_params_from_numpy
from mdgrad_tpu_torch.potentials import ExcludedVolume
from mdgrad_tpu_torch.train import fit_rdf, fit_rdf_pair, pretrain

# the modules, not the functions the train package exports under their names
fit_rdf_j = importlib.import_module("mdgrad_tpu.train.fit_rdf")
fit_rdf_pair_j = importlib.import_module("mdgrad_tpu.train.fit_rdf_pair")

REPO = Path(__file__).resolve().parents[1]
ENTRY = {"rho": 0.845, "T": 1.2, "start": 0.75, "end": 2.5, "element": "H",
         "mass": 1.0, "N_unitcell": 4, "cell": "fcc", "reduced_units": True,
         "dt": 0.01, "target_pot": ("LennardJones", {})}
# fit_lj at tests/test_fit.py's small settings on the 108-atom box, every
# loss term on
LJ_ASSIGNMENTS = {"nbins": 40, "opt_freq": 16, "lr": 3e-3, "sigma": 0.9,
                  "gaussian_width": 0.1, "n_width": 24, "n_layers": 1,
                  "nonlinear": "SELU", "rdf_weight": 1.0, "vacf_weight": 0.1,
                  "train_vacf": "True", "pressure_weight": 1e-3,
                  "pressure_frame_skip": 5}
LJ_SYS = {"size": 3, "cutoff": 2.5, "t_range": 10, "n_epochs": 2,
          "n_sim": 1, "data": ["ljf"], "val": None, "target_nsim": 4,
          "frame_skip": 4}
# fit_rdf's pair branch at tests/test_fit.py::test_fit_rdf_pair_smoke's
# settings
RDF_ASSIGNMENTS = {"cutoff": 2.5, "nbins": 48, "opt_freq": 21, "lr": 3e-3,
                   "epsilon": 0.4, "sigma": 0.9, "power": 12,
                   "gaussian_width": 0.1, "n_width": 32, "n_layers": 1,
                   "nonlinear": "SELU"}
RDF_SYS = {"size": 2, "dt": 0.005, "n_epochs": 3, "n_sim": 1,
           "data": ["ljf"], "val": None, "pair_flag": True,
           "anneal_flag": "False", "topology_update_freq": 1,
           "pretrain_iters": 30, "frame_skip": 5, "test_nbins": 64}
N_GAUSS = int(2.5 // 0.1)      # the nets' Gaussians: cutoff // width, 24


def _quiet(*a):
    pass


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the fits are tiny and the test workers share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """The 'ljf' entry: g(r), VACF and pressure targets of ground-truth LJ
    simulated by the JAX package, written to files that both read."""
    tmp = tmp_path_factory.mktemp("pair_targets")
    s = fit_rdf_j.get_system("ljf", 3, {"ljf": ENTRY},
                             rng=np.random.default_rng(0))
    pair = mj.PairPotentials(s, mj.potentials.LennardJones(), cutoff=2.5)
    sim = mj.Simulation(s, mj.NoseHooverChain(pair, s, T=1.2 / units.kB,
                                              Q=50.0, num_chains=5,
                                              adjoint=False))
    obs = mj.observables.rdf(s, nbins=64, r_range=(0.75, 2.5))
    vobs = mj.observables.vacf(s, t_range=10)
    gs, vs = [], []
    for _ in range(3):
        traj = sim.simulate(steps=40, dt=0.005, frequency=40)
        gs.append(np.asarray(obs(traj.q[::5])[2]))
        vs.append(np.asarray(vobs(traj.v)))
    p = float(thermo_j.pressure(pair, {"sigma": 1.0, "epsilon": 1.0},
                                traj.q[-1], (), traj.v[-1],
                                s.get_masses(), s.get_cell()))
    rdf_fn, vacf_fn = str(tmp / "rdf_ljf.csv"), str(tmp / "vacf_ljf.csv")
    np.savetxt(rdf_fn, np.vstack([obs.r_axis, np.mean(gs, axis=0)]),
               delimiter=",")
    np.savetxt(vacf_fn, np.mean(vs, axis=0)[None], delimiter=",")
    return {"ljf": {**ENTRY, "rdf_fn": rdf_fn, "fn": rdf_fn,
                    "vacf_fn": vacf_fn, "pressure": p}}


@pytest.fixture(scope="module")
def init_pkl(tmp_path_factory):
    """JAX PairMLP weights (the LJ fit's and the water-style fit's nets)
    as numpy pickles both packages start from."""
    out = {}
    tmp = tmp_path_factory.mktemp("init")
    for name, width, key in (("lj", LJ_ASSIGNMENTS["n_width"], "pairnn"),
                             ("rdf", RDF_ASSIGNMENTS["n_width"], "nn")):
        net = mj.nn.PairMLP(n_gauss=N_GAUSS, r_start=0.0, r_end=2.5,
                            n_layers=1, n_width=width, nonlinear="SELU")
        tree = jax.tree_util.tree_map(
            np.asarray, net.init_params(jax.random.PRNGKey(7)))
        path = str(tmp / f"{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"params": {key: tree}}, f)
        out[name] = (path, tree)
    tnet = mj.nn.TPairMLP(n_gauss=N_GAUSS, r_start=0.0, r_end=2.5, n_layers=1,
                          n_width=RDF_ASSIGNMENTS["n_width"],
                          nonlinear="SELU")
    out["tpair"] = (None, jax.tree_util.tree_map(
        np.asarray, tnet.init_params(jax.random.PRNGKey(8))))
    return out


def _f64(tree):
    """``tree`` in float64 from its float32 values: the port's parameters
    are float32 at construction (a prior's sigma = 0.9 is float32's 0.9)
    and widened by ``.double()``, so the JAX side starts from the same
    values."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(jnp.asarray(a, jnp.float32), jnp.float64),
        tree)


def _flat(state, keys):
    return np.concatenate([np.asarray(state[k]).ravel() for k in keys])


# ---- Boltzmann inversion -------------------------------------------------

def test_bi_targets_match_jax(registry):
    """boltzmann_inversion_targets of the file target and of a target with
    an unsupported core, bit for bit (the same numpy)."""
    x = np.linspace(0.75, 2.5, 64)
    g = np.loadtxt(registry["ljf"]["rdf_fn"], delimiter=",")[1]
    g2 = np.where(x < 1.0, 0.0, 1.0 + 0.5 * np.exp(-((x - 1.5) ** 2)))
    rr = np.linspace(0.5, 2.5, 300)
    got = pretrain.boltzmann_inversion_targets([x, x], [g, g2],
                                               [300.0, 150.0], rr)
    ref = pretrain_j.boltzmann_inversion_targets([x, x], [g, g2],
                                                 [300.0, 150.0], rr)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="supported"):
        pretrain.boltzmann_inversion_targets([x], [np.zeros(64)], [300.0],
                                             rr)


def test_bi_targets_slope_extrapolated_core():
    """Unsupported (g ~ 0) core bins get a slope-continued repulsive wall,
    not a posinf cliff (tests/test_fit.py:342, on the port)."""
    r = np.linspace(0.0, 5.0, 50)
    g = np.where(r < 1.0, 0.0, 1.0 + 0.5 * np.exp(-((r - 1.5) ** 2)))
    g[r < 1.2] = np.where(r[r < 1.2] >= 1.0, 0.05, 0.0)
    kT = 0.07
    rr = np.linspace(0.3, 5.0, 200)
    (t,) = pretrain.boltzmann_inversion_targets([r], [g], [kT / units.kB],
                                                rr, posinf=100.0)
    assert np.isfinite(t).all()
    core = t[rr < 1.0]
    assert (np.diff(core) <= 1e-9).all()
    assert core.max() <= 100.0 + 1e-6
    assert np.abs(np.diff(t)).max() < 5.0
    mid = (rr > 1.4) & (rr < 4.5)
    expect = -kT * np.log(np.interp(rr[mid], r, np.maximum(g, 1e-12)))
    assert np.allclose(t[mid], expect, atol=0.05)


@pytest.mark.parametrize("tdep", [False, True], ids=["pair", "tpair"])
def test_pretrain_matches_jax(registry, init_pkl, tdep):
    """40 iterations of Boltzmann-inversion pretraining (Adam with
    reduce-on-plateau) from the same weights and targets, the prior
    subtracted, two state points (T-dependent: one target each), in
    float64 on both sides: the parameters after it to 1e-12 of the largest
    (measured 9e-17 and 7e-17)."""
    x = np.linspace(0.75, 2.5, 64)
    g = np.loadtxt(registry["ljf"]["rdf_fn"], delimiter=",")[1]
    T_list = [1.2 / units.kB, 1.5 / units.kB]
    rr = np.linspace(0.8, 2.5, 200)
    tree = init_pkl["tpair" if tdep else "rdf"][1]
    kw = dict(n_gauss=N_GAUSS, r_start=0.0, r_end=2.5, n_layers=1,
              n_width=32, nonlinear="SELU")
    with jax.enable_x64(True):
        net_j = (mj.nn.TPairMLP if tdep else mj.nn.PairMLP)(**kw)
        prior_j = mj.potentials.ExcludedVolume(0.9, 0.4)
        out_j = pretrain_j.boltzmann_inversion_pretrain(
            net_j, _f64(tree), prior_j, _f64(prior_j.init_params()),
            [x, x], [g, g * 1.05], T_list, rrange=rr, n_iters=40,
            temperature_dependent=tdep)
        ref = pair_mlp_params_from_numpy(jax.tree_util.tree_map(
            np.asarray, out_j))
    net = (TPairMLP if tdep else PairMLP)(**kw, device="cpu")
    net.load_state_dict(pair_mlp_params_from_numpy(tree))
    net.double()
    prior = ExcludedVolume(0.9, 0.4).double()
    loss = pretrain.boltzmann_inversion_pretrain(
        net, prior, [x, x], [g, torch.tensor(g * 1.05)], T_list, rrange=rr,
        n_iters=40, temperature_dependent=tdep)
    assert np.isfinite(loss)
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    moved = _flat(state, ref) - _flat(pair_mlp_params_from_numpy(tree), ref)
    assert np.abs(moved).max() > 1e-3
    flat_ref = _flat(ref, ref)
    np.testing.assert_allclose(_flat(state, ref), flat_ref, rtol=0,
                               atol=1e-12 * np.abs(flat_ref).max())


# ---- fit_lj --------------------------------------------------------------

def _lj_first_epoch_j(registry, tree):
    """The JAX fit_lj's first-epoch loss and MLP gradient, in float64:
    its loss (mdgrad_tpu/train/fit_rdf_pair.py, ``make``) rebuilt from
    the package's parts, on fit_lj's Stack and integrator."""
    a, sp = LJ_ASSIGNMENTS, LJ_SYS
    with jax.enable_x64(True):
        s = fit_rdf_j.get_system("ljf", sp["size"], registry,
                                 rng=np.random.default_rng(2))
        net = mj.nn.PairMLP(n_gauss=N_GAUSS, r_start=0.0, r_end=2.5,
                            n_layers=1, n_width=a["n_width"],
                            nonlinear="SELU")
        prior = mj.potentials.LJFamily(epsilon=2.0, sigma=0.9, rep_pow=6,
                                       attr_pow=3)
        stack = mj.Stack({
            "pairnn": mj.PairPotentials(s, net, cutoff=2.5, mode="table"),
            "pair": mj.PairPotentials(s, prior, cutoff=2.5)})
        sim = mj.Simulation(s, mj.NoseHooverChain(
            stack, s, T=fit_rdf_j.registry_T_kelvin(registry["ljf"]),
            Q=50.0, num_chains=5, adjoint=True))
        _, g_t, robs, vacf_t, vobs, p_t = fit_rdf_pair_j.get_observer(
            s, "ljf", a["nbins"], sp["t_range"], 0.75, registry)
        ode = sim.epoch_fn(0.01, a["opt_freq"])
        masses, cell = s.get_masses(), s.get_cell()

        def loss_fn(p, state, aux, ctrl):
            traj, _ = ode(p, state, aux, ctrl)
            g = jax.vmap(lambda q: robs(q)[2])(
                traj.q[::sp["frame_skip"]]).mean(0)
            loss = ((g - g_t) ** 2).mean()
            loss = loss + a["vacf_weight"] * (
                (vobs(traj.v) - vacf_t[:sp["t_range"]]) ** 2).mean()
            @jax.checkpoint
            def frame_pressure(qv):
                q, v = qv
                return thermo_j.pressure(stack, p, q,
                                         stack.aux_update(q, aux), v,
                                         masses, cell)

            p_sim = jax.lax.map(frame_pressure,
                                (traj.q[::5], traj.v[::5])).mean()
            return loss + a["pressure_weight"] * (p_sim - p_t) ** 2

        params = _f64(sim.params)
        params["pairnn"] = _f64(tree)
        state, aux = sim.initial_state()
        loss, grads = jax.value_and_grad(loss_fn)(
            params, state, aux, sim.integrator.default_ctrl())
        return float(loss), jax.tree_util.tree_map(np.asarray,
                                                   grads["pairnn"])


def test_fit_lj_first_epoch_matches_jax_in_f64(registry, init_pkl):
    """build_lj plus make_lj_epoch_loss (the RDF, VACF and pressure terms,
    the replay adjoint) from the same weights and state as the JAX
    fit_lj's first epoch, in float64: the loss to rtol 1e-10 and the MLP
    gradient to 1e-10 of its largest entry (measured 7e-16 and 6e-15)."""
    tree = init_pkl["lj"][1]
    loss_j, grads_j = _lj_first_epoch_j(registry, tree)
    comps = fit_rdf_pair.build_lj(LJ_ASSIGNMENTS, LJ_SYS, registry,
                                  rng=np.random.default_rng(2), device="cpu",
                                  dtype=torch.float64)
    net = comps["net"]
    net.load_state_dict(pair_mlp_params_from_numpy(tree))
    sim = comps["sims"][0]
    assert comps["observers"][0][5] == registry["ljf"]["pressure"]
    loss_fn = fit_rdf_pair.make_lj_epoch_loss(
        sim, comps["observers"][0], LJ_ASSIGNMENTS, LJ_SYS, 0.01)
    loss, (g, vacf_sim, p_sim, last, _) = loss_fn(
        *sim.initial_state(), sim.integrator.default_ctrl())
    assert last.q.dtype == torch.float64 and np.isfinite(p_sim.item())
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-10)
    ref = pair_mlp_params_from_numpy(grads_j)
    # the last layer's bias moves no force: no gradient on either side
    got = {k: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
           for k, p in net.named_parameters()}
    flat_ref = _flat(ref, ref)
    assert np.abs(flat_ref).max() > 0
    np.testing.assert_allclose(_flat(got, ref), flat_ref, rtol=0,
                               atol=1e-10 * np.abs(flat_ref).max())


@pytest.fixture(scope="module")
def lj_fits(registry, init_pkl):
    """A 2-epoch fit_lj of each package from the same init_pkl."""
    sys_params = dict(LJ_SYS, init_pkl=init_pkl["lj"][0])
    logs_j, logs = [], []
    out_j = fit_rdf_pair_j.fit_lj(LJ_ASSIGNMENTS, sys_params,
                                  registry=registry,
                                  rng=np.random.default_rng(2),
                                  log=logs_j.append)
    out = fit_rdf_pair.fit_lj(LJ_ASSIGNMENTS, sys_params, registry=registry,
                              rng=np.random.default_rng(2), log=logs.append,
                              device="cpu")
    return out_j, out, logs_j, logs


def test_fit_lj_matches_jax(lj_fits):
    """Two epochs of fit_lj from one init_pkl in float32: epoch 0's loss
    (equal weights and states) to rtol 1e-4, epoch 1's (after Adam's
    sign-like first step: a gradient entry below the float32 error moves
    its weight by +-lr either way) and the observables to 1e-3; the
    recovered u(r) to 1e-3 of its largest value.  Measured on the CPU:
    5.0e-6 and 8.6e-5, the observables 3.1e-4, u(r) 2.2e-7."""
    out_j, out, logs_j, logs = lj_fits
    assert any("warm start" in str(m) for m in logs)
    assert len(out["loss_log"]) == len(out_j["loss_log"]) == 2
    np.testing.assert_allclose(out["loss_log"][0], out_j["loss_log"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(out["loss_log"][1], out_j["loss_log"][1],
                               rtol=1e-3)
    for key in ("rdf", "vacf", "pressure"):
        for got, ref in zip(out["obs_log"]["ljf"][key],
                            out_j["obs_log"]["ljf"][key]):
            np.testing.assert_allclose(
                got, ref, rtol=0,
                atol=1e-3 * max(np.abs(np.asarray(ref)).max(), 1.0))
    np.testing.assert_array_equal(out["r_grid"], out_j["r_grid"])
    np.testing.assert_allclose(out["u_target"], out_j["u_target"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["u_fit"], out_j["u_fit"], rtol=0,
                               atol=1e-3 * np.abs(out_j["u_fit"]).max())
    assert out["objective"] == out["loss_log"][-1]


def test_g_only_target_raises():
    """A Morse target file holds 60 values of g and no r column: the port's
    get_observer names the file and the missing column, and assumes no
    grid (ROADMAP Queue 3, deliberate deviation)."""
    from mdgrad_tpu_torch.data.registry import pair_data_dict
    tag = next(k for k in pair_data_dict if k.startswith("morse"))
    system = fit_rdf.get_system(tag, 2, pair_data_dict,
                                rng=np.random.default_rng(0))
    fn = pair_data_dict[tag]["rdf_fn"]
    with pytest.raises(ValueError, match="no r column") as info:
        fit_rdf_pair.get_observer(system, tag, 60, 10, 0.5, device="cpu")
    assert os.path.basename(fn) in str(info.value)


# ---- fit_rdf's pair branches ---------------------------------------------

def _rdf_first_epoch(registry, tree, tpair, f64_jax):
    sys_params = dict(RDF_SYS, pair_flag=not tpair, tpair_flag=tpair)
    if f64_jax:
        with jax.enable_x64(True):
            comps = fit_rdf_j.build_fit(RDF_ASSIGNMENTS, sys_params,
                                        registry,
                                        rng=np.random.default_rng(1))
            params = _f64(comps["params"])
            if tpair:
                params["nn"]["model"] = _f64(tree)
            else:
                params["nn"] = _f64(tree)
            sim = comps["sims"][0]
            kT = fit_rdf_j.registry_T_kelvin(registry["ljf"]) * units.kB
            vg, _ = fit_rdf_j._make_epoch_loss(
                sim, comps["observers"][0], comps["targets"][0],
                comps["systems"][0], RDF_ASSIGNMENTS["opt_freq"],
                RDF_SYS["dt"], RDF_SYS["frame_skip"],
                kT_override=kT if tpair else None)
            state, aux = sim.initial_state()
            (loss, _), grads = vg(params, state, aux,
                                  sim.integrator.default_ctrl())
            g = grads["nn"]["model"] if tpair else grads["nn"]
            return float(loss), jax.tree_util.tree_map(np.asarray, g)
    comps = fit_rdf.build_fit(RDF_ASSIGNMENTS, sys_params, registry,
                              rng=np.random.default_rng(1), device="cpu",
                              dtype=torch.float64)
    comps["net"].load_state_dict(pair_mlp_params_from_numpy(tree))
    sim = comps["sims"][0]
    loss_fn = fit_rdf.make_epoch_loss(
        sim, comps["observers"][0], comps["targets"][0], comps["systems"][0],
        RDF_ASSIGNMENTS["opt_freq"], RDF_SYS["dt"], RDF_SYS["frame_skip"])
    loss, _ = loss_fn(*sim.initial_state(), sim.integrator.default_ctrl())
    return loss.item(), comps


@pytest.mark.parametrize("tpair", [False, True], ids=["pair", "tpair"])
def test_fit_rdf_pair_first_epoch_matches_jax_in_f64(registry, init_pkl,
                                                     tpair):
    """build_fit with pair_flag (PairMLP) and tpair_flag (TPairMLP at the
    state point's kT, the nn interaction a TPairPotentials whose kT no
    optimizer sees) plus the first epoch against the JAX driver's
    (_make_epoch_loss with kT_override), the same weights, in float64:
    the loss to rtol 1e-10, the gradient to 1e-10 of its largest entry
    (measured 1.2e-14 and 9.5e-15; T-dependent 2.1e-14 and 2.2e-14)."""
    tree = init_pkl["tpair" if tpair else "rdf"][1]
    loss_j, grads_j = _rdf_first_epoch(registry, tree, tpair, True)
    loss, comps = _rdf_first_epoch(registry, tree, tpair, False)
    nn_int = comps["sims"][0].integrator.model.models["nn"]
    assert type(nn_int).__name__ == ("TPairPotentials" if tpair
                                     else "PairPotentials")
    assert nn_int.mode == "table"
    ids = {id(p) for p in comps["params"]}
    assert ids == {id(p) for p in comps["net"].parameters()}
    np.testing.assert_allclose(loss, loss_j, rtol=1e-10)
    ref = pair_mlp_params_from_numpy(grads_j)
    got = {k: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
           for k, p in comps["net"].named_parameters()}
    flat_ref = _flat(ref, ref)
    np.testing.assert_allclose(_flat(got, ref), flat_ref, rtol=0,
                               atol=1e-10 * np.abs(flat_ref).max())


def test_fit_rdf_depth_guard_and_kt(registry):
    """tpair_flag with u_reg_weight: the guard logs the pretrained depths
    and floors, the fit runs, and each state point's TPairPotentials keeps
    its own kT; u_reg_weight with a SchNet still raises."""
    logs = []
    reg = dict(registry)
    reg["ljg"] = {**registry["ljf"], "T": 1.5}
    comps = fit_rdf.build_fit(RDF_ASSIGNMENTS,
                              dict(RDF_SYS, tpair_flag=True, pair_flag=False,
                                   val=["ljg"]), reg, device="cpu")
    kTs = [sim.integrator.model.models["nn"].kT.item()
           for sim in comps["sims"]]
    np.testing.assert_allclose(kTs, [1.2, 1.5], rtol=1e-12)
    out = fit_rdf.fit_rdf(
        RDF_ASSIGNMENTS, dict(RDF_SYS, tpair_flag=True, pair_flag=False,
                              u_reg_weight=10.0, n_epochs=1, n_sim=0,
                              val=["ljg"]),
        registry=reg, rng=np.random.default_rng(1), log=logs.append,
        device="cpu")
    assert any(str(m).startswith("depth guard: pretrained depths")
               for m in logs)
    assert len(out["loss_log"]) == 1 and np.isfinite(out["loss_log"][0])
    with pytest.raises(NotImplementedError, match="u_reg_weight"):
        fit_rdf.build_fit(
            {**RDF_ASSIGNMENTS, "n_atom_basis": 8, "n_filters": 8,
             "n_convolutions": 1},
            dict(RDF_SYS, pair_flag=False, u_reg_weight=1.0), reg,
            device="cpu")


def _shift_bias(tree, tpair, delta):
    """``tree`` with ``delta`` added to the last layer's bias (for a
    TPairMLP the energy MLP's): u(r) moves by ``delta`` everywhere."""
    tree = jax.tree_util.tree_map(np.array, tree)
    net = tree["_PairMLPModule_0"] if tpair else tree
    net["Dense_4"]["bias"] = net["Dense_4"]["bias"] + np.float32(delta)
    return tree


@pytest.mark.parametrize("tpair", [False, True], ids=["pair", "tpair"])
def test_depth_guard_value_and_grad_match_jax(registry, init_pkl, tpair):
    """The well-depth guard, active, against the JAX driver's ``_reg``
    (fit_rdf.py: the depth of net + prior on the 200-point grid at each
    training kT, floors u_floor_mult x min(d0, 0)), in float64.  The net's
    well is pushed 1 below zero for the pretrained depths d0, then raised
    by 0.2: with u_floor_mult 0.5 every state point sits below its floor,
    so value and gradient are nonzero.  Value to rtol 1e-10, gradient to
    1e-10 of its largest entry."""
    reg = dict(registry)
    reg["ljg"] = {**registry["ljf"], "T": 1.5}
    tags, weight, mult = ["ljf", "ljg"], 200.0, 0.5
    sp = dict(RDF_SYS, pair_flag=not tpair, tpair_flag=tpair)
    base = init_pkl["tpair" if tpair else "rdf"][1]
    tree0 = _shift_bias(base, tpair, -1.0)
    tree1 = _shift_bias(base, tpair, -0.8)

    net, prior = fit_rdf._build_net_and_prior(RDF_ASSIGNMENTS, sp,
                                              device="cpu")
    net.load_state_dict(pair_mlp_params_from_numpy(tree0))
    net.double()
    prior.double()
    guard = fit_rdf._depth_guard(net, prior, tags, tags, reg, 2.5, weight,
                                 mult, tpair)
    net.load_state_dict(pair_mlp_params_from_numpy(tree1))
    value = guard()

    with jax.enable_x64(True):
        net_j, prior_j = fit_rdf_j._build_net_and_prior(RDF_ASSIGNMENTS, sp)
        prior_p = _f64(prior_j.init_params())
        grid = jnp.linspace(0.75 + 0.3, 2.5, 200)[:, None]
        kTs = jnp.asarray([fit_rdf_j.registry_T_kelvin(reg[t]) * units.kB
                           for t in tags])

        def depth(p, kT):
            u = net_j(p, grid, kT) if tpair else net_j(p, grid)
            return (u.squeeze(-1) + prior_j(prior_p, grid).squeeze(-1)).min()

        d0 = jnp.stack([depth(_f64(tree0), kT) for kT in kTs])
        floor = mult * jnp.minimum(d0, 0.0)

        def reg_fn(p):
            d = jnp.stack([depth(p, kT) for kT in kTs])
            return weight * (jax.nn.relu(floor - d) ** 2).sum()

        value_j, grads_j = jax.value_and_grad(reg_fn)(_f64(tree1))
        np.testing.assert_allclose(guard.d0, np.asarray(d0), rtol=1e-12)
        assert float(value_j) > 1.0
        np.testing.assert_allclose(value, float(value_j), rtol=1e-10)
        ref = pair_mlp_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, grads_j))
    got = {k: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
           for k, p in net.named_parameters()}
    flat_ref = _flat(ref, ref)
    assert np.abs(flat_ref).max() > 0
    np.testing.assert_allclose(_flat(got, ref), flat_ref, rtol=0,
                               atol=1e-10 * np.abs(flat_ref).max())


def test_fit_rdf_depth_guard_pulls_the_well_up(registry):
    """tests/test_fit.py::test_fit_rdf_multistate_depth_guard on the port:
    with a floor shallower than the pretrained well (u_floor_mult 0.5)
    and a large weight the guard is active from the first epoch, and the
    trained well ends shallower than the pretrained one."""
    import re
    reg = dict(registry)
    reg["ljg"] = {**registry["ljf"], "T": 1.4, "rho": 0.80}
    sys_params = dict(RDF_SYS, pair_flag=False, tpair_flag=True,
                      data=["ljf", "ljg"], opt_freq=11, n_epochs=3,
                      n_sim=0, pretrain_iters=60, u_reg_weight=200.0,
                      u_floor_mult=0.5)
    logs = []
    out = fit_rdf.fit_rdf(RDF_ASSIGNMENTS, sys_params, registry=reg,
                          rng=np.random.default_rng(1), log=logs.append,
                          device="cpu")
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 3
    m = re.search(r"pretrained depths \[([^\]]+)\]", "\n".join(
        str(s) for s in logs))
    assert m is not None
    d0 = [float(v) for v in m.group(1).split()]
    assert max(d0) < 0
    net, prior = fit_rdf._build_net_and_prior(RDF_ASSIGNMENTS, sys_params,
                                              device="cpu")
    net.load_state_dict(out["params"])
    grid = torch.linspace(0.75 + 0.3, 2.5, 200)[:, None]
    with torch.no_grad():
        for kT, d_start in zip((1.2, 1.4), d0):
            u = net(grid, torch.tensor(kT)) + prior(grid)
            assert u.min().item() > d_start + 1e-3


def test_large_water_prior_is_sparse_like_jax():
    """The water GNN fit at size 6 (1728 sites) builds: its prior takes
    'sparse' under prior_mode 'auto' (N^2 > 2^20) with the JAX build's
    capacity, and that prior's energy and forces equal the dense mode's."""
    a = {"cutoff": 6.0, "epsilon": 0.010637550996566496,
         "gaussian_width": 0.195, "lr": 1.839e-4, "n_atom_basis": "tiny",
         "n_filters": "tiny", "n_convolutions": 1, "nbins": 109,
         "opt_freq": 52, "sigma": 2.61227614490785}
    sp = {"dt": 0.5, "n_epochs": 1, "n_sim": 0, "data": ["H20_298K_redd"],
          "val": None, "size": 6, "anneal_flag": "False"}
    comps = fit_rdf.build_fit(a, sp, rng=np.random.default_rng(0),
                              device="cpu")
    comps_j = fit_rdf_j.build_fit(a, sp, rng=np.random.default_rng(0))
    prior = comps["sims"][0].integrator.model.models["pair"]
    prior_j = comps_j["sims"][0].integrator.model.models["pair"]
    assert comps["systems"][0].get_number_of_atoms() == 1728
    assert prior.mode == prior_j.mode == "sparse"
    assert prior.capacity == prior_j.capacity
    dense = PairPotentials(comps["systems"][0], comps["prior"], cutoff=6.0,
                           mode="dense", device="cpu")
    rng = np.random.default_rng(1)
    x = torch.tensor(comps["systems"][0].get_positions()
                     + rng.normal(0.0, 0.1, (1728, 3)), dtype=torch.float32,
                     requires_grad=True)
    out = []
    for inter in (prior, dense):
        e = inter.energy(x, inter.aux_init(x.detach()))
        (g,) = torch.autograd.grad(e, x)
        out.append((e.item(), g.numpy()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=0,
                               atol=1e-5 * np.abs(out[1][1]).max())


def test_2d_stripe_system_matches_jax():
    """get_system of a 2-D stripe entry: the square lattice, dim 2,
    z velocities zero, as the JAX package builds it from the same seed."""
    from mdgrad_tpu_torch.data.registry import pair_data_dict
    tag = next(k for k in pair_data_dict if k.startswith("overlap"))
    s = fit_rdf.get_system(tag, 4, pair_data_dict,
                           rng=np.random.default_rng(3))
    sj = fit_rdf_j.get_system(tag, 4, pair_data_dict,
                              rng=np.random.default_rng(3))
    assert s.dim == sj.dim == 2
    for f in ("get_positions", "get_velocities", "get_masses", "get_cell"):
        np.testing.assert_array_equal(getattr(s, f)(),
                                      np.asarray(getattr(sj, f)()))
    assert not s.get_velocities()[:, 2].any()


# ---- tests/test_fit.py's pair-fit tests, on the port ---------------------

def _lj_registry(tag):
    return {tag: dict(ENTRY)}


SMALL_A = {"nbins": 32, "opt_freq": 12, "lr": 3e-3, "sigma": 0.9,
           "gaussian_width": 0.1, "n_width": 16, "n_layers": 1,
           "nonlinear": "SELU", "rdf_weight": 1.0}
SMALL_SYS = {"size": 2, "cutoff": 2.5, "t_range": 8, "n_epochs": 3,
             "n_sim": 1, "data": ["ljc"], "val": None, "target_nsim": 3,
             "frame_skip": 4, "ckpt_every": 1}


def test_fit_rdf_pair_smoke(registry):
    out = fit_rdf.fit_rdf(RDF_ASSIGNMENTS, RDF_SYS, registry=registry,
                          rng=np.random.default_rng(1), log=_quiet,
                          device="cpu")
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 3
    assert np.isfinite(out["objective"])
    assert "ljf" in out["final"]


def test_gradient_step_descends(registry):
    """A small step against the pair-MLP gradient lowers the epoch loss
    re-evaluated from the same state (tests/test_fit.py:130)."""
    sys_params = dict(RDF_SYS, n_epochs=1, pretrain_iters=50)
    comps = fit_rdf.build_fit(RDF_ASSIGNMENTS, sys_params, registry,
                              rng=np.random.default_rng(1), device="cpu")
    sim = comps["sims"][0]
    loss_fn = fit_rdf.make_epoch_loss(
        sim, comps["observers"][0], comps["targets"][0], comps["systems"][0],
        21, 0.005, 5)
    state, aux = sim.initial_state()
    ctrl = sim.integrator.default_ctrl()
    l0, _ = loss_fn(state, aux, ctrl)
    params = comps["params"]
    # the last layer's bias moves no force: it has no gradient
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for p in params]
    start = [p.detach().clone() for p in params]
    for lr in (1e-4, 1e-5):
        with torch.no_grad():
            for p, p0, g in zip(params, start, grads):
                p.copy_(p0 - lr * g)
        l1, _ = loss_fn(state, aux, ctrl)
        if l1.item() < l0.item():
            return
    raise AssertionError(f"no descent: l0={l0.item()}, l1={l1.item()}")


def test_fit_lj_self_generated_targets():
    """No target file: the ground-truth LJ is simulated for the target,
    then 2 epochs; the recovered-potential grid is produced."""
    out = fit_rdf_pair.fit_lj(
        {"nbins": 40, "opt_freq": 16, "lr": 3e-3, "sigma": 0.9,
         "gaussian_width": 0.1, "n_width": 24, "n_layers": 1,
         "nonlinear": "SELU", "rdf_weight": 1.0, "vacf_weight": 0.1,
         "train_vacf": "True"},
        {"size": 2, "cutoff": 2.5, "t_range": 10, "n_epochs": 2,
         "n_sim": 1, "data": ["ljx"], "val": None, "target_nsim": 4,
         "frame_skip": 4},
        registry=_lj_registry("ljx"), rng=np.random.default_rng(2),
        log=_quiet, device="cpu")
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 2
    assert out["u_target"] is not None
    assert out["u_fit"].shape == out["u_target"].shape
    assert np.isfinite(out["u_fit"]).all()


def test_fit_lj_checkpoint_resume(tmp_path):
    """fit_lj checkpoints (parameters, optimizer, MD states, logs) every
    epoch and a longer second call resumes, its history extending the
    first's."""
    mp = str(tmp_path / "run")
    out1 = fit_rdf_pair.fit_lj(SMALL_A, SMALL_SYS, model_path=mp,
                               registry=_lj_registry("ljc"),
                               rng=np.random.default_rng(2), log=_quiet,
                               device="cpu")
    assert len(out1["loss_log"]) == 3
    assert any(f.startswith("fit-ckpt-") for f in os.listdir(mp))
    msgs = []
    out2 = fit_rdf_pair.fit_lj(SMALL_A, dict(SMALL_SYS, n_epochs=5),
                               model_path=mp, registry=_lj_registry("ljc"),
                               rng=np.random.default_rng(2),
                               log=msgs.append, device="cpu")
    assert any("resumed" in str(m) for m in msgs)
    assert len(out2["loss_log"]) == 5
    np.testing.assert_allclose(out2["loss_log"][:3], out1["loss_log"],
                               rtol=1e-6)
    assert len(out2["obs_log"]["ljc"]["rdf"]) == 5


def test_fit_lj_warm_start_init_pkl(tmp_path):
    """A second fit seeded from the first's best.pt starts from those MLP
    parameters and skips the pretraining."""
    mp = str(tmp_path / "seed")
    sys1 = dict(SMALL_SYS, n_epochs=1)
    fit_rdf_pair.fit_lj(SMALL_A, sys1, model_path=mp,
                        registry=_lj_registry("ljc"),
                        rng=np.random.default_rng(2), log=_quiet,
                        device="cpu")
    seed = os.path.join(mp, "best.pt")
    best = torch.load(seed, weights_only=True)
    assert best["epoch"] == 0
    msgs = []
    out = fit_rdf_pair.fit_lj(
        SMALL_A, dict(sys1, init_pkl=seed, pretrain_iters=50, n_epochs=0),
        model_path=str(tmp_path / "warm"), registry=_lj_registry("ljc"),
        rng=np.random.default_rng(3), log=msgs.append, device="cpu")
    assert any("warm start" in str(m) for m in msgs)
    for k, v in best["params"].items():
        assert torch.equal(out["params"][k], v), k


def test_fit_lj_burnin_equilibrates_before_training():
    logs = []
    out = fit_rdf_pair.fit_lj(
        {"nbins": 40, "opt_freq": 16, "lr": 3e-3, "sigma": 0.9,
         "gaussian_width": 0.1, "n_width": 24, "n_layers": 1,
         "nonlinear": "SELU", "rdf_weight": 1.0, "vacf_weight": 0.0,
         "train_vacf": "False"},
        {"size": 2, "cutoff": 2.5, "t_range": 10, "n_epochs": 2,
         "n_sim": 1, "data": ["ljb"], "val": None, "target_nsim": 4,
         "frame_skip": 4, "burnin_epochs": 3},
        registry=_lj_registry("ljb"), rng=np.random.default_rng(2),
        log=logs.append, device="cpu")
    assert not out.get("nan_bailout", False)
    assert any("burn-in: 3 epochs" in str(m) for m in logs)
    assert len(out["loss_log"]) == 2


def test_fit_lj_state_reset_and_eval():
    """state_reset_every restores the post-burn-in states; eval_every
    scores the equilibrated observables and keeps best_eval."""
    out = fit_rdf_pair.fit_lj(
        {"nbins": 40, "opt_freq": 16, "lr": 3e-3, "sigma": 0.9,
         "gaussian_width": 0.1, "n_width": 24, "n_layers": 1,
         "nonlinear": "SELU", "rdf_weight": 1.0, "vacf_weight": 0.0,
         "train_vacf": "False"},
        {"size": 2, "cutoff": 2.5, "t_range": 10, "n_epochs": 4,
         "n_sim": 1, "data": ["ljr"], "val": None, "target_nsim": 4,
         "frame_skip": 4, "burnin_epochs": 1, "state_reset_every": 2,
         "eval_every": 3, "eval_eq_epochs": 1, "eval_sample_epochs": 1},
        registry=_lj_registry("ljr"), rng=np.random.default_rng(2),
        log=_quiet, device="cpu")
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 4
    assert np.isfinite(out["loss_log"]).all()
    assert [e["epoch"] for e in out["eval_log"]] == [0, 3]


def test_run_lj_torch_dry_run(tmp_path):
    """scripts/run_lj_torch.py --dry_run on the CPU prints its objective."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "run_lj_torch.py"),
         "--dry_run", "-device", "cpu", "-logdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    objective = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("objective:")]
    assert len(objective) == 1 and np.isfinite(float(objective[0].split()[1]))
    assert "epoch 1 | loss" in proc.stdout
