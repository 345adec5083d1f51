"""The port's fitting driver on its own: the JAX package's driver tests
(tests/test_fit.py) mirrored on the GNN branch of
mdgrad_tpu_torch/train/fit_rdf.py -- the smoke fit, descent along the
gradient, NaN recovery, backtrack, overflow regrow and ``grow_capacity``
-- plus what the port's mutable state needs: resume gives the same bits
as an uninterrupted fit, ``.grad`` is clear after an epoch that applies
no update, a validation state point adds nothing to the gradient,
snapshots are copies, each unported branch raises, and
``scripts/run_water_torch.py --dry_run -device cpu`` runs.

The synthetic registry is tests/test_fit.py's (a 32-atom FCC LJ box in
reduced units), its target g(r) simulated here by the port's dense
LennardJones path; the fits use the tiny SchNet on the CPU.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import topology
from mdgrad_tpu_torch.md import NVTStateF
from mdgrad_tpu_torch.train import checkpoint, fit_rdf

REPO = pathlib.Path(__file__).resolve().parents[1]
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
    """tests/test_fit.py's synthetic LJ target, simulated by the port;
    ``ljval`` is the same state point under another name, for the
    validation tests."""
    tmp = tmp_path_factory.mktemp("targets")
    rho, T = 0.845, 1.2
    entry = {"rho": rho, "T": T, "start": 0.75, "end": 2.5,
             "element": "H", "mass": 1.0, "N_unitcell": 4, "cell": "fcc",
             "reduced_units": True}
    reg = {"ljtest": entry}
    s = fit_rdf.get_system("ljtest", 2, reg, rng=np.random.default_rng(0))
    pair = mt.PairPotentials(s, mt.potentials.LennardJones(1.0, 1.0),
                             cutoff=2.5, device="cpu")
    integ = mt.NoseHooverChain(pair, s, T=T, num_chains=3, Q=30.0,
                               adjoint=False, device="cpu")
    sim = mt.Simulation(s, integ)
    obs = mt.observables.rdf(s, nbins=64, r_range=(0.75, 2.5), device="cpu")
    gs = []
    for _ in range(4):
        traj = sim.simulate(steps=40, dt=0.005, frequency=40)
        gs.append(obs(traj.q[::5])[2].numpy())
    fn = os.path.join(str(tmp), "rdf_target.csv")
    np.savetxt(fn, np.vstack([obs.r_axis, np.mean(gs, axis=0)]),
               delimiter=",")
    entry["fn"] = fn
    return {"ljtest": entry, "ljval": dict(entry)}


def _fit(registry, model_path=None, **sys_params):
    logs = []
    out = fit_rdf.fit_rdf(ASSIGNMENTS, {**SYS_PARAMS, **sys_params},
                          model_path=model_path, registry=registry,
                          rng=np.random.default_rng(1),
                          log=logs.append, device="cpu")
    return out, "\n".join(str(m) for m in logs)


@pytest.fixture
def captured(monkeypatch):
    """build_fit's components of the next fit_rdf call."""
    comps = {}
    real = fit_rdf.build_fit

    def capture(*a, **kw):
        comps.update(real(*a, **kw))
        comps["initial"] = {k: v.clone()
                            for k, v in comps["net"].state_dict().items()}
        return comps

    monkeypatch.setattr(fit_rdf, "build_fit", capture)
    return comps


def _same(state_a, state_b):
    return all(torch.equal(state_a[k], state_b[k]) for k in state_a)


def test_fit_rdf_gnn_smoke(lj_registry, tmp_path):
    out, logs = _fit(lj_registry)
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 2 and np.isfinite(out["loss_log"]).all()
    assert np.isfinite(out["objective"])
    fin = out["final"]["ljtest"]
    assert fin["g_sim"].shape == (64,) and np.isfinite(fin["g_sim"]).all()
    assert "epoch 1 | loss" in logs
    # the files a fit with a model_path writes
    _fit(lj_registry, model_path=str(tmp_path))
    for name in ("assignments.json", "loss.csv", "rdf_ljtest.csv"):
        assert (tmp_path / name).exists(), name


def test_gradient_step_descends(lj_registry):
    """A small step against the SchNet gradient lowers the epoch loss
    re-evaluated from the same initial state."""
    comps = fit_rdf.build_fit(ASSIGNMENTS, {**SYS_PARAMS, "n_epochs": 1},
                              registry=lj_registry,
                              rng=np.random.default_rng(1), device="cpu")
    sim = comps["sims"][0]
    args = (sim, comps["observers"][0], comps["targets"][0],
            comps["systems"][0], 21, 0.005, 5)
    state, aux = sim.initial_state()
    ctrl = sim.integrator.default_ctrl()
    l0, _ = fit_rdf.make_epoch_loss(*args)(state, aux, ctrl)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for p in comps["params"]]
    evaluate = fit_rdf.make_epoch_loss(*args, backward=False)
    start = [p.detach().clone() for p in comps["params"]]
    for lr in (1e-4, 1e-5):
        with torch.no_grad():
            for p, p0, g in zip(comps["params"], start, grads):
                p.copy_(p0 - lr * g)
        l1, _ = evaluate(state, aux, ctrl)
        if l1.item() < l0.item():
            return
    raise AssertionError(f"no descent: l0={l0.item()}, l1={l1.item()}")


def test_fit_rdf_nan_recovery(lj_registry, monkeypatch):
    """A poisoned epoch restores the last good snapshot, rethermalizes,
    halves the step scale and retries; every epoch starts with clear
    gradients."""
    real = fit_rdf.make_epoch_loss
    poisoned = {"armed": True}
    grads_clear = []

    def patched(*a, **kw):
        loss_fn = real(*a, **kw)
        net = a[0].integrator.model.models["nn"].gnn

        def wrapped(state, aux, ctrl):
            grads_clear.append(all(p.grad is None for p in net.parameters()))
            loss, (g, last, final_aux) = loss_fn(state, aux, ctrl)
            if poisoned["armed"]:
                poisoned["armed"] = False
                last = last._replace(q=torch.full_like(last.q, np.nan))
            return loss, (g, last, final_aux)

        return wrapped

    monkeypatch.setattr(fit_rdf, "make_epoch_loss", patched)
    out, logs = _fit(lj_registry, n_epochs=3)
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 3
    assert np.isfinite(out["objective"])
    assert "restored last-good + rethermalized" in logs
    assert "step_scale -> 0.5" in logs
    assert grads_clear == [True] * 4      # 3 epochs and the retry


def test_fit_rdf_backtrack_recovery(lj_registry, monkeypatch, captured):
    """Persistent non-finite epochs go back to the epoch-0 snapshot: the
    parameters the fit then runs from are the epoch-0 entry parameters,
    bit for bit, though epoch 0 updated them (the snapshot is a copy)."""
    real = fit_rdf._traj_finite
    calls = {"n": 0}
    seen = []

    def flaky(last):
        calls["n"] += 1
        seen.append({k: v.clone()
                     for k, v in captured["net"].state_dict().items()})
        return False if calls["n"] in (2, 3) else real(last)

    monkeypatch.setattr(fit_rdf, "_traj_finite", flaky)
    out, logs = _fit(lj_registry, n_epochs=3, backtrack_every=1,
                     backtrack_after=2)
    assert "BACKTRACK to the epoch-0 snapshot" in logs
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 3 and np.isfinite(out["objective"])
    assert not _same(seen[1], captured["initial"])   # epoch 0 updated
    assert _same(seen[3], captured["initial"])       # after the backtrack


def test_fit_rdf_overflow_regrow(lj_registry, captured):
    """A table far too small overflows at epoch 0: the update is skipped,
    the capacity regrows, the entry state is restored and the fit trains
    to the end; the tables after the regrow have the new K."""
    out, logs = _fit(lj_registry, n_epochs=4, capacity_slack=0.05,
                     overflow_policy="regrow", regrow_factor=8.0)
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 4 and np.isfinite(out["objective"])
    assert "capacity grown" in logs
    assert "epoch 0: parameter update skipped" in logs
    assert "epoch 3: parameter update skipped" not in logs
    gnn = captured["sims"][0].integrator.model.models["nn"]
    assert gnn.k_max == 32 > 8
    assert not _same(dict(captured["net"].state_dict()),
                     captured["initial"])


def test_grow_capacity_clears_overflow(lj_registry):
    """grow_capacity enlarges a too-small table until the overflow flag
    clears; the regrown table's energy equals that at k_max = N; at N it
    reports False; dense PairPotentials and a Stack report what their
    children do."""
    s = fit_rdf.get_system("ljtest", 2, lj_registry,
                           rng=np.random.default_rng(0))
    gnn = mt.SchNet({"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 10,
                     "n_convolutions": 2, "cutoff": 2.5})
    table = mt.GNNPotentials(s, gnn, cutoff=2.5, k_max=8, device="cpu")
    full = mt.GNNPotentials(s, gnn, cutoff=2.5, k_max=32, device="cpu")
    xyz = torch.tensor(s.get_positions(), dtype=torch.float32)
    aux = table.aux_init(xyz)
    assert topology.aux_overflow(aux) and aux.table.shape == (32, 8)
    assert table.grow_capacity(factor=2.0) and table.k_max == 16
    assert table.grow_capacity(factor=2.0) and table.k_max == 32
    aux = table.aux_init(xyz)
    assert not topology.aux_overflow(aux) and aux.table.shape == (32, 32)
    with torch.no_grad():
        e = table.energy(xyz, aux)
        e_full = full.energy(xyz, full.aux_init(xyz))
    assert torch.equal(e, e_full)
    assert not table.grow_capacity(factor=2.0)
    prior = mt.PairPotentials(s, mt.potentials.ExcludedVolume(), cutoff=2.5,
                              device="cpu")
    assert not prior.grow_capacity(2.0)
    small = mt.GNNPotentials(s, gnn, cutoff=2.5, k_max=8, device="cpu")
    stack = mt.Stack({"nn": small, "pair": prior})
    assert stack.grow_capacity(1.5) and small.k_max == 16
    assert not mt.Stack({"pair": prior}).grow_capacity(1.5)


def test_resume_gives_the_same_bits(lj_registry, tmp_path):
    """A fit stopped after 2 epochs and resumed to 4 equals a 4-epoch fit
    bit for bit: losses, parameters, objective.  Checkpoints rotate (the
    newest 3 kept) and load with weights_only; reset_opt_on_resume starts
    a fresh optimizer."""
    whole, _ = _fit(lj_registry, n_epochs=4)
    mp = str(tmp_path / "run")
    first, _ = _fit(lj_registry, n_epochs=2, ckpt_every=1, model_path=mp)
    assert sorted(os.listdir(mp)).count("fit-ckpt-1.pt") == 1
    resumed, logs = _fit(lj_registry, n_epochs=4, ckpt_every=1,
                         model_path=mp)
    assert "resumed from checkpoint at epoch 1" in logs
    assert "epoch 0 |" not in logs and "epoch 1 |" not in logs
    assert resumed["loss_log"][:2] == first["loss_log"]
    assert resumed["loss_log"] == whole["loss_log"]
    assert resumed["objective"] == whole["objective"]
    assert _same(resumed["params"], whole["params"])
    assert sorted(f for f in os.listdir(mp) if f.startswith("fit-ckpt")) \
        == ["fit-ckpt-1.pt", "fit-ckpt-2.pt", "fit-ckpt-3.pt"]
    blob = torch.load(os.path.join(mp, "fit-ckpt-3.pt"), weights_only=True)
    assert blob["epoch"] == 3 and len(blob["logs"]["loss_log"]) == 4
    assert blob["opt_state"]["adam"]["state"]       # Adam's moments
    again, logs = _fit(lj_registry, n_epochs=5, ckpt_every=1, model_path=mp,
                       reset_opt_on_resume=True)
    assert "optimizer state reset on resume" in logs
    assert len(again["loss_log"]) == 5


def test_checkpointer(tmp_path):
    """maybe_save fires on (epoch + 1) % every == 0, keeps the newest
    `keep` files, leaves no .tmp behind, and model_path=None does
    nothing; NamedTuple states round-trip through from_plain."""
    assert checkpoint.FitCheckpointer(None).restore() is None
    checkpoint.FitCheckpointer(None).save(0, {}, {})
    ck = checkpoint.FitCheckpointer(str(tmp_path), every=2, keep=2)
    state = NVTStateF(v=torch.ones(2, 3), q=torch.zeros(2, 3),
                      pv=torch.arange(3.0), f=torch.ones(2, 3), fv=True)
    for epoch in range(7):
        ck.maybe_save(epoch, {"w": torch.full((2,), float(epoch))}, {},
                      [(state, {"nn": (), "t": torch.tensor(epoch)})])
    assert sorted(os.listdir(tmp_path)) == ["fit-ckpt-3.pt", "fit-ckpt-5.pt"]
    blob = ck.restore()
    assert blob["epoch"] == 5 and torch.equal(blob["params"]["w"],
                                              torch.full((2,), 5.0))
    template = [(state._replace(pv=torch.zeros(3)),
                 {"nn": (), "t": torch.tensor(0)})]
    (back, aux), = checkpoint.from_plain(template, blob["md_states"])
    assert isinstance(back, NVTStateF) and back.fv is True
    assert torch.equal(back.pv, state.pv) and aux["t"].item() == 5


def test_grad_is_clear_after_skipped_and_failed_epochs(lj_registry,
                                                        monkeypatch,
                                                        captured):
    """An epoch whose update is skipped (overflow_policy='skip' with a
    table that always overflows) and a NaN bailout leave no gradient
    behind and the parameters where they started."""
    out, logs = _fit(lj_registry, n_epochs=2, capacity_slack=0.05,
                     overflow_policy="skip")
    assert "epoch 1: parameter update skipped" in logs
    assert all(p.grad is None for p in captured["net"].parameters())
    assert _same(dict(captured["net"].state_dict()), captured["initial"])

    monkeypatch.setattr(fit_rdf, "_traj_finite", lambda last: False)
    out, logs = _fit(lj_registry, n_epochs=2)
    assert out["nan_bailout"] and "NaN bailout at epoch 0" in logs
    assert all(p.grad is None for p in captured["net"].parameters())
    assert _same(dict(captured["net"].state_dict()), captured["initial"])


def test_validation_state_point_adds_nothing_to_the_gradient(
        lj_registry, monkeypatch):
    """A val state point runs its epoch without backward: the update sees
    the training gradient alone, bit for bit, and the loss is the
    training one."""
    seen = []
    real = fit_rdf.FitUpdate.__call__

    def record(self, value=None, step_scale=1.0):
        seen.append([torch.zeros_like(p) if p.grad is None
                     else p.grad.clone() for p in self.params])
        return real(self, value, step_scale)

    monkeypatch.setattr(fit_rdf.FitUpdate, "__call__", record)
    alone, _ = _fit(lj_registry, n_epochs=1, n_sim=0)
    with_val, _ = _fit(lj_registry, n_epochs=1, n_sim=0, val=["ljval"])
    assert len(seen) == 2
    assert all(torch.equal(a, b) for a, b in zip(*seen))
    assert with_val["loss_log"] == alone["loss_log"]
    assert set(with_val["final"]) == {"ljtest", "ljval"}


@pytest.mark.parametrize("key,value", [
    ("pair_flag", True), ("tpair_flag", True), ("u_reg_weight", 0.1),
    ("share_prior_aux", True), ("mts_inner", 2),
    ("angle_flag", True), ("nbr_mode", "cells")])
def test_unported_branches_raise(lj_registry, key, value):
    with pytest.raises(NotImplementedError, match=key):
        fit_rdf.build_fit(ASSIGNMENTS, {**SYS_PARAMS, key: value},
                          registry=lj_registry, device="cpu")


def test_unported_registry_and_dtype_raise(lj_registry):
    stripe = {"stripe": {"rho": 0.1, "T": 0.5, "dim": 2}}
    with pytest.raises(NotImplementedError, match="2-D"):
        fit_rdf.get_system("stripe", 2, stripe)
    # bf16 and 'mixed' are ported (test_ported_branches_run); a dtype the
    # JAX package does not name still raises
    with pytest.raises(ValueError, match="compute_dtype"):
        fit_rdf.build_fit({**ASSIGNMENTS, "compute_dtype": "float16"},
                          SYS_PARAMS, registry=lj_registry, device="cpu")


@pytest.mark.parametrize("assignments,sys_params", [
    ({}, {"gnn_skin": 0.3, "topology_update_freq": 3}),
    ({"compute_dtype": "bf16"}, {}),
    ({"compute_dtype": "mixed"}, {}),
    ({}, {"nbr_mode": "topk"}),
    ({}, {"nbr_mode": "sparse"})],
    ids=["gnn_skin", "bf16", "mixed", "topk", "sparse"])
def test_ported_branches_run(lj_registry, captured, assignments, sys_params):
    """The branches that raised before the SchNet and GNN rest was ported
    now build and fit: one epoch gives a finite loss and moves the
    parameters, with the skin, the dtype and the neighbor mode in place."""
    out = fit_rdf.fit_rdf({**ASSIGNMENTS, **assignments},
                          {**SYS_PARAMS, "n_epochs": 1, "n_sim": 0,
                           **sys_params}, registry=lj_registry,
                          rng=np.random.default_rng(1), log=lambda m: None,
                          device="cpu")
    assert len(out["loss_log"]) == 1 and np.isfinite(out["loss_log"][0])
    moved = max((out["params"][k] - v).abs().max().item()
                for k, v in captured["initial"].items())
    assert moved > 0
    gnn = captured["sims"][0].integrator.model.models["nn"]
    assert gnn.skin == sys_params.get("gnn_skin", 0.0)
    assert gnn.nbr_mode == sys_params.get("nbr_mode", "table")
    assert gnn.gnn.compute_dtype == assignments.get("compute_dtype",
                                                    "float32")
    assert captured["sims"][0].integrator.topology_update_freq == \
        sys_params.get("topology_update_freq", 1)


def test_init_pkl_reads_numpy_only(tmp_path):
    """init_pkl reads dicts and numpy arrays and refuses any other class."""
    import pickle
    good, bad = tmp_path / "good.pkl", tmp_path / "bad.pkl"
    with open(good, "wb") as f:
        pickle.dump({"params": {"nn": {"a": np.arange(3.0)}}}, f)
    assert fit_rdf._load_init_pkl(good)["a"].tolist() == [0.0, 1.0, 2.0]
    with open(bad, "wb") as f:
        pickle.dump({"params": {"nn": {"a": pathlib.Path("x")}}}, f)
    with pytest.raises(pickle.UnpicklingError, match="pathlib"):
        fit_rdf._load_init_pkl(bad)


def test_run_water_torch_dry_run(tmp_path):
    """The script's --dry_run on the CPU (64 water sites, the 'low'
    SchNet, 2 epochs of 24 steps, one 100-step rollout) prints its
    objective; a flag of an unported branch fails."""
    script = str(REPO / "scripts" / "run_water_torch.py")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}   # as one_thread
    proc = subprocess.run(
        [sys.executable, script, "--dry_run", "-device", "cpu", "-logdir",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    objective = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("objective:")]
    assert len(objective) == 1
    assert np.isfinite(float(objective[0].split()[1]))
    assert "epoch 1 | loss" in proc.stdout
    proc = subprocess.run(
        [sys.executable, script, "--dry_run", "--pair", "-device", "cpu",
         "-logdir", str(tmp_path / "pair")], capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode != 0
    assert "NotImplementedError: pair_flag" in proc.stderr
