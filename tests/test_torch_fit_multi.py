"""The port's multi-state fitting driver (train/fit_rdf_multi.py): the nine
multistate tests of tests/test_fit.py (smoke, NaN recovery, depth guard,
backtrack, backtrack on scale erosion, bailout salvage, live best
selection, overflow regrow, inference divergence guard) on a synthetic
two-state LJ registry whose target the port simulates
(tests/test_torch_fit_multi_deviations.py holds the deliberate deviations
from the JAX driver and the script)."""

import os
import re

import numpy as np
import pytest
import torch

import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import units
from mdgrad_tpu_torch.train import fit_rdf
from mdgrad_tpu_torch.train import fit_rdf_multi as frm

ASSIGNMENTS = {
    "cutoff": 2.5, "nbins": 48, "opt_freq": 11, "lr": 1e-3,
    "epsilon": 0.4, "sigma": 0.9, "gaussian_width": 0.25,
    "n_atom_basis": "tiny", "n_filters": "tiny", "n_convolutions": 2,
}
SYS_PARAMS = {
    "size": 2, "dt": 0.005, "n_epochs": 2, "n_sim": 1,
    "data": ["ljtest", "ljtest2"], "pair_flag": False, "frame_skip": 5,
    "test_nbins": 64,
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """tests/test_fit.py's synthetic LJ target (32 atoms, reduced units)
    simulated by the port, and a second, hotter and less dense state
    point on the same target file."""
    tmp = tmp_path_factory.mktemp("targets")
    entry = {"rho": 0.845, "T": 1.2, "start": 0.75, "end": 2.5,
             "element": "H", "mass": 1.0, "N_unitcell": 4, "cell": "fcc",
             "reduced_units": True}
    reg = {"ljtest": entry}
    s = fit_rdf.get_system("ljtest", 2, reg, rng=np.random.default_rng(0))
    pair = mt.PairPotentials(s, mt.potentials.LennardJones(1.0, 1.0),
                             cutoff=1.6, device="cpu")
    integ = mt.NoseHooverChain(pair, s, T=1.2, num_chains=3, Q=30.0,
                               adjoint=False, device="cpu")
    sim = mt.Simulation(s, integ)
    obs = mt.observables.rdf(s, nbins=64, r_range=(0.75, 2.5), device="cpu")
    gs = [obs(sim.simulate(steps=40, dt=0.005, frequency=40).q[::5])[2]
          .numpy() for _ in range(4)]
    fn = os.path.join(str(tmp), "rdf_target.csv")
    np.savetxt(fn, np.vstack([obs.r_axis, np.mean(gs, axis=0)]),
               delimiter=",")
    entry["fn"] = fn
    e2 = dict(entry, T=1.4, rho=0.80)
    return {"ljtest": entry, "ljtest2": e2}


def _fit(registry, assignments=None, model_path=None, **sys_params):
    logs = []
    out = frm.fit_rdf_multistate({**ASSIGNMENTS, **(assignments or {})},
                                 {**SYS_PARAMS, **sys_params},
                                 model_path=model_path, registry=registry,
                                 rng=np.random.default_rng(1),
                                 log=logs.append, device="cpu")
    return out, "\n".join(str(m) for m in logs)


def _gate(monkeypatch, fails):
    """Make ``_states_finite`` report the calls in ``fails`` (1-based, or
    a predicate of the call number) as non-finite."""
    real = frm._states_finite
    calls = {"n": 0}

    def gate(finals):
        calls["n"] += 1
        bad = fails(calls["n"]) if callable(fails) else calls["n"] in fails
        return False if bad else real(finals)

    monkeypatch.setattr(frm, "_states_finite", gate)
    return calls


def test_fit_rdf_multistate_gnn_smoke(registry, tmp_path):
    out, logs = _fit(registry, model_path=str(tmp_path))
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 2 and np.isfinite(out["loss_log"]).all()
    assert np.isfinite(out["objective"])
    assert set(out["final"]) == {"ljtest", "ljtest2"}
    assert len(out["js_log"][0]) == 2
    assert "epoch 1 | loss" in logs and "per-state" in logs
    for name in ("assignments.json", "loss.csv", "rdf_ljtest.csv",
                 "rdf_ljtest2.csv"):
        assert (tmp_path / name).exists(), name


def test_fit_rdf_multistate_nan_recovery(registry, monkeypatch):
    """A transient non-finite epoch restores the last good snapshot,
    halves the step scale and continues."""
    _gate(monkeypatch, {1})
    out, logs = _fit(registry)
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 2
    assert "restored last-good + rethermalized" in logs
    assert set(out["final"]) == {"ljtest", "ljtest2"}


def test_fit_rdf_multistate_depth_guard(registry):
    """With a floor shallower than the pretrained well (u_floor_mult 0.5)
    and a large weight, the T-dependent pair MLP's well rises."""
    assignments = {"lr": 3e-3, "power": 12, "gaussian_width": 0.1,
                   "n_width": 32, "n_layers": 1, "nonlinear": "SELU"}
    out, logs = _fit(registry, assignments, n_epochs=3, pair_flag=False,
                     tpair_flag=True, pretrain_iters=60,
                     u_reg_weight=200.0, u_floor_mult=0.5)
    assert not out.get("nan_bailout", False)
    assert "depth guard" in logs
    net, prior = fit_rdf._build_net_and_prior(
        {**ASSIGNMENTS, **assignments}, {"tpair_flag": True}, device="cpu")
    net.load_state_dict(out["params"])
    r = torch.linspace(0.8, 2.5, 200)[:, None]
    kT = torch.tensor(registry["ljtest"]["T"] * units.kB)
    with torch.no_grad():
        d_final = (net(r, kT).squeeze(-1) + prior(r).squeeze(-1)).min().item()
    m = re.search(r"pretrained depths \[([^\]]+)\]", logs)
    assert m is not None
    assert d_final > min(float(v) for v in m.group(1).split()) + 1e-3


def test_fit_rdf_multistate_backtrack_recovery(registry, monkeypatch):
    """Two failures at epoch 1 revert to the epoch-0 snapshot; dt-backoff
    engages there and releases after dt_hold clean epochs; the cosine
    schedule runs; all epochs complete."""
    _gate(monkeypatch, {2, 3})
    out, logs = _fit(registry, n_epochs=3, backtrack_every=1,
                     backtrack_after=2, lr_schedule="cosine",
                     dt_backoff=True, dt_hold=1)
    assert "BACKTRACK to the epoch-0 snapshot" in logs
    assert "dt-backoff engaged" in logs and "dt-backoff released" in logs
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 3
    assert np.isfinite(out["objective"])


def test_fit_rdf_multistate_backtrack_on_scale_erosion(registry,
                                                       monkeypatch):
    """Failures on every other epoch never reach backtrack_after, but the
    step scale erodes below 0.1 and the erosion trigger backtracks."""
    _gate(monkeypatch, lambda n: n > 1 and n % 2 == 0)
    out, logs = _fit(registry, n_epochs=6, backtrack_every=1,
                     backtrack_after=99)
    assert "BACKTRACK" in logs
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 6
    assert np.isfinite(out["objective"])


def test_fit_rdf_multistate_bailout_salvage(registry, monkeypatch):
    """A persistent non-finite epoch exhausts the step scale, then the
    inference runs from the last good snapshot."""
    monkeypatch.setattr(frm, "_states_finite", lambda finals: False)
    out, logs = _fit(registry)
    assert out.get("nan_bailout") is True and out["bailout_epoch"] == 0
    assert set(out["final"]) == {"ljtest", "ljtest2"}
    assert np.isfinite(out["objective"])
    assert "salvaging inference from last-good" in logs


def test_fit_rdf_multistate_live_best_selection(registry, tmp_path):
    """The inference runs from the EMA-selected best iterate, and best.pt
    is written as the EMA makes new lows."""
    out, logs = _fit(registry, model_path=str(tmp_path), n_epochs=3,
                     ckpt_every=100)
    assert not out.get("nan_bailout", False)
    assert "LIVE-selected best iterate" in logs
    assert (tmp_path / "best.pt").exists()
    assert out["selected"] == "best" and out["best_epoch"] >= 0


def test_fit_rdf_multistate_overflow_regrow(registry):
    """A shared table far below the neighbor count overflows at epoch 0;
    the capacity grows, the entry is restored and the epoch retried."""
    out, logs = _fit(registry, capacity_slack=0.05, overflow_policy="regrow",
                     regrow_factor=8.0)
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 2 and np.isfinite(out["objective"])
    assert "neighbor capacity overflow" in logs
    assert "shared neighbor capacity grown" in logs
    assert "unrecoverable" not in logs


def test_fit_rdf_multistate_inference_divergence_guard(registry, monkeypatch,
                                                       tmp_path):
    """Inference whose rollouts all diverge on a held-out state: the tag
    gets a NaN MSE, its equilibration is retried, the best iterate falls
    back to the final one (which diverges too), the training tag keeps
    its finite entry frame, and every CSV is written."""
    real_sim = frm.Simulation

    class PoisonedSim(real_sim):
        def simulate(self, *a, **kw):
            traj = real_sim.simulate(self, *a, **kw)
            self.state = self.state._replace(
                q=torch.full_like(self.state.q, float("nan")))
            return traj._replace(q=torch.full_like(traj.q, float("nan")))

    monkeypatch.setattr(frm, "Simulation", PoisonedSim)
    out, logs = _fit(registry, model_path=str(tmp_path), data=["ljtest"],
                     val=["ljtest2"])
    assert "NO finite frames for ljtest2" in logs
    assert np.isnan(out["val_mse"]["ljtest2"])
    assert np.isnan(out["final"]["ljtest2"]["mse"])
    assert "held-out equilibration diverged for ljtest2" in logs
    assert "falling back to the final-epoch iterate" in logs
    assert "also diverged at inference" in logs
    assert np.isfinite(out["final"]["ljtest"]["mse"])
    assert (tmp_path / "rdf_ljtest2.csv").exists()
    assert (tmp_path / "rdf_ljtest.csv").exists()
