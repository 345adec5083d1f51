"""The last ported scripts (``scripts/run_si_torch.py``,
``si_transfer_torch.py``, ``run_stripe_torch.py``,
``validate_lj_best_torch.py``, ``run_hyperopt_torch.py``) against the
JAX scripts, and each script's ``--dry_run -device cpu``.

The configurations are held to the JAX scripts' own: each JAX script's
``main`` runs with its driver (``fit_rdf``, ``build_fit``, ``fit_lj``)
replaced by a stub that records what it was given, and the port's
script must hand its driver the same assignments and system parameters
(the port adds only ``ckpt_every`` to the a-Si fit, and ``device``).
``run_hyperopt_torch.py``'s sampling and successive-halving schedule
equal the JAX script's for the same seed: the same trials, assignments,
rung budgets and promotions, both driven by one deterministic stand-in
for the fit.  The dry runs run with one intra-op thread; the stripe
fit's dry run is in ``tests/test_torch_stripe.py``.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    path = os.path.join(REPO, "scripts", name)
    spec = importlib.util.spec_from_file_location(f"_s_{name[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Captured(Exception):
    pass


def _jax_call(monkeypatch, script, module, attr, argv, stop=False):
    """Run the JAX ``script``'s ``main`` with ``module.attr`` replaced by
    a recorder; returns the (args, kwargs) it was called with."""
    import importlib
    mod = importlib.import_module(module)
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        if stop:
            raise _Captured
        return {"objective": 0.0}
    monkeypatch.setattr(mod, attr, record)
    monkeypatch.setattr(sys, "argv", [script, *argv])
    try:
        load_script(script).main()
    except _Captured:
        pass
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("argv", [[], ["--dry_run"],
                                  ["-rdf_backend", "pallas", "-nbins", "800",
                                   "--no_anneal", "--reset_opt"]])
def test_run_si_config_matches_jax(monkeypatch, argv):
    (a, s), kw = _jax_call(monkeypatch, "run_si.py",
                           "mdgrad_tpu.train.fit_rdf", "fit_rdf", argv)
    port = load_script("run_si_torch.py")
    assert port.fit_config(port.parse_args(argv)) == (a, s)


@pytest.mark.parametrize("argv", [[], ["--dry_run"]])
def test_si_transfer_config_matches_jax(monkeypatch, argv):
    (a, s), kw = _jax_call(monkeypatch, "si_transfer.py",
                           "mdgrad_tpu.train.fit_rdf", "build_fit", argv,
                           stop=True)
    port = load_script("si_transfer_torch.py")
    a_t, s_t = port.transfer_config(port.parse_args(argv))
    assert s_t.pop("nhc_tau") == pytest.approx(s.pop("nhc_tau"), rel=1e-12)
    assert (a_t, s_t) == (a, s)


@pytest.mark.parametrize("argv", [[], ["--dry_run"]])
def test_run_stripe_config_matches_jax(monkeypatch, argv):
    (a, s), kw = _jax_call(monkeypatch, "run_stripe.py",
                           "mdgrad_tpu.train.fit_rdf_pair", "fit_lj", argv)
    port = load_script("run_stripe_torch.py")
    assert port.fit_config(port.parse_args(argv)) == (a, s)


def test_run_si_then_si_transfer_dry_run(tmp_path, monkeypatch):
    """The a-Si fit's dry run (64 sites, 2 epochs), its configuration
    set to write a checkpoint each epoch (the fit driver's default is
    every 10th); the transfer's dry run loads the last and samples its
    RDF; a JAX ``.pkl`` checkpoint loads into the same SchNet."""
    si = load_script("run_si_torch.py")
    config = si.fit_config

    def every_epoch(args):
        assignments, sys_params = config(args)
        return assignments, {**sys_params, "ckpt_every": 1}

    monkeypatch.setattr(si, "fit_config", every_epoch)
    out = si.main(["--dry_run", "-device", "cpu", "-logdir",
                   str(tmp_path / "si")], log=lambda m: None)
    assert np.isfinite(out["objective"]) and len(out["loss_log"]) == 2
    ckpt = tmp_path / "si" / "0" / "fit-ckpt-1.pt"
    assert ckpt.exists()
    transfer = load_script("si_transfer_torch.py")
    res = transfer.main(["--dry_run", "-device", "cpu", "-ckpt", str(ckpt),
                         "-logdir", str(tmp_path / "4k")],
                        log=lambda m: None)
    assert res["n_atoms"] == 64 and res["frames"] == 2 * 25
    assert tuple(res["last_frames"].shape) == (25, 64, 3)
    assert np.isfinite(res["mse"])
    blob = json.loads((tmp_path / "4k" / "transfer.json").read_text())
    assert blob["mse"] == res["mse"] and blob["nbr_mode"] == "table"
    # the checkpoint's weights are the SchNet's
    net = res["sim"].integrator.model.models["nn"].gnn
    saved = torch.load(ckpt, weights_only=True)["params"]
    assert all(torch.equal(v, saved[k]) for k, v in net.state_dict().items())
    # a JAX fit checkpoint (.pkl) loads its params['nn'] into the SchNet
    from mdgrad_tpu_torch.nn.convert import schnet_params_from_numpy
    from mdgrad_tpu_torch.train.checkpoint import (load_schnet_checkpoint,
                                                   read_jax_pickle)
    pkl = os.path.join(REPO, "results", "si_r2", "0", "fit-ckpt-5699.pkl")
    assert load_schnet_checkpoint(net, pkl) == 5699
    ref = schnet_params_from_numpy(read_jax_pickle(pkl)["params"]["nn"])
    assert all(torch.equal(v, ref[k]) for k, v in net.state_dict().items())


def test_validate_lj_best_dry_run(tmp_path):
    """The dry run scores the JAX run's ``best.pkl`` (read through
    ``read_jax_pickle``) and the pretraining control on the first state
    point, and writes ``validation.json`` where it is told."""
    lines = []
    out, scores = load_script("validate_lj_best_torch.py").main(
        ["--dry_run", "-device", "cpu", "-outdir", str(tmp_path)],
        log=lines.append)
    assert set(out) == {"best.pkl", "pretrain"}
    for res in out.values():
        assert len(res["states"]) == 1
        assert res["states"][0]["tag"] == "lj_0.845_0.75"
        assert np.isfinite(res["total_rdf_mse"]) and np.isfinite(
            res["total_P_err"]) and res["depth"] < 0
    assert json.loads((tmp_path / "validation.json").read_text()).keys() \
        == out.keys()
    assert lines[-1] == f"winner: {min(scores, key=scores.get)}"


@pytest.mark.parametrize("pair", [False, True])
def test_hyperopt_sampling_matches_jax(pair):
    jax_s, port = load_script("run_hyperopt.py"), load_script(
        "run_hyperopt_torch.py")
    space_j = jax_s.PAIR_SPACE if pair else jax_s.GNN_SPACE
    space = port.PAIR_SPACE if pair else port.GNN_SPACE
    assert space == space_j
    rng_j, rng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(25):
        assert port.sample(space, rng) == jax_s.sample(space_j, rng_j)


@pytest.mark.parametrize("algo,n_trials,eta", [("sha", 9, 3),
                                               ("sha", 8, 2),
                                               ("random", 4, 3)])
def test_hyperopt_schedule_matches_jax(tmp_path, algo, n_trials, eta):
    """Both scripts' search loops, driven by one stand-in fit whose
    objective is a function of the assignments and the epoch budget:
    the same trials, rungs, budgets and promotions, and the same rows in
    ``results.json``."""
    import argparse

    def fake_fit(assignments, sys_params, model_path=None, registry=None,
                 log=None):
        x = sum(float(v) for v in assignments.values()
                if isinstance(v, (int, float)))
        n = sys_params["n_epochs"]
        return {"objective": (x % 1.0) / n, "loss_log": [0.0] * n}

    out = {}
    for name in ("run_hyperopt.py", "run_hyperopt_torch.py"):
        mod = load_script(name)
        logdir = tmp_path / name
        logdir.mkdir()
        args = argparse.Namespace(
            logdir=str(logdir), data=["H20_298K_redd"], n_trials=n_trials,
            nepochs=27, algo=algo, eta=eta, pair=False, dry_run=False,
            dt=0.5, seed=3)
        run = mod.run_random if algo == "random" else mod.run_sha
        rows = run(args, mod.GNN_SPACE, np.random.default_rng(3), {},
                   fake_fit)
        out[name] = (rows, json.loads((logdir / "results.json").read_text()))
    (rows_j, res_j), (rows, res) = out.values()
    assert rows == rows_j and res == res_j
    if algo == "sha":
        assert len(res["rungs"]) > 1
        assert [len(r) for r in res["rungs"]] == [len(r) for r in
                                                   res_j["rungs"]]


def test_run_hyperopt_dry_run(tmp_path):
    """Successive halving over 3 configurations at the dry run's budget
    of 4 epochs (rungs of 2 and 4): the best resumes from its checkpoint
    to 4 epochs."""
    pool = load_script("run_hyperopt_torch.py").main(
        ["--dry_run", "-device", "cpu", "-n_trials", "3", "-logdir",
         str(tmp_path)])
    assert len(pool) == 1 and pool[0]["epochs"] == 4
    assert np.isfinite(pool[0]["objective"])
    res = json.loads((tmp_path / "results.json").read_text())
    assert [len(r) for r in res["rungs"]] == [3, 1]
    assert res["epochs_spent"] == 3 * 2 + 2
