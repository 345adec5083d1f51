"""The deliberate deviations of the port's multi-state fitting driver
from the JAX one (ROADMAP Queue 3), one test each: the EMA frozen while
dt-backoff halves dt, the half-dt hold restarted on every backtrack, the
snapshot ring sized from ``max_backtracks`` with an empty ring logged,
and ``-backtrack_after`` in ``scripts/run_water_multi_torch.py`` (with the
script's ``--dry_run -device cpu``).  The registry and helpers are
tests/test_torch_fit_multi.py's."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from test_torch_fit_multi import _fit, _gate, one_thread, registry  # noqa

REPO = pathlib.Path(__file__).resolve().parents[1]


def _ema_best(losses, alpha=0.6):
    ema, best = None, np.inf
    for v in losses:
        ema = v if ema is None else alpha * ema + (1 - alpha) * v
        best = min(best, ema)
    return best


def test_deviation_ema_frozen_under_dt_backoff(registry, monkeypatch):
    """Deviation 1 (the JAX EMA also takes the half-dt losses): a
    backtrack at epoch 1 halves dt for epochs 1-2; the best EMA is that of
    the full-dt epochs 0, 3 and 4 alone."""
    _gate(monkeypatch, {2, 3})
    out, logs = _fit(registry, n_epochs=5, backtrack_every=1,
                     dt_backoff=True, dt_hold=2)
    assert "epoch 1: dt-backoff engaged" in logs
    assert "epoch 2: dt-backoff released" in logs
    losses = out["loss_log"]
    assert len(losses) == 5
    full = [losses[0], losses[3], losses[4]]
    assert out["best_ema_loss"] == pytest.approx(_ema_best(full), rel=1e-12)
    assert out["best_epoch"] in (0, 3, 4)


def test_deviation_dt_hold_restarts_on_every_backtrack(registry,
                                                       monkeypatch):
    """Deviation 2 (JAX restarts the hold only when dt was full): a second
    backtrack at epoch 2, while dt is already halved, restarts the
    two-epoch hold, so full dt returns at epoch 3, not 2."""
    _gate(monkeypatch, {2, 3, 5, 6})
    out, logs = _fit(registry, n_epochs=5, backtrack_every=1,
                     dt_backoff=True, dt_hold=2)
    assert logs.count("BACKTRACK") == 2
    assert "epoch 2: dt-backoff hold restarted" in logs
    assert "epoch 3: dt-backoff released" in logs
    assert "epoch 2: dt-backoff released" not in logs
    assert len(out["loss_log"]) == 5


def test_deviation_snapshot_ring_from_max_backtracks(registry, monkeypatch):
    """Deviation 3 (JAX keeps 3 snapshots): after 4 clean epochs every
    epoch fails; all 4 snapshots are backtracked to (max_backtracks 5),
    then the empty ring is logged and the fit bails out and salvages."""
    _gate(monkeypatch, lambda n: n > 4)
    out, logs = _fit(registry, n_epochs=10, backtrack_every=1,
                     max_backtracks=5)
    assert logs.count("BACKTRACK") == 4
    for e in (3, 2, 1, 0):
        assert f"BACKTRACK to the epoch-{e} snapshot" in logs
    assert "backtrack skipped -- the snapshot ring is empty" in logs
    assert out.get("nan_bailout") is True


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "run_water_multi_torch", REPO / "scripts" / "run_water_multi_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_deviation_script_backtrack_after_and_dry_run(tmp_path):
    """Deviation 4 (the JAX script has no -backtrack_after): the flag
    reaches sys_params; then the script's --dry_run on the CPU (two state
    points of 64 water sites, the 'low' SchNet, 2 epochs of 24 steps)
    prints a finite objective."""
    assignments, sys_params, args = _load_script().build(
        ["-backtrack_after", "3", "--tpair"])
    assert sys_params["backtrack_after"] == 3 and sys_params["tpair_flag"]
    assert assignments["opt_freq"] == 192 and args.device == "cuda"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "run_water_multi_torch.py"),
         "--dry_run", "-device", "cpu", "-logdir", str(tmp_path), "-data",
         "H20_298K_redd", "H20_338K_redd"], capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    objective = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("objective:")]
    assert len(objective) == 1 and np.isfinite(float(objective[0].split()[1]))
