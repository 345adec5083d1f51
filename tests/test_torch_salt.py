"""The port's molten-salt charge fit (``train/fit_salt.py``) against the JAX
package's at tests/test_salt.py's tiny size (64 ions, a = 6.0 A, 2500 K).

Both sides run in float64 (the JAX side inside ``jax.enable_x64(True)``)
and draw the same velocities from the same numpy seed.  Two JAX details
are lifted to float64 for the comparison, as the port computes them at
the run's dtype: its ``ScaledChargeEwald`` inverts its float32 cell in
float32 and keeps ``qscale`` (and so Adam's state) in float32; the test
subclass widens both.  Its RDFs spread their Gaussian centres to the
float64 last bin edge in x64, the port's to the float32 one; the test
subclass takes the float32 one.  The JAX functions' ``Simulation`` is
wrapped to record each simulation's initial parameters, the port's to
load them (``nn/convert.py``), so the frozen core's constants match too.
Each JAX run happens once, in a module-scoped fixture.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu.nn.layers import GaussianSmearing as GaussianSmearingJ
from mdgrad_tpu.train import fit_salt as fs_j
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy
from mdgrad_tpu_torch.train import fit_salt as fs

TINY = dict(n_cells=2, a=6.0, T_kelvin=2500.0)
FIT = dict(n_cells=2, a=6.0, q_true=0.8, q0=0.5, n_epochs=2, tau=20,
           target_nsim=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _WideEwald(fs_j.ScaledChargeEwald):
    """The JAX module's class with its cell and ``qscale`` in float64."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.cell0 = jnp.asarray(self.cell0, jnp.float64)

    def init_params(self):
        return {"qscale": jnp.asarray(np.float32(self.qscale0),
                                      jnp.float64)}


class _Rdf(fs_j.rdf_obs_cls):
    """The JAX rdf with its Gaussian centres spread to the float32 last
    bin edge, as the JAX package does without x64 and the port always
    does (tests/test_torch_lj.py's ``_rdf_j``)."""

    def __init__(self, system, nbins, r_range, **kw):
        super().__init__(system, nbins, r_range, **kw)
        self.smear = GaussianSmearingJ(r_range[0],
                                       float(np.float32(self.bins[-1])),
                                       nbins)


def _run_jax(fn, *args, **kwargs):
    """``fn`` of the JAX module in float64 with ``_WideEwald`` and
    ``_Rdf``; returns its result and the initial parameters of each
    simulation it built."""
    trees = []

    class Recorder(fs_j.Simulation):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trees.append(jax.tree_util.tree_map(np.asarray, self.params))

    mp = pytest.MonkeyPatch()
    mp.setattr(fs_j, "ScaledChargeEwald", _WideEwald)
    mp.setattr(fs_j, "rdf_obs_cls", _Rdf)
    mp.setattr(fs_j, "Simulation", Recorder)
    try:
        with jax.enable_x64(True):
            out = fn(*args, **kwargs)
    finally:
        mp.undo()
    return out, trees


def _loading(monkeypatch, trees):
    """Make the port's fit_salt load ``trees`` into its simulations."""
    trees = list(trees)

    class Loader(mt.Simulation):
        def __init__(self, system, integ, **kw):
            integ.model.load_state_dict(
                stack_params_from_numpy(trees.pop(0), integ.model))
            super().__init__(system, integ, **kw)

    monkeypatch.setattr(fs, "Simulation", Loader)


@pytest.fixture(scope="module")
def jax_targets():
    """tests/test_salt.py's ``tiny`` fixture: q_true 0.9, 2 burn-in and 4
    sampling epochs of 40 steps."""
    system = fs_j.rocksalt_melt(rng=np.random.default_rng(3), **TINY)
    return _run_jax(fs_j.generate_targets, system, q_true=0.9, n_sim=4,
                    steps=40, burn=2, log=lambda *a: None)


@pytest.fixture(scope="module")
def jax_fit():
    return _run_jax(fs_j.fit_salt, log=lambda *a: None,
                    rng=np.random.default_rng(5), **FIT)


def test_rocksalt_melt_equals_jax():
    """Positions, species, cell and velocities equal the JAX package's."""
    a = fs.rocksalt_melt(rng=np.random.default_rng(3), **TINY)
    b = fs_j.rocksalt_melt(rng=np.random.default_rng(3), **TINY)
    assert a.get_number_of_atoms() == 64
    for get in ("get_positions", "get_cell", "get_velocities",
                "get_atomic_numbers", "get_masses"):
        np.testing.assert_array_equal(getattr(a, get)(), getattr(b, get)())


def test_generate_targets_match_jax_f64(jax_targets, monkeypatch):
    """The like and unlike g(r) (rtol 1e-9 of their peak) and the last
    state's q and v (atol 1e-9) after 240 steps; the unlike pairs pile up
    at contact (tests/test_salt.py's charge-ordering check)."""
    (g_l_j, g_u_j, state_j), trees = jax_targets
    _loading(monkeypatch, trees)
    system = fs.rocksalt_melt(rng=np.random.default_rng(3), **TINY)
    g_l, g_u, state = fs.generate_targets(
        system, q_true=0.9, n_sim=4, steps=40, burn=2, log=lambda *a: None,
        device="cpu", dtype=torch.float64)
    for got, ref in ((g_l, g_l_j), (g_u, g_u_j)):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-9 * np.abs(ref).max())
    for k in ("q", "v"):
        np.testing.assert_allclose(getattr(state, k).numpy(),
                                   np.asarray(getattr(state_j, k)), rtol=0,
                                   atol=1e-9)
    i = int(np.argmax(g_u))
    assert g_u[i] > 1.5 * max(g_l[i], 0.1)


def test_fit_salt_matches_jax_f64(jax_fit, monkeypatch, tmp_path):
    """Two epochs at tau 20 after 6 + 2 target epochs: each epoch's loss,
    ``qscale`` and EMA loss (rtol 1e-8), ``q_final``, ``q_best`` and
    ``best_epoch`` (None before the 10 warm-up epochs, as JAX's) equal
    JAX's; the gradient moved ``qscale``; result.json holds the result."""
    res_j, trees = jax_fit
    _loading(monkeypatch, trees)
    res = fs.fit_salt(model_path=str(tmp_path), log=lambda *a: None,
                      rng=np.random.default_rng(5), device="cpu",
                      dtype=torch.float64, **FIT)
    assert len(res["history"]) == len(res_j["history"]) == 2
    for h, h_j in zip(res["history"], res_j["history"]):
        assert h["epoch"] == h_j["epoch"]
        for k in ("loss", "qscale", "ema_loss"):
            np.testing.assert_allclose(h[k], h_j[k], rtol=1e-8, err_msg=k)
    for k in ("q_final", "q_best", "loss_final"):
        np.testing.assert_allclose(res[k], res_j[k], rtol=1e-8, err_msg=k)
    assert res["best_epoch"] is None and res_j["best_epoch"] is None
    assert res["history"][0]["qscale"] != pytest.approx(0.5, abs=1e-4)
    with open(tmp_path / "result.json") as f:
        assert json.load(f)["q_best"] == res["q_best"]


def test_run_salt_torch_dry_run(tmp_path):
    """``scripts/run_salt_torch.py --dry_run -device cpu``: 3 epochs on
    the 64-ion box, a finite final qscale and result.json."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(repo / "scripts" / "run_salt_torch.py"),
         "--dry_run", "-device", "cpu", "-logdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "final qscale" in proc.stdout
    out = json.loads((tmp_path / "result.json").read_text())
    assert len(out["history"]) == 3 and np.isfinite(out["q_final"])
