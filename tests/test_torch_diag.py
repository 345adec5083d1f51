"""The three ported diagnostics against their JAX twins:
``scripts/diag_si4k_torch.py`` (the trained a-Si SchNet's melt, chunk by
chunk), ``diag_lj_stability_torch.py`` (a saved LJ candidate's stability
at each state point) and ``analyze_stripe_torch.py`` (where the stripe
fit's g(r) leaves its potential undetermined).

The MD comparisons run in float64 on both sides, the JAX side inside
``jax.enable_x64(True)`` with its SchNet's ``compute_dtype`` float64, its
Gaussian constants widened and its parameters widened from the same
float32 values the port holds; each JAX SchNet convolution's output stays
float32 (``mdgrad_tpu/nn/schnet.py``), which bounds the a-Si agreement at
~1e-8 relative a force.  The JAX loops are the JAX scripts' own
(``scripts/diag_si4k.py:79-110``, ``scripts/diag_lj_stability.py:
78-116``) on the same configuration.  The a-Si diagnostic runs at size 2
(64 sites) on the ``'table'`` path: a 10.86 A box holds 2 cells of the
5.0 A cutoff a side, and the cell list needs 3.
"""

import importlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdgrad_tpu.nn.schnet as schnet_j
from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import thermo as thermo_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.data.registry import exp_rdf_data_dict as registry_j
from mdgrad_tpu.data.registry import pair_data_dict as pair_data_dict_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.interface import Stack as StackJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.md import rethermalize as rethermalize_j
from mdgrad_tpu.nn import PairMLP as PairMLPJ
from mdgrad_tpu_torch.train.checkpoint import jax_params, read_jax_pickle

fit_rdf_j = importlib.import_module("mdgrad_tpu.train.fit_rdf")
fit_rdf_pair_j = importlib.import_module("mdgrad_tpu.train.fit_rdf_pair")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SI_CKPT = os.path.join(REPO, "results", "si_r2", "0", "fit-ckpt-5699.pkl")
LJ_BEST = os.path.join(REPO, "results", "lj_multi_r3g", "0",
                       "best_eval.pkl")
STRIPE_RUN = os.path.join(REPO, "results", "stripe_r3", "0")
STRIPE_TAG = "overlap_0.9766_T0.07_cut12"


def load_script(name):
    path = os.path.join(REPO, "scripts", name)
    spec = importlib.util.spec_from_file_location(f"_d_{name[:-3]}", path)
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


def _f64(tree):
    """A numpy tree widened to float64 (its float32 values exactly)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64), tree)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("argv", [[], ["-size", "2", "-nbr_mode", "table",
                                       "-nhc_tau", "0", "-start_T", "900"]])
def test_diag_si4k_config_matches_jax(monkeypatch, argv):
    """The port's configuration is the JAX script's: its ``main`` runs
    with ``build_fit`` replaced by a recorder, and the port's
    ``diag_config`` must give the same assignments and system
    parameters."""
    calls = []

    def record(*a, **kw):
        calls.append(a)
        raise _Captured
    monkeypatch.setattr(fit_rdf_j, "build_fit", record)
    monkeypatch.setattr(sys, "argv", ["diag_si4k.py", *argv])
    with pytest.raises(_Captured):
        load_script("diag_si4k.py").main()
    (a, s), = [c[:2] for c in calls]
    port = load_script("diag_si4k_torch.py")
    a_t, s_t = port.diag_config(port.parse_args(argv))
    if "nhc_tau" in s:
        assert s_t.pop("nhc_tau") == pytest.approx(s.pop("nhc_tau"),
                                                   rel=1e-12)
    assert (a_t, s_t) == (a, s)
    assert port.parse_args([]).ckpt == "results/si_r2/0/fit-ckpt-5699.pkl"


def _si_jax_loop(argv, port):
    """``scripts/diag_si4k.py``'s loop in float64 on the port's
    configuration: (T_kin, max|f|, max|v|, pv) a chunk."""
    args = port.parse_args(argv)
    assignments, sys_params = port.diag_config(args)
    assignments["compute_dtype"] = jnp.float64
    rng = np.random.default_rng(0)
    built = fit_rdf_j.build_fit(assignments, sys_params,
                                registry=registry_j, rng=rng)
    system, sim = built["systems"][0], built["sims"][0]
    masses = system.get_masses()
    sim.params = _f64(read_jax_pickle(SI_CKPT)["params"])
    dt = sys_params["dt"] * units_j.fs
    sim.integrator.update_T(args.start_T)
    system.set_temperature(args.start_T, rng=rng)
    out = []
    for _ in range(args.nchunks):
        sim.simulate(steps=args.chunk, dt=dt, frequency=args.chunk)
        v = np.asarray(sim.state.v)
        assert v.dtype == np.float64
        out.append((float(thermo_j.temperature(jnp.asarray(v), masses,
                                               dim=3)) / units_j.kB,
                    float(np.abs(np.asarray(sim.state.f)).max()),
                    float(np.abs(v).max()), np.asarray(sim.state.pv)))
    return out


def test_diag_si4k_matches_the_jax_loop_f64(monkeypatch):
    """2 chunks of 5 steps of the 64-site melt from the trained model at
    1500 K, hot start, tau 50 dt: each chunk's T_kin (to 1e-7 of it),
    max|f| and max|v| (to 1e-6), the bath momenta (to 1e-6 of the
    largest) equal the JAX loop's; every record finite, no overflow."""
    orig = schnet_j.gaussian_smearing
    monkeypatch.setattr(
        schnet_j, "gaussian_smearing",
        lambda d, o, w, centered=False: orig(d, o.astype(d.dtype),
                                             w.astype(d.dtype), centered))
    port = load_script("diag_si4k_torch.py")
    argv = ["-size", "2", "-nbr_mode", "table", "-nchunks", "2", "-chunk",
            "5", "-ckpt", SI_CKPT, "-device", "cpu"]
    lines = []
    recs = port.main(argv, log=lines.append, dtype=torch.float64)
    with jax.enable_x64(True):
        ref = _si_jax_loop(argv, port)
    assert len(recs) == 2 and lines[1].startswith("64 atoms; Q = ")
    assert lines[2].startswith("chunk   0 (step    5): T_kin")
    for rec, (T, fmax, vmax, pv) in zip(recs, ref):
        assert rec["finite"] and not rec["overflow"] and not rec["bad_atoms"]
        assert rec["T_kin"] == pytest.approx(T, rel=1e-7)
        assert rec["max_f"] == pytest.approx(fmax, rel=1e-6)
        assert rec["max_v"] == pytest.approx(vmax, rel=1e-6)
        np.testing.assert_allclose(rec["pv"], pv, rtol=0,
                                   atol=1e-6 * np.abs(pv).max())
    assert 1000.0 < recs[-1]["T_kin"] < 2000.0


def _lj_jax_loop(tag, size, steps, chunk, seed):
    """``scripts/diag_lj_stability.py``'s loop for one state point and
    seed in float64; returns the last positions."""
    entry = pair_data_dict_j[tag]
    net = PairMLPJ(n_gauss=int(2.5 // 0.1), r_start=0.0, r_end=2.5,
                   n_width=128, n_layers=3, nonlinear="SELU")
    prior = potentials_j.LJFamily(epsilon=2.0, sigma=0.9, rep_pow=6,
                                  attr_pow=3)
    rng = np.random.default_rng(seed)
    system = fit_rdf_pair_j.get_system(tag, size, pair_data_dict_j, rng=rng)
    stack = StackJ({
        "pairnn": PairPotentialsJ(system, net, cutoff=2.5, mode="table",
                                  capacity_slack=2.5),
        "pair": PairPotentialsJ(system, prior, cutoff=2.5)})
    T = fit_rdf_pair_j.registry_T_kelvin(entry)
    integ = NoseHooverChainJ(stack, system, T=T, Q=50.0, num_chains=5,
                             adjoint=False)
    sim = SimulationJ(system, integ)
    params = dict(sim.params)
    params["pairnn"] = _f64(jax_params(LJ_BEST, "pairnn"))
    params["pair"] = _f64(params["pair"])
    sim.params = params
    st, aux = sim.initial_state()
    sim.state = rethermalize_j(st, T * units_j.kB, system.get_masses(),
                               rng=rng, dim=system.dim)
    sim.aux = aux
    for _ in range(0, steps, chunk):
        sim.simulate(steps=chunk, dt=entry.get("dt", 0.01), frequency=chunk)
    q = np.asarray(sim.state.q)
    assert q.dtype == np.float64
    return q


def test_diag_lj_stability_matches_the_jax_loop_f64():
    """One state point (lj_0.3_1.2, 108 atoms), one seed, from
    ``best_eval.pkl``'s candidate.  In float64, 100 steps in chunks of 50:
    the last positions equal the JAX loop's to 1e-6 (absolute, in units of
    sigma; they lie 4e-8 apart).  Further on the two trajectories part:
    their distance grows from 1e-15 about 5x every 10 steps on this state
    (a Lyapunov exponent of ~16 per unit of reduced time; 2e-4 at 150
    steps, uncorrelated by 200), so a longer run holds only the verdict.  In float32, as
    the script runs by default, 300 steps in chunks of 100: finite and
    "stable through 300", the JAX line."""
    port = load_script("diag_lj_stability_torch.py")
    argv = ["-data", "lj_0.3_1.2", "-size", "3", "-seeds", "1", "-init_pkl",
            LJ_BEST, "-device", "cpu"]
    lines = []
    (rec,) = port.main(argv + ["-steps", "100", "-chunk", "50"],
                       log=lines.append, dtype=torch.float64)
    assert lines[-1] == "lj_0.3_1.2 seed 0: stable through 100"
    with jax.enable_x64(True):
        q_j = _lj_jax_loop("lj_0.3_1.2", 3, 100, 50, 0)
    np.testing.assert_allclose(rec["q"], q_j, rtol=0, atol=1e-6)
    (rec,) = port.main(argv + ["-steps", "300", "-chunk", "100"],
                       log=lines.append)
    assert lines[-1] == "lj_0.3_1.2 seed 0: stable through 300"
    assert rec["died"] is None and np.isfinite(rec["q"]).all()
    assert rec["q"].shape == (108, 3)


def test_analyze_stripe_matches_the_jax_script(tmp_path):
    """``analyze_stripe_torch.py`` on the round-3 stripe run prints the
    JAX script's lines (its log: 3% blind, r in [0.30, 0.63], 0.6141 /
    9.4464 seen, 13.7640 / 16.4845 blind) and writes the same
    ``potential_overlay.csv`` (to 1e-6 of each row's largest entry, the
    truth being float32 on both sides) and a plot; an output directory
    inside ``results/`` is refused."""
    port = load_script("analyze_stripe_torch.py")
    lines = []
    res = port.main([STRIPE_RUN, STRIPE_TAG, "-out",
                     str(tmp_path / "port")], log=lines.append)
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "analyze_stripe.py"),
         STRIPE_RUN, STRIPE_TAG, "-out", str(tmp_path / "jax")],
        capture_output=True, text=True, check=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}).stdout.splitlines()
    assert lines[:-1] == ref[:-1] and len(lines) == len(ref) == 7
    assert lines[-1] == f"wrote {tmp_path / 'port'}/potential_overlay.jpg"
    assert lines[1].endswith("(g<0.05 'blind' bands: 3% of grid)")
    assert lines[3] == "  r in [0.30, 0.63]"
    assert (f"{res['seen_mean']:.4f}", f"{res['seen_max']:.4f}",
            f"{res['blind_mean']:.4f}", f"{res['blind_max']:.4f}") == \
        ("0.6141", "9.4464", "13.7640", "16.4845")
    got = np.loadtxt(tmp_path / "port" / "potential_overlay.csv",
                     delimiter=",")
    want = np.loadtxt(tmp_path / "jax" / "potential_overlay.csv",
                      delimiter=",")
    assert got.shape == want.shape == (4, res["r"].shape[0])
    for row_g, row_w in zip(got, want):
        np.testing.assert_allclose(row_g, row_w, rtol=0,
                                   atol=1e-6 * np.abs(row_w).max())
    assert (tmp_path / "port" / "potential_overlay.jpg").stat().st_size > 0
    with pytest.raises(SystemExit):
        port.main([STRIPE_RUN, STRIPE_TAG])
    with pytest.raises(SystemExit):
        port.main([STRIPE_RUN, STRIPE_TAG, "-out",
                   os.path.join(REPO, "results", "stripe_r3")])


def test_chiprunignore_leaves_out_all_results_but_the_trained_si_run():
    """``.chiprunignore`` lists every entry of ``results/`` but
    ``si_r2``, whose ``fit-ckpt-5699.pkl`` ``chip_smoke.py`` reads, so a
    new run directory is not shipped unnoticed; and each of its lines
    names a path that exists (a pattern that matches nothing is
    refused)."""
    with open(os.path.join(REPO, ".chiprunignore")) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    missing = [ln for ln in lines
               if not os.path.exists(os.path.join(REPO, ln))]
    assert not missing, f"lines that match nothing: {missing}"
    listed = {ln[len("results/"):] for ln in lines
              if ln.startswith("results/")}
    shipped = set(os.listdir(os.path.join(REPO, "results"))) - listed
    assert shipped == {"si_r2"}, f"shipped under results/: {shipped}"
    assert os.path.exists(SI_CKPT)
