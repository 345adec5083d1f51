"""The port's DiffTRe engine (mdgrad_tpu_torch/train/difftre.py) against
the JAX package's (tests/test_difftre.py mirrored): the weights and the
effective sample size, the reweighted gradient against ``jax.grad`` on the
same frames, the reweighted virial pressure, a SchNet interaction through
the bundle, the outer/inner loop recovering a perturbed LJ well depth,
its NaN rescue, and two outers of ``difftre_fit`` against the JAX
package's in float64 from the same start (the JAX side inside
``jax.enable_x64(True)``).

The system is tests/test_difftre.py's: 32 LJ atoms on the FCC lattice at
a = 1.679, kT 1.2, LJ at cutoff 1.6 (dense), NHC (Q 50, 3 links), dt
0.005.  The port's parameters are float32, so the JAX side takes the same
float32-rounded values.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.observables import rdf as rdf_j
from mdgrad_tpu.system import System as SystemJ
from mdgrad_tpu.train import difftre as difftre_j
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import units
from mdgrad_tpu_torch.train import difftre
from mdgrad_tpu_torch.train.optim import FitUpdate

KT, DT = 1.2, 0.005


def f32(x):
    return float(np.float32(x))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(cls, seed=7):
    s = cls.from_lattice("fcc", 2, 1.679)
    s.set_temperature(KT / units.kB, rng=np.random.default_rng(seed))
    return s


def _sim(sigma=1.0, epsilon=1.0, seed=7, dtype=torch.float64):
    s = _system(mt.System, seed)
    pair = mt.PairPotentials(s, mt.potentials.LennardJones(sigma, epsilon),
                             cutoff=1.6, mode="dense", device="cpu").to(dtype)
    integ = mt.NoseHooverChain(pair, s, T=KT / units.kB, Q=50.0,
                               num_chains=3, adjoint=False, device="cpu",
                               dtype=dtype)
    return s, pair, mt.Simulation(s, integ)


def _sim_j(sigma=1.0, epsilon=1.0, seed=7):
    s = _system(SystemJ, seed)
    pair = PairPotentialsJ(s, potentials_j.LennardJones(
        sigma=f32(sigma), epsilon=f32(epsilon)), cutoff=1.6, mode="dense")
    integ = NoseHooverChainJ(pair, s, T=KT / units_j.kB, Q=50.0,
                             num_chains=3, adjoint=False)
    return s, pair, SimulationJ(s, integ)


@pytest.fixture(scope="module")
def lj_setup():
    s, pair, sim = _sim()
    frames = difftre.sample_frames(sim, n_frames=12, steps_between=10,
                                   dt=DT, equil_steps=100)
    return s, pair, sim, frames


def test_weights_uniform_at_ref(lj_setup):
    s, pair, sim, frames = lj_setup
    est = difftre.ReweightEstimator(pair, frames, kT=KT)
    w, ess = est.weights()
    np.testing.assert_allclose(w.detach().numpy(), 1.0 / 12, rtol=1e-12)
    assert ess.item() == pytest.approx(1.0, rel=1e-12)
    assert frames.shape == (12, 32, 3)


def test_ess_decreases_away_from_ref(lj_setup):
    s, pair, sim, frames = lj_setup
    est = difftre.ReweightEstimator(pair, frames, kT=KT)
    with torch.no_grad():
        pair.model.epsilon += 0.5
        _, ess_far = est.weights()
        pair.model.epsilon -= 0.5
    assert ess_far.item() < 0.9


def _est_j(frames, cell=None):
    """JAX's estimator on the port's frames, float64."""
    s, pair, sim = _sim_j()
    return s, pair, sim, difftre_j.ReweightEstimator(
        pair, jnp.asarray(frames.numpy()), sim.params, kT=KT, cell=cell)


def test_reweighted_gradient_matches_jax_and_finite_difference(lj_setup):
    """d/d(sigma, eps) of the reweighted RDF loss (target 1.1 x the frames'
    mean g) equals ``jax.grad`` of JAX's ``make_rdf_loss`` on the same
    frames (float64, 1e-9) at a perturbed epsilon, and a central
    difference in epsilon (2e-2, as JAX's test)."""
    s, pair, sim, frames = lj_setup
    obs = mt.observables.rdf(s, nbins=24, r_range=(0.75, 1.55), device="cpu")
    g_frames = torch.stack([obs(q)[2] for q in frames])
    target = g_frames.mean(0) * 1.1
    est = difftre.ReweightEstimator(pair, frames, kT=KT)
    loss_fn = difftre.make_rdf_loss(est, g_frames, target)
    with torch.no_grad():
        pair.model.epsilon += 0.05
    try:
        loss, out = loss_fn()
        loss.backward()
        got = np.array([pair.model.sigma.grad.item(),
                        pair.model.epsilon.grad.item()])
        pair.model.sigma.grad = pair.model.epsilon.grad = None
        h = 1e-4
        with torch.no_grad():
            pair.model.epsilon += h
            lp = loss_fn()[0].item()
            pair.model.epsilon -= 2 * h
            lm = loss_fn()[0].item()
            pair.model.epsilon += h
        np.testing.assert_allclose(got[1], (lp - lm) / (2 * h), rtol=2e-2,
                                   atol=1e-6)
        with jax.enable_x64(True):
            _, _, sim_j, est_j = _est_j(frames)
            loss_j = difftre_j.make_rdf_loss(est_j, jnp.asarray(
                g_frames.numpy()), jnp.asarray(target.numpy()))
            p = {"sigma": jnp.asarray(pair.model.sigma.item()),
                 "epsilon": jnp.asarray(pair.model.epsilon.item())}
            val_j = float(loss_j(p)[0])
            g = jax.grad(lambda q: loss_j(q)[0])(p)
            ref = np.array([float(g["sigma"]), float(g["epsilon"])])
        np.testing.assert_allclose(loss.item(), val_j, rtol=1e-10)
        np.testing.assert_allclose(got, ref, rtol=1e-9)
        assert out["ess"].item() < 1.0
    finally:
        with torch.no_grad():
            pair.model.epsilon -= 0.05


def test_pressure_reweighting_matches_jax(lj_setup):
    """The per-frame configurational pressures equal JAX's; at the
    reference the reweighted pressure is their mean; its gradient in
    epsilon is finite, nonzero and JAX's (float64)."""
    s, pair, sim, frames = lj_setup
    est = difftre.ReweightEstimator(pair, frames, kT=KT, cell=s.get_cell())
    p_i = est.frame_pressures()
    w, _ = est.weights()
    p_hat = torch.dot(w, p_i)
    assert p_hat.item() == pytest.approx(p_i.mean().item(), rel=1e-12)
    p_hat.backward()
    got = pair.model.epsilon.grad.item()
    pair.model.sigma.grad = pair.model.epsilon.grad = None
    with jax.enable_x64(True):
        sj, _, sim_j, est_j = _est_j(frames, cell=_system(SystemJ).get_cell())
        p_j = np.asarray(est_j.frame_pressures(sim_j.params))
        g = jax.grad(lambda p: jnp.dot(est_j.weights(p)[0],
                                       est_j.frame_pressures(p)))(
            sim_j.params)
    np.testing.assert_allclose(p_i.detach().numpy(), p_j, rtol=1e-10)
    assert np.isfinite(got) and abs(got) > 0
    np.testing.assert_allclose(got, float(g["epsilon"]), rtol=1e-9)


def test_bundle_with_gnn_interaction(lj_setup):
    """A SchNet under ``GNNPotentials`` (table mode) through the bundle:
    finite reference energies over the frames' tables, uniform weights at
    the reference, finite nonzero parameter gradients of the RDF loss."""
    s, _, _, frames = lj_setup
    gnn = mt.SchNet({"n_atom_basis": 8, "n_filters": 8, "n_gaussians": 8,
                     "n_convolutions": 2, "cutoff": 1.6})
    inter = mt.GNNPotentials(s, gnn, cutoff=1.6, device="cpu").double()
    bundle = difftre.make_bundle(inter, frames)
    assert len(bundle["auxs"]) == 12
    assert bool(torch.isfinite(bundle["u_ref"]).all())
    est = difftre.ReweightEstimator(inter, frames, kT=KT)
    _, ess = est.weights()
    assert ess.item() == pytest.approx(1.0, rel=1e-10)
    obs = mt.observables.rdf(s, nbins=16, r_range=(0.75, 1.55), device="cpu")
    g_frames = torch.stack([obs(q)[2] for q in frames])
    loss, _ = difftre.make_rdf_loss(est, g_frames,
                                    torch.ones(16, dtype=torch.float64))()
    loss.backward()
    total = sum(p.grad.abs().sum().item() for p in inter.parameters()
                if p.grad is not None)
    assert np.isfinite(total) and total > 0


def _eps_only(pair, lr):
    """Adam on epsilon alone, sigma frozen (JAX's multi_transform)."""
    pair.model.sigma.requires_grad_(False)
    return FitUpdate([pair.model.epsilon], lr, grad_clip=None)


def test_difftre_fit_matches_jax_f64():
    """Two outers (6 frames every 10 steps after 30 of equilibration, up
    to 3 Adam steps on epsilon each, ESS floor 0.5) of the port's
    ``difftre_fit`` and of the JAX package's from the same state and
    parameters (epsilon 1.35), float64: the same history (losses, ESS,
    inner steps, step scale) and the same final epsilon, to 1e-7."""
    kw = dict(n_outer=2, inner_steps=3, n_frames=6, steps_between=10,
              equil_steps=30, ess_min=0.5)
    with jax.enable_x64(True):
        s_j, _, sim_j = _sim_j(epsilon=1.35, seed=4)
        obs_j = rdf_j(s_j, nbins=24, r_range=(0.75, 1.55))
        g_t = np.linspace(0.5, 1.5, 24)
        opt_j = optax.multi_transform(
            {"train": optax.adam(1e-2), "freeze": optax.set_to_zero()},
            {"epsilon": "train", "sigma": "freeze"})
        params_j, hist_j = difftre_j.difftre_fit(
            [sim_j], [obs_j], [g_t], kTs=[KT], cells=[s_j.get_cell()],
            opt=opt_j, dt=DT, log=lambda *a: None, **kw)
        eps_j = float(params_j["epsilon"])
    s, pair, sim = _sim(epsilon=1.35, seed=4)
    obs = mt.observables.rdf(s, nbins=24, r_range=(0.75, 1.55), device="cpu")
    hist = difftre.difftre_fit(
        [sim], [obs], [torch.tensor(g_t)], kTs=[KT], cells=[s.get_cell()],
        opt=_eps_only(pair, 1e-2), dt=DT, log=lambda *a: None, **kw)
    assert len(hist) == len(hist_j) == 2
    for row, row_j in zip(hist, hist_j):
        assert row["inner"] == row_j["inner"] and row["outer"] == \
            row_j["outer"]
        for key in ("loss", "loss_rw", "ess", "step_scale"):
            np.testing.assert_allclose(row[key], row_j[key], rtol=1e-7,
                                       err_msg=key)
    assert sum(r["inner"] for r in hist) > 0
    np.testing.assert_allclose(pair.model.epsilon.item(), eps_j, rtol=1e-7)
    assert pair.model.sigma.item() == f32(1.0)


def test_difftre_fit_recovers_epsilon():
    """Frames of the truth (eps 1.0); the target their mean g.  A fit
    started at eps 1.35 moves the well depth back toward the truth; the
    best-model hook fires at outer 0 with the entry parameters and its
    losses strictly fall (tests/test_difftre.py's recovery, float32)."""
    s_t, _, sim_t = _sim(seed=3, dtype=torch.float32)
    obs = mt.observables.rdf(s_t, nbins=24, r_range=(0.75, 1.55),
                             device="cpu")
    frames_t = difftre.sample_frames(sim_t, n_frames=32, steps_between=120,
                                     dt=DT, equil_steps=400)
    with torch.no_grad():
        g_target = torch.stack([obs(q)[2] for q in frames_t]).mean(0)
    s, pair, sim = _sim(epsilon=1.35, seed=4, dtype=torch.float32)
    bests = []
    hist = difftre.difftre_fit(
        [sim], [obs], [g_target], kTs=[KT], cells=[s.get_cell()],
        opt=_eps_only(pair, 2e-2), dt=DT, n_outer=6, inner_steps=25,
        n_frames=32, steps_between=120, equil_steps=400, ess_min=0.7,
        log=lambda *a: None,
        on_best=lambda o, l, p: bests.append((o, l, p)))
    eps = pair.model.epsilon.item()
    assert abs(eps - 1.0) < 0.35 * 0.5, (eps, hist)
    assert sum(h["inner"] for h in hist) > 0
    assert bests and bests[0][0] == 0
    ls = [b[1] for b in bests]
    assert all(b < a for a, b in zip(ls, ls[1:]))
    assert bests[0][2][0]["model.epsilon"].item() == pytest.approx(1.35)


def _poisoned(monkeypatch, which):
    real = difftre.sample_frames
    calls = {"n": 0}
    seen = []

    def poisoned(sim_, *a, **kw):
        calls["n"] += 1
        seen.append(None if sim_.state is None else sim_.state.v.clone())
        frames = real(sim_, *a, **kw)
        if calls["n"] == which:
            frames = frames.clone()
            frames[0, 0, 0] = float("nan")
        return frames

    monkeypatch.setattr(difftre, "sample_frames", poisoned)
    return seen


def test_difftre_fit_survives_nan_sampling(monkeypatch):
    """A non-finite second sampling reverts the parameters and the
    optimizer, rethermalizes, halves the step scale and goes on: the
    parameters stay finite and later outers train."""
    s, pair, sim = _sim(epsilon=1.2, seed=5, dtype=torch.float32)
    obs = mt.observables.rdf(s, nbins=24, r_range=(0.75, 1.55), device="cpu")
    frames0 = difftre.sample_frames(sim, n_frames=8, steps_between=20,
                                    dt=DT, equil_steps=100)
    with torch.no_grad():
        g_target = torch.stack([obs(q)[2] for q in frames0]).mean(0)
    _poisoned(monkeypatch, 2)
    logs = []
    opt = FitUpdate(list(pair.parameters()), 1e-2, grad_clip=None)
    hist = difftre.difftre_fit(
        [sim], [obs], [g_target], kTs=[KT], cells=[s.get_cell()], opt=opt,
        dt=DT, n_outer=4, inner_steps=3, n_frames=8, steps_between=20,
        equil_steps=60, ess_min=0.5, log=logs.append)
    assert all(bool(torch.isfinite(p).all()) for p in pair.parameters())
    assert any("reverted params" in str(m) for m in logs)
    assert any(h["outer"] > 1 for h in hist)


def test_difftre_fit_outer0_sampling_blowup_rethermalizes(monkeypatch):
    """A non-finite FIRST sampling, before any good state exists, retries
    from the lattice with fresh Maxwell-Boltzmann momenta."""
    s, pair, sim = _sim(epsilon=1.2, seed=5, dtype=torch.float32)
    obs = mt.observables.rdf(s, nbins=24, r_range=(0.75, 1.55), device="cpu")
    frames0 = difftre.sample_frames(sim, n_frames=8, steps_between=20,
                                    dt=DT, equil_steps=100)
    with torch.no_grad():
        g_target = torch.stack([obs(q)[2] for q in frames0]).mean(0)
    sim.state = None
    seen = _poisoned(monkeypatch, 1)
    logs = []
    opt = FitUpdate(list(pair.parameters()), 1e-2, grad_clip=None)
    hist = difftre.difftre_fit(
        [sim], [obs], [g_target], kTs=[KT], cells=[s.get_cell()], opt=opt,
        dt=DT, n_outer=3, inner_steps=3, n_frames=8, steps_between=20,
        equil_steps=60, ess_min=0.5, log=logs.append)
    assert any("reverted params" in str(m) for m in logs)
    assert len(hist) >= 1
    assert all(bool(torch.isfinite(p).all()) for p in pair.parameters())
    assert seen[0] is None and seen[1] is not None


def test_run_difftre_torch_dry_run(tmp_path):
    """``scripts/run_difftre_torch.py --dry_run -device cpu`` (32 atoms, 2
    outers of up to 5 inner steps after 50 pretraining iterations) logs
    both outers and writes its checkpoints and the recovered u(r)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(repo / "scripts" / "run_difftre_torch.py"),
         "--dry_run", "-device", "cpu", "-logdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    hist = json.loads((tmp_path / "history.json").read_text())
    assert [h["outer"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and 0 < h["ess"] <= 1 for h in hist)
    for name in ("best.pt", "last.pt", "potential.txt"):
        assert (tmp_path / name).exists()
    assert "recovered depth" in proc.stdout
