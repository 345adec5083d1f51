"""The port's polymer fold (``train/fold.py``, ``lattice.helix`` /
``straight_chain``, ``Simulation(method=...)``) against the JAX package's.

``train_fold`` runs at tests/test_fit.py:214-230's parameters in float64
on both sides, from the same SchNet weights: the JAX ``train_fold``'s
``Simulation`` is wrapped to widen its initial parameters to float64 (the
flax SchNet is created float32, and Adam would then step in float32) and
record them, the port's to load them through
``nn/convert.py::stack_params_from_numpy``; both draw the same velocities
from the same numpy seed.  The JAX run happens
once, in a module-scoped fixture.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import lattice as lattice_j
from mdgrad_tpu.train import fold as fold_j
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import lattice
from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy
from mdgrad_tpu_torch.train import fold

PARAMS = {
    "n_atoms": 16, "n_spiral": 3, "a_spiral": 1.2, "dz_spiral": 0.25,
    "loss_cutoff": 4.0, "k0": 5.0, "epsilon": 0.05, "sigma": 0.9,
    "n_atom_basis": 32, "n_filters": 32, "n_gaussians": 16,
    "n_convolutions": 2, "cutoff": 3.0, "T": 0.1,
    "method": "NH_verlet", "dt": 0.01, "tau": 11, "lr": 1e-3,
    "l_b": 1.0, "l_a": 1.0, "l_d": 1.0, "l_dis": 1.0, "n_epochs": 3}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_fold():
    """The JAX ``train_fold`` in float64 and the initial parameters of
    its simulation (a numpy tree)."""
    trees = []

    class Recorder(fold_j.Simulation):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.params = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), self.params)
            trees.append(jax.tree_util.tree_map(np.asarray, self.params))

    mp = pytest.MonkeyPatch()
    mp.setattr(fold_j, "Simulation", Recorder)
    try:
        with jax.enable_x64(True):
            out = fold_j.train_fold(dict(PARAMS), log=lambda *a: None,
                                    rng=np.random.default_rng(4))
    finally:
        mp.undo()
    return out, trees[0]


def test_helix_and_straight_chain_equal_jax():
    """The target and the start geometry equal the JAX package's bits."""
    np.testing.assert_array_equal(lattice.helix(10, 50, 1.5, 0.25),
                                  lattice_j.helix(10, 50, 1.5, 0.25))
    for got, ref in zip(lattice.straight_chain(50, 0.979),
                        lattice_j.straight_chain(50, 0.979)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", ["helix", "straight"])
def test_intcoord_and_bond_values_and_gradients_match_jax(shape):
    """Bond lengths, angles, signed dihedrals and pair distances of 3
    frames, and the gradient of a weighted sum of them, equal JAX's in
    float64 (rtol 1e-12, gradients atol 1e-10 of the largest); the
    straight chain's zero normals give dihedrals of 0 and finite
    gradients."""
    rng = np.random.default_rng(1)
    if shape == "helix":
        base = lattice.helix(3, 16, 1.2, 0.25)
        xyz = base[None] + 0.05 * rng.standard_normal((3, 16, 3))
    else:
        xyz = np.repeat(lattice.straight_chain(16, 0.9)[0][None], 3, 0)
    adj = np.array([[0, 3], [2, 9], [15, 4]])
    w = rng.standard_normal(4)

    def scalar(b, a, d, dis):
        return (w[0] * (b ** 2).sum() + w[1] * (a ** 2).sum()
                + w[2] * (d ** 2).sum() + w[3] * dis.sum())

    with jax.enable_x64(True):
        xj = jnp.asarray(xyz)
        ref = [np.asarray(v) for v in fold_j.compute_intcoord(xj)]
        ref.append(np.asarray(fold_j.compute_bond(xj, jnp.asarray(adj))))
        g_j = np.asarray(jax.grad(lambda x: scalar(
            *fold_j.compute_intcoord(x),
            fold_j.compute_bond(x, jnp.asarray(adj))))(xj))
    xt = torch.tensor(xyz, requires_grad=True)
    got = [*fold.compute_intcoord(xt),
           fold.compute_bond(xt, torch.as_tensor(adj))]
    scalar(*got).backward()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=1e-12,
                                   atol=1e-14)
    assert np.isfinite(g_j).all() and np.abs(g_j).max() > 0
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=0,
                               atol=1e-10 * np.abs(g_j).max())
    if shape == "straight":
        assert float(got[2].detach().abs().max()) == 0.0


def test_get_dis_list_equals_jax():
    """The pairs equal JAX's and the distances its float64 ones."""
    xyz = lattice.helix(3, 16, 1.2, 0.25)[None]
    with jax.enable_x64(True):
        d_j, adj_j = fold_j.get_dis_list(xyz, 4.0)
        d_j, adj_j = np.asarray(d_j), np.asarray(adj_j)
    d, adj = fold.get_dis_list(torch.tensor(xyz), 4.0)
    np.testing.assert_array_equal(adj.numpy(), adj_j)
    assert adj.shape[0] > 16
    np.testing.assert_allclose(d.numpy(), d_j, rtol=1e-14)


def test_train_fold_loss_history_matches_jax_f64(jax_fold, monkeypatch):
    """Two trained epochs after the warm-up, through the replay adjoint
    into the SchNet, and one Adam step between them: both losses equal
    JAX's (rtol 1e-9) and so do the final frames (atol 1e-9 A)."""
    out_j, tree = jax_fold

    class Loader(mt.Simulation):
        def __init__(self, system, integ, **kw):
            integ.model.load_state_dict(
                stack_params_from_numpy(tree, integ.model))
            super().__init__(system, integ, **kw)

    monkeypatch.setattr(fold, "Simulation", Loader)
    out = fold.train_fold(dict(PARAMS), log=lambda *a: None,
                          rng=np.random.default_rng(4), device="cpu",
                          dtype=torch.float64)
    assert not out.get("nan_bailout", False)
    assert len(out["loss_log"]) == 2 and len(out_j["loss_log"]) == 2
    np.testing.assert_allclose(out["loss_log"], out_j["loss_log"],
                               rtol=1e-9)
    np.testing.assert_allclose(out["final_frame"], out_j["final_frame"],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(out["target"], out_j["target"], rtol=1e-15)


@pytest.mark.parametrize("method", ["rk4", "verlet", "NH_verlet"])
def test_simulation_method_matches_jax_trajectory(method):
    """``Simulation(wrap=False, method=...)`` on the fold's chain without
    the SchNet (Stack{bonds, excluded volume with bonded exclusions}), NHC
    for 'rk4' and 'NH_verlet', NVE for 'verlet': one 15-frame epoch's q
    and v (and the chain momenta) equal JAX's in float64 (atol 1e-11)."""
    from mdgrad_tpu import potentials as pot_j, units as units_j
    from mdgrad_tpu.interface import (BondPotentials as BondJ,
                                      PairPotentials as PairJ, Stack as StackJ)
    from mdgrad_tpu.md import NVE as NVEJ, NoseHooverChain as NHCJ
    from mdgrad_tpu.md import Simulation as SimJ
    from mdgrad_tpu.system import System as SystemJ
    n = 10
    top = np.stack([np.arange(n - 1), np.arange(1, n)], -1)
    pos, cell = lattice.straight_chain(n, 0.95)
    pos = pos + 0.1 * np.random.default_rng(7).standard_normal(pos.shape)
    nhc = method != "verlet"
    fields = ("q", "v", "pv") if nhc else ("q", "v")
    with jax.enable_x64(True):
        sj = SystemJ(pos, cell)
        sj.set_temperature(0.1 / units_j.kB, rng=np.random.default_rng(3))
        st = StackJ({"prior": BondJ(sj, top, 5.0, 0.9),
                     "pair": PairJ(sj, pot_j.ExcludedVolume(
                         sigma=0.9, epsilon=0.05, power=10), cutoff=2.5,
                         ex_pairs=top)})
        integ_j = (NHCJ(st, sj, T=0.1 / units_j.kB, Q=50.0, num_chains=5)
                   if nhc else NVEJ(st, sj))
        sim_j = SimJ(sj, integ_j, wrap=False, method=method)
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), sim_j.params)
        state_j, aux_j = sim_j.initial_state()
        traj_j, _ = sim_j.epoch_fn(0.01, 15)(params, state_j, aux_j,
                                              integ_j.default_ctrl())
        ref = {k: np.asarray(getattr(traj_j, k)) for k in fields}
    s = mt.System(pos, cell)
    s.set_temperature(0.1 / mt.units.kB, rng=np.random.default_rng(3))
    stack = mt.Stack({
        "prior": mt.BondPotentials(s, top, 5.0, 0.9, device="cpu"),
        "pair": mt.PairPotentials(s, mt.potentials.ExcludedVolume(
            sigma=0.9, epsilon=0.05, power=10), cutoff=2.5, ex_pairs=top,
            device="cpu")}).double()
    stack.load_state_dict(stack_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), stack))
    kw = dict(device="cpu", dtype=torch.float64)
    integ = (mt.NoseHooverChain(stack, s, T=0.1 / mt.units.kB, Q=50.0,
                                num_chains=5, **kw) if nhc
             else mt.NVE(stack, s, **kw))
    sim = mt.Simulation(s, integ, wrap=False, method=method)
    assert sim.method == method
    state, aux = sim.initial_state()
    with torch.no_grad():
        traj, _ = sim.epoch_fn(0.01, 15)(state, aux, integ.default_ctrl())
    for k in fields:
        np.testing.assert_allclose(getattr(traj, k).numpy(), ref[k], rtol=0,
                                   atol=1e-11, err_msg=f"{method} {k}")
    assert np.abs(ref["q"][-1] - ref["q"][0]).max() > 1e-3


def test_run_fold_torch_dry_run():
    """``scripts/run_fold_torch.py --dry_run -device cpu`` (16 atoms, 3
    epochs) prints a finite objective."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(repo / "scripts" / "run_fold_torch.py"),
         "--dry_run", "-device", "cpu"], capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("objective:")]
    assert line and np.isfinite(float(line[0].split()[1]))
