"""The port's binary-mixture fit (``train/fit_mix.py``) against the JAX
package's, at tests/test_fit.py:196-211's arguments (size 2, 32 atoms).

Both sides run in float64 (the JAX side inside ``jax.enable_x64(True)``)
and draw the same species and velocities from the same numpy seed.  The
JAX ``fit_mix``'s ``Simulation`` is wrapped to widen its initial parameters to
float64 (the flax MLPs are created float32, and Adam would then step in
float32) and record them; the port's to load them (``nn/convert.py``).
The JAX RDFs take the float32 last bin edge for their Gaussian centres,
as the port's do (tests/test_torch_lj.py's ``_rdf_j``).  The JAX run
happens once, in a module-scoped fixture.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu.nn.layers import GaussianSmearing as GaussianSmearingJ
from mdgrad_tpu.system import System as SystemJ
from mdgrad_tpu.train import fit_mix as fm_j
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy
from mdgrad_tpu_torch.train import fit_mix as fm

ARGS = dict(size=2, n_epochs=2, tau=11, nbins=32, rdf_range=(0.6, 1.6),
            n_target_epochs=3, target_steps=20)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Rdf(fm_j.rdf_obs_cls):
    """The JAX rdf with its Gaussian centres spread to the float32 last
    bin edge."""

    def __init__(self, system, nbins, r_range, **kw):
        super().__init__(system, nbins, r_range, **kw)
        self.smear = GaussianSmearingJ(r_range[0],
                                       float(np.float32(self.bins[-1])),
                                       nbins)


@pytest.fixture(scope="module")
def jax_mix():
    """The JAX ``fit_mix`` in float64 and each simulation's initial
    parameters (numpy trees, truth first)."""
    trees = []

    class Recorder(fm_j.Simulation):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.params = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), self.params)
            trees.append(jax.tree_util.tree_map(np.asarray, self.params))

    mp = pytest.MonkeyPatch()
    mp.setattr(fm_j, "Simulation", Recorder)
    mp.setattr(fm_j, "rdf_obs_cls", _Rdf)
    try:
        with jax.enable_x64(True):
            out = fm_j.fit_mix(log=lambda *a: None,
                               rng=np.random.default_rng(3), **ARGS)
    finally:
        mp.undo()
    return out, trees


def test_mix_system_species_equal_jax():
    """The same permutation gives the same species, indices and masses."""
    for x in (0.5, 0.3):
        a = mt.System.from_lattice("fcc", 2, 1.6)
        b = SystemJ.from_lattice("fcc", 2, 1.6)
        a, i1, i2 = fm.mix_system(a, x, rng=np.random.default_rng(9))
        b, j1, j2 = fm_j.mix_system(b, x, rng=np.random.default_rng(9))
        np.testing.assert_array_equal(i1, j1)
        np.testing.assert_array_equal(i2, j2)
        np.testing.assert_array_equal(a.get_atomic_numbers(),
                                      b.get_atomic_numbers())
        np.testing.assert_array_equal(a.get_masses(), b.get_masses())
        assert len(i1) == int(32 * x) and (a.get_atomic_numbers() == 2).sum() \
            == 32 - len(i1)


def test_truth_stack_energy_matches_jax_f64():
    """``build_mixture``'s three species-restricted LJ terms: the system
    (positions, velocities, species) equals JAX's, and each term's energy
    and the total force do in float64 (rtol 1e-12) at perturbed
    positions."""
    rng_j, rng = np.random.default_rng(2), np.random.default_rng(2)
    with jax.enable_x64(True):
        sj, stack_j, _, _ = fm_j.build_mixture(size=2, rng=rng_j)
        p = stack_j.init_params()
        tree = jax.tree_util.tree_map(np.asarray, p)
        x = jnp.asarray(sj.get_positions()) + 0.03
        aux = stack_j.aux_init(x)
        u_j = {k: float(m.energy(p[k], x, aux[k]))
               for k, m in stack_j.models.items()}
        f_j = -np.asarray(jax.grad(stack_j.energy, argnums=1)(p, x, aux))
    s, stack, _, _ = fm.build_mixture(size=2, rng=rng, device="cpu",
                                      dtype=torch.float64)
    for get in ("get_positions", "get_velocities", "get_atomic_numbers"):
        np.testing.assert_array_equal(getattr(s, get)(), getattr(sj, get)())
    stack.load_state_dict(stack_params_from_numpy(tree, stack))
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    aux = stack.aux_init(xt)
    for k, m in stack.models.items():
        assert u_j[k] != 0.0
        np.testing.assert_allclose(m.energy(xt, aux[k]).item(), u_j[k],
                                   rtol=1e-12, err_msg=k)
    stack.energy(xt, aux).backward()
    np.testing.assert_allclose(-xt.grad.numpy(), f_j, rtol=0,
                               atol=1e-12 * np.abs(f_j).max())


def test_fit_mix_matches_jax_f64(jax_mix, monkeypatch, tmp_path):
    """Targets (atol 1e-9 of their peak), both epochs' losses (rtol 1e-8)
    and the recovered potentials (atol 1e-8 of their largest) equal
    JAX's; the 11 and 22 targets differ (disjoint selections);
    pot{11,12,22}.csv are written."""
    out_j, trees = jax_mix
    trees = list(trees)

    class Loader(mt.Simulation):
        def __init__(self, system, integ, **kw):
            integ.model.load_state_dict(
                stack_params_from_numpy(trees.pop(0), integ.model))
            super().__init__(system, integ, **kw)

    monkeypatch.setattr(fm, "Simulation", Loader)
    out = fm.fit_mix(model_path=str(tmp_path), log=lambda *a: None,
                     rng=np.random.default_rng(3), device="cpu",
                     dtype=torch.float64, **ARGS)
    assert not out.get("nan_bailout", False) and not trees
    for k, t in out_j["targets"].items():
        np.testing.assert_allclose(out["targets"][k], np.asarray(t), rtol=0,
                                   atol=1e-9 * np.abs(t).max(), err_msg=k)
    assert not np.allclose(out["targets"]["11"], out["targets"]["22"])
    assert len(out["loss_log"]) == 2
    np.testing.assert_allclose(out["loss_log"], out_j["loss_log"], rtol=1e-8)
    for k, u in out_j["recovered"].items():
        np.testing.assert_allclose(out["recovered"][k], u, rtol=0,
                                   atol=1e-8 * np.abs(u).max(), err_msg=k)
        grid = np.loadtxt(tmp_path / f"pot{k}.csv", delimiter=",")
        assert grid.shape == (2, 200) and np.isfinite(grid).all()
