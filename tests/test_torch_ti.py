"""The port's thermodynamic integration (``md/ti.py``) and MD utilities
(``md/utils.py``) against the JAX package's (tests/test_md_extras.py's
TI, xyz and logger tests, mirrored).

The port's Langevin noise is not JAX's threefry, so the parity run passes
JAX's draws in through ``noise_fn`` (``normal(fold_in(PRNGKey(seed),
noise_step0 + i))``, as tests/test_torch_langevin.py does).  It runs in
float64, the JAX ``GraphConvIntegration`` built with
``compute_dtype=jnp.float64`` and its Gaussian constants widened; its
convolution outputs stay float32 (tests/test_torch_supervised.py), which
sets the tolerances.  The system is tests/test_md_extras.py's: 108 FCC
atoms at a = 1.679.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdgrad_tpu.nn.schnet as schnet_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.md import ti as ti_j
from mdgrad_tpu.md import utils as utils_j
from mdgrad_tpu.nn.models import GraphConvIntegration as GCIJ
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch.md import ti, utils
from mdgrad_tpu_torch.nn.convert import schnet_params_from_numpy
from mdgrad_tpu_torch.nn.models import GraphConvIntegration

MP = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
      "n_convolutions": 1, "cutoff": 2.4}
RUN = dict(T_init=120.0, dt=0.005, cutoff=2.4, steps=20,
           nbr_list_update_freq=5, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(cls):
    s = cls.from_lattice("fcc", 3, 1.679)
    s.set_temperature(0.8 / units_j.kB, rng=np.random.default_rng(11))
    return s


def _aggr(n):
    init, final = np.ones(n), np.ones(n)
    final[-1] = 0.0          # switch the last atom off
    return init, final


def _jax_noise(seed):
    key = jax.random.PRNGKey(seed)

    def noise_fn(index, shape):
        with jax.enable_x64(True):
            z = jax.random.normal(jax.random.fold_in(key, np.uint32(index)),
                                  shape, dtype=jnp.float64)
            return torch.tensor(np.asarray(z))
    return noise_fn


@pytest.fixture(scope="module")
def jax_ti():
    """The JAX TI run in float64 and its initial parameters."""
    orig = schnet_j.gaussian_smearing
    schnet_j.gaussian_smearing = lambda d, o, w, centered=False: orig(
        d, o.astype(d.dtype), w.astype(d.dtype), centered)
    try:
        with jax.enable_x64(True):
            s = _system(SystemJ)
            p32 = GCIJ(MP).init_params(jnp.ones(108, dtype=jnp.int32))
            p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       p32)
            t = ti_j.TI(s, GCIJ({**MP, "compute_dtype": jnp.float64}),
                        *_aggr(108), params=p, **RUN)
            out = t.run(log=lambda *a: None)
            out = {"du_dlambda": out["du_dlambda"],
                   "delta_f": out["delta_f"], "thermo": out["thermo"],
                   "q": np.asarray(out["final_state"].q),
                   "v": np.asarray(out["final_state"].v)}
    finally:
        schnet_j.gaussian_smearing = orig
    return out, jax.tree_util.tree_map(np.asarray, p32)


def _port_gnn(tree, dtype=torch.float64):
    gnn = GraphConvIntegration(MP)
    gnn.load_state_dict(schnet_params_from_numpy(tree))
    return gnn.to(dtype)


def test_ti_matches_jax_with_its_noise_f64(jax_ti, tmp_path):
    """Four ramp segments of 5 steps: dU/dlambda (reverse mode in the
    port, ``jax.jvp`` in JAX) and delta_f equal JAX's to rtol 1e-6, the
    final positions and velocities to 1e-7, the thermo rows to rtol 1e-6;
    the trajectory and log files are written."""
    ref, tree = jax_ti
    s = _system(mt.System)
    traj = os.path.join(str(tmp_path), "ti.xyz")
    t = ti.TI(s, _port_gnn(tree), *_aggr(108), noise_fn=_jax_noise(0),
              thermo_filename=os.path.join(str(tmp_path), "thermo.log"),
              traj_filename=traj, device="cpu", dtype=torch.float64, **RUN)
    out = t.run(log=lambda *a: None)
    assert out["du_dlambda"].shape == (4,)
    np.testing.assert_allclose(out["du_dlambda"], ref["du_dlambda"],
                               rtol=1e-6)
    np.testing.assert_allclose(out["delta_f"], ref["delta_f"], rtol=1e-6)
    np.testing.assert_allclose(out["final_state"].q.numpy(), ref["q"],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(out["final_state"].v.numpy(), ref["v"],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.array(out["thermo"]),
                               np.array(ref["thermo"]), rtol=1e-6)
    frames, symbols = utils.read_xyz(traj)
    assert frames.shape == (4, 108, 3) and len(symbols) == 108
    np.testing.assert_allclose(frames[-1], ref["q"], atol=1e-7)
    with open(os.path.join(str(tmp_path), "thermo.log")) as f:
        assert len(f.read().splitlines()) == 5


def test_du_dlambda_equals_finite_difference_and_sparse_mode(jax_ti):
    """The reverse-mode dU/dlambda equals a central difference of U along
    the ramp (f64, rtol 1e-6), and the 'sparse' edge list gives the
    table's energy and dU/dlambda (rtol 1e-10)."""
    _, tree = jax_ti
    s = _system(mt.System)
    init, final = _aggr(108)
    t = ti.TI(s, _port_gnn(tree), init, final, device="cpu",
              dtype=torch.float64, **RUN)
    q = torch.tensor(s.get_positions(), dtype=torch.float64)
    q = q + 0.05 * torch.randn(q.shape, dtype=torch.float64,
                               generator=torch.Generator().manual_seed(1))
    direction = t.final_aggr - t.init_aggr
    aggr = t.init_aggr + 0.3 * direction
    inter = t.interaction
    aux = inter.aux_init(q)
    du = float(t.du_dlambda(q, aux, aggr, direction))
    h = 1e-4
    with torch.no_grad():
        fd = (float(inter.energy(q, aux, aggr_wgt=aggr + h * direction))
              - float(inter.energy(q, aux, aggr_wgt=aggr - h * direction))
              ) / (2 * h)
    assert abs(du) > 1e-3
    np.testing.assert_allclose(du, fd, rtol=1e-6)
    sparse = ti.AggrGNNInteraction(s, inter.gnn, 2.4, nbr_mode="sparse",
                                   device="cpu").double()
    aux_s = sparse.aux_init(q)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(sparse.energy(q, aux_s, aggr_wgt=aggr)),
            float(inter.energy(q, aux, aggr_wgt=aggr)), rtol=1e-10)
    t.interaction = sparse
    np.testing.assert_allclose(float(t.du_dlambda(q, aux_s, aggr,
                                                  direction)), du,
                               rtol=1e-10)
    with pytest.raises(ValueError):
        ti.AggrGNNInteraction(s, inter.gnn, 2.4, nbr_mode="topk",
                              device="cpu")


def test_ti_driver():
    """tests/test_md_extras.py's run with the port's own noise, float32."""
    s = _system(mt.System)
    gnn = GraphConvIntegration(MP)
    t = ti.TI(s, gnn, *_aggr(108), device="cpu", **RUN)
    out = t.run(log=lambda *a: None)
    assert out["du_dlambda"].shape == (4,)
    assert np.isfinite(out["delta_f"]) and np.isfinite(
        out["du_dlambda"]).all()
    assert len(out["thermo"]) == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ti.TI(s, gnn, *_aggr(108), **RUN)   # the card by default


def test_xyz_roundtrip_across_packages(tmp_path):
    frames = np.random.default_rng(0).uniform(0, 5, (3, 7, 3))
    numbers = np.array([1, 1, 8, 8, 14, 18, 6])
    fn = os.path.join(str(tmp_path), "t.xyz")
    fn_j = os.path.join(str(tmp_path), "tj.xyz")
    utils.write_xyz(fn, torch.from_numpy(frames), numbers=numbers,
                    comment="test")
    utils_j.write_xyz(fn_j, frames, numbers=numbers, comment="test")
    with open(fn) as a, open(fn_j) as b:
        assert a.read() == b.read()
    back, symbols = utils.read_xyz(fn_j)
    np.testing.assert_allclose(back, frames, atol=1e-7)
    assert symbols[2] == "O" and symbols[4] == "Si"
    utils.write_xyz(fn, frames[0], numbers=numbers, append=True)
    assert utils.read_xyz(fn)[0].shape == (4, 7, 3)
    s = _system(mt.System)
    utils.save_traj(s, np.stack([s.get_positions()] * 25), fn, skip=10)
    assert utils.read_xyz(fn)[0].shape == (3, 108, 3)


def test_md_logger_matches_jax(tmp_path):
    """Rows (time, Etot, Epot, Ekin, T) equal JAX's logger's (rtol 1e-6),
    Etot = Epot + Ekin, the file written with its header."""
    s, s_j = _system(mt.System), _system(SystemJ)
    fn = os.path.join(str(tmp_path), "thermo.log")
    logger = utils.NeuralMDLogger(s, logfile=fn)
    row = logger(0.5, torch.tensor(s.get_velocities()), -100.0)
    row_j = utils_j.NeuralMDLogger(s_j)(0.5, s_j.get_velocities(), -100.0)
    np.testing.assert_allclose(row, row_j, rtol=1e-6)
    assert len(logger.rows) == 1
    assert abs(row[1] - (row[2] + row[3])) < 1e-9
    with open(fn) as f:
        lines = f.read().splitlines()
    assert lines[0].split() == list(utils.NeuralMDLogger.HEADER)
    assert len(lines) == 2
