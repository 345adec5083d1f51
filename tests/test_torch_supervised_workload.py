"""``scripts/run_supervised_torch.py`` on the CPU at
tests/test_supervised_workload.py's arguments (mirrored): label
generation from a ground-truth trajectory, the Trainer stack, validation
by use; its result keys and files, its labels against the JAX package's
potential, and its files read by the JAX package and by the port."""

import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
sys.path.insert(0, SCRIPTS)

ARGV = ["-size", "2", "-cutoff", "1.5", "-n_frames", "12", "-burnin", "1",
        "-frame_stride", "5", "-batch_size", "4", "-max_epochs", "3",
        "-val_sim", "3", "-n_atom_basis", "16", "-n_filters", "16",
        "-n_convolutions", "1", "-device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_supervised_torch_smoke(tmp_path):
    import run_supervised_torch
    from mdgrad_tpu.data.dataset import Dataset as DatasetJ
    from mdgrad_tpu.data import pair_data_dict as pair_data_j
    from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
    from mdgrad_tpu.system import System as SystemJ
    from mdgrad_tpu.train.fit_rdf_pair import resolve_target_pot
    from mdgrad_tpu_torch.train.builders import load_model

    logdir = str(tmp_path / "sup")
    lines = []
    result = run_supervised_torch.main(["-logdir", logdir, *ARGV],
                                       log=lines.append)
    assert result["n_frames"] == 12 and result["n_atoms"] == 32
    assert result["test_metrics"].keys() == {"energy", "energy_grad"}
    assert np.isfinite(result["test_metrics"]["energy_grad"]["mae"])
    assert np.isfinite(result["rdf_mse_vs_truth"])
    assert result["train_epochs"] == 3 and result["train_steps"] > 0
    for f in ("dataset.npz", "model.pt", "best_model.pt", "log.csv",
              "rdf_compare.csv", "result.json", "paramset.json"):
        assert os.path.exists(os.path.join(logdir, f)), f
    with open(os.path.join(logdir, "result.json")) as fh:
        assert json.load(fh)["n_atoms"] == 32
    assert any(l.startswith("  [gnn] sampled 2 epochs") for l in lines)
    # the JAX package reads the dataset; each label is the ground-truth
    # potential's energy and +dU/dxyz at its frame (f32: 1e-5 relative)
    ds = DatasetJ.load(os.path.join(logdir, "dataset.npz"))
    assert len(ds) == 12 and ds.units == "kcal/mol"
    entry = pair_data_j["lj_0.845_1.2"]
    nxyz = np.asarray(ds.props["nxyz"][5])
    model, mp = load_model(os.path.join(logdir, "model.pt"), device="cpu")
    assert mp["energy_shift"] == pytest.approx(result["energy_shift"])
    from mdgrad_tpu_torch.train.fit_rdf import get_system
    from mdgrad_tpu_torch.data.registry import pair_data_dict
    s = get_system("lj_0.845_1.2", 2, pair_data_dict,
                   rng=np.random.default_rng(0))
    sj = SystemJ(nxyz[:, 1:4], np.asarray(s.get_cell()))
    pot = PairPotentialsJ(sj, resolve_target_pot(entry["target_pot"]),
                          cutoff=1.5)
    tp = pot.init_params()
    q = jnp.asarray(nxyz[:, 1:4])
    u, g = jax.value_and_grad(lambda x: pot.energy(tp, x, pot.aux_init(x))
                              )(q)
    np.testing.assert_allclose(float(ds.props["energy"][5]), float(u),
                               rtol=1e-5)
    g = np.asarray(g)
    np.testing.assert_allclose(ds.props["energy_grad"][5], g, rtol=0,
                               atol=1e-5 * np.abs(g).max())
    # the pair lists are the minimum-image pairs within the cutoff
    nbrs = np.asarray(ds.props["nbr_list"][5])
    off = np.asarray(ds.props["offsets"][5])
    d = np.linalg.norm(nxyz[nbrs[:, 0], 1:] - nxyz[nbrs[:, 1], 1:] - off,
                       axis=-1)
    assert len(nbrs) > 0 and (d < 1.5).all()
