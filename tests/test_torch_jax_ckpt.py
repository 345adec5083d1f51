"""The port's reader of the JAX package's pickles
(``mdgrad_tpu_torch/train/checkpoint.py::read_jax_pickle``) against
``pickle.load`` with optax and ``mdgrad_tpu`` imported, and what reads
through it: the trained a-Si SchNet of
``results/si_r2/0/fit-ckpt-5699.pkl`` against the JAX SchNet with the
same weights, the DiffTRe and NPT scripts' ``-init_pkl`` warm starts
against the JAX scripts' grafts (``run_difftre.py:126-131``,
``run_npt_fit.py:152-158``), and ``si_transfer_torch.py --dry_run``
from the JAX checkpoint.

The reader turns each class of optax, ``mdgrad_tpu``, jax, jaxlib and
flax into an inert record and refuses every other global but numpy's
arrays; the tests build pickles that name ``os.system``,
``builtins.eval`` and a class of ``mdgrad_tpu_torch`` and check that
they are refused before anything runs.
"""

import glob
import importlib
import importlib.util
import os
import pickle
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import optax  # noqa: F401  (pickle.load finds the optax classes)
import mdgrad_tpu  # noqa: F401
from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu.data.registry import exp_rdf_data_dict as registry_j
from mdgrad_tpu.data.registry import pair_data_dict as pair_data_dict_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.nn import PairMLP as PairMLPJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch.data.registry import exp_rdf_data_dict, pair_data_dict
from mdgrad_tpu_torch.nn.convert import schnet_params_from_numpy
from mdgrad_tpu_torch.train import fit_rdf
from mdgrad_tpu_torch.train.checkpoint import (JaxRecord, jax_params,
                                               load_schnet_checkpoint,
                                               read_jax_pickle)

fit_rdf_j = importlib.import_module("mdgrad_tpu.train.fit_rdf")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results")
SI_CKPT = os.path.join(RESULTS, "si_r2", "0", "fit-ckpt-5699.pkl")
LJ_BEST = os.path.join(RESULTS, "lj_multi_r3g", "0", "best_eval.pkl")
WATER_CKPT = os.path.join(RESULTS, "water_r2_f32", "0", "fit-ckpt-489.pkl")


def load_script(name):
    path = os.path.join(REPO, "scripts", name)
    spec = importlib.util.spec_from_file_location(f"_k_{name[:-3]}", path)
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


def _same(got, ref, where):
    """``got`` (the port's read) equals ``ref`` (``pickle.load``'s): the
    same containers, numpy arrays of the same dtype, shape and bytes, and
    in place of each class instance a record of that class whose
    arguments are its fields (a NamedTuple pickled before a field with a
    default was added holds fewer; the rest are the defaults)."""
    if isinstance(got, JaxRecord):
        cls = type(ref)
        assert got.jax_global == f"{cls.__module__}.{cls.__qualname__}", \
            where
        assert isinstance(ref, tuple) and hasattr(cls, "_fields"), where
        n = len(got.args)
        assert n <= len(ref), where
        for i, (a, b) in enumerate(zip(got.args, ref)):
            _same(a, b, f"{where}[{i}]")
        for field in cls._fields[n:]:
            assert getattr(ref, field) is cls._field_defaults[field], where
        return
    assert type(got) is type(ref), (where, type(got), type(ref))
    if isinstance(got, dict):
        assert list(got) == list(ref), where
        for k in got:
            _same(got[k], ref[k], f"{where}.{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (a, b) in enumerate(zip(got, ref)):
            _same(a, b, f"{where}[{i}]")
    elif isinstance(got, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape, where
        assert got.tobytes() == ref.tobytes(), where
    elif isinstance(got, float) and np.isnan(ref):
        assert np.isnan(got), where
    else:
        assert got == ref, where


def test_every_results_pickle_reads_as_jax_reads_it():
    """All 222 pickles under ``results/`` (181 of them naming optax states,
    ``NVTStateF`` or ``NeighborTable``) read through the port's reader;
    each blob, its parameters bit for bit, equals ``pickle.load``'s with
    the JAX stack imported."""
    files = sorted(glob.glob(os.path.join(RESULTS, "**", "*.pkl"),
                             recursive=True))
    assert len(files) == 222
    n_optax = 0
    for path in files:
        got = read_jax_pickle(path)
        with open(path, "rb") as f:
            ref = pickle.load(f)
        _same(got, ref, os.path.relpath(path, RESULTS))
        with open(path, "rb") as f:
            n_optax += b"optax" in f.read()
        if isinstance(ref, dict) and "params" in ref:
            _same(jax_params(path), ref["params"], path)
    assert n_optax == 181


def _pickle_calling(module, name, arg):
    """Protocol-0 bytes that call ``module.name(arg)`` when loaded."""
    return (f"c{module}\n{name}\n(S'{arg}'\ntR.").encode()


@pytest.mark.parametrize("module,name,arg", [
    ("os", "system", "true"),
    ("posix", "system", "true"),
    ("builtins", "eval", "1 + 1"),
    ("mdgrad_tpu_torch.train.checkpoint", "JaxRecord", "x"),
    ("mdgrad_tpu_torch.train.checkpoint", "FitCheckpointer", ""),
    ("pathlib", "Path", "x"),
])
def test_foreign_globals_are_refused(tmp_path, module, name, arg):
    """Any global outside numpy's arrays and the five JAX-stack packages
    is refused with an UnpicklingError that names it, before it is
    called; ``mdgrad_tpu_torch`` is not ``mdgrad_tpu``."""
    path = tmp_path / "bad.pkl"
    path.write_bytes(_pickle_calling(module, name, arg))
    with pytest.raises(pickle.UnpicklingError,
                       match=f"{module}.{name}".replace(".", r"\.")):
        read_jax_pickle(str(path))
    with pytest.raises(pickle.UnpicklingError):
        jax_params(str(path), "nn")


def test_jax_stack_classes_are_inert_records(tmp_path):
    """A global of the JAX stack becomes a record of its name, even where
    no such module exists: called, it keeps its arguments; given state,
    it keeps it; nothing is imported."""
    data = (b"(dS'params'\n(dS'nn'\ncoptax.not_a_module\nAdamLike\n"
            b"(S'a'\nI1\ntR(dS'k'\nI2\nsbss"
            b"S'fn'\ncjax.numpy\narray\n(I3\ntRs.")
    path = tmp_path / "rec.pkl"
    path.write_bytes(data)
    blob = read_jax_pickle(str(path))
    rec = blob["params"]["nn"]
    assert isinstance(rec, JaxRecord)
    assert rec.jax_global == "optax.not_a_module.AdamLike"
    assert rec.args == ("a", 1) and rec.state == {"k": 2}
    assert blob["fn"].jax_global == "jax.numpy.array"
    assert blob["fn"].args == (3,)
    assert "optax.not_a_module" not in sys.modules
    assert jax_params(str(path), "nn") is not rec    # a fresh read
    assert jax_params(str(path), "nn").args == ("a", 1)


# the JAX a-Si diagnostic's model settings at size 2 (64 sites) on the
# 'table' path: a 10.86 A box holds 2 cells of the 5.0 A cutoff a side,
# and the cell list needs 3
SI_SIZE2 = ["-size", "2", "-nbr_mode", "table"]


def test_trained_si_schnet_matches_jax():
    """The trained a-Si SchNet (64/128, 3 convolutions, 40 Gaussians)
    from ``fit-ckpt-5699.pkl``: the port's stack gives the JAX stack's
    energy (to 2e-6 of it) and forces (to 1e-5 of the largest) in float32
    on the 64-site lattice displaced by 0.1 A (one seed), the prior
    included; the checkpoint's prior is the one the build makes."""
    diag = load_script("diag_si4k_torch.py")
    args = diag.parse_args(SI_SIZE2 + ["-device", "cpu"])
    assignments, sys_params = diag.diag_config(args)
    built = fit_rdf.build_fit(assignments, sys_params,
                              registry=exp_rdf_data_dict,
                              rng=np.random.default_rng(0), device="cpu")
    assert load_schnet_checkpoint(built["net"], SI_CKPT) == 5699
    stack = built["sims"][0].integrator.model
    system = built["systems"][0]
    q = system.get_positions() + np.random.default_rng(7).normal(
        0.0, 0.1, (64, 3))

    built_j = fit_rdf_j.build_fit(assignments, sys_params,
                                  registry=registry_j,
                                  rng=np.random.default_rng(0))
    params_j = jax.tree_util.tree_map(jnp.asarray,
                                      read_jax_pickle(SI_CKPT)["params"])
    stack_j = built_j["sims"][0].integrator.model
    prior = {k: v.detach().numpy() for k, v in
             stack.models["pair"].model.state_dict().items()}
    assert prior == pytest.approx(
        {k: np.asarray(v) for k, v in params_j["pair"].items()})
    q_j = jnp.asarray(q, jnp.float32)
    aux_j = stack_j.aux_init(q_j)
    e_j, g_j = jax.value_and_grad(
        lambda x: stack_j.energy(params_j, x, aux_j))(q_j)

    x = torch.tensor(q, dtype=torch.float32, requires_grad=True)
    e = stack.energy(x, stack.aux_init(x.detach()))
    (g,) = torch.autograd.grad(e, x)
    e_j, f_j = float(e_j), -np.asarray(g_j)
    assert abs(e.item() - e_j) <= 2e-6 * abs(e_j)
    scale = np.abs(f_j).max()
    assert scale > 0.1
    np.testing.assert_allclose(-g.numpy(), f_j, rtol=0, atol=1e-5 * scale)


def test_run_difftre_init_pkl_grafts_pairnn_as_jax(capsys, tmp_path):
    """``run_difftre_torch.py -init_pkl``: the MLP takes the pickle's
    ``params['pairnn']`` and gives the JAX PairMLP's u(r) under the JAX
    script's graft (to 1e-6 of the largest |u|); the dry run starts from
    it and runs; ``-init_pt`` and ``-init_pkl`` exclude each other."""
    script = load_script("run_difftre_torch.py")
    kw = dict(n_gauss=int(2.5 // 0.1), r_start=0.0, r_end=2.5, n_width=128,
              n_layers=3, nonlinear="SELU")
    net = mt.PairMLP(**kw, device="cpu")
    script.load_init_pkl(net, LJ_BEST)
    with open(LJ_BEST, "rb") as f:
        src = pickle.load(f)
    src = src["params"] if "params" in src else src
    r = np.linspace(0.6, 2.5, 64, dtype=np.float32)[:, None]
    u_j = np.asarray(PairMLPJ(**kw)(jax.device_put(src["pairnn"]),
                                    jnp.asarray(r)))
    with torch.no_grad():
        u = net(torch.tensor(r)).numpy()
    np.testing.assert_allclose(u, u_j, rtol=0,
                               atol=1e-6 * np.abs(u_j).max())

    history = script.main(["--dry_run", "-device", "cpu", "-init_pkl",
                           LJ_BEST, "-logdir", str(tmp_path / "d")])
    assert f"warm start from {LJ_BEST}" in capsys.readouterr().out
    assert history and all(np.isfinite(h["loss"]) for h in history)
    with pytest.raises(SystemExit):
        script.main(["--dry_run", "-init_pt", "x.pt", "-init_pkl", LJ_BEST])


def test_run_npt_fit_init_pkl_takes_the_whole_tree_as_jax(capsys,
                                                          tmp_path):
    """``run_npt_fit_torch.py -init_pkl`` takes the pickle's whole
    parameter tree, as the JAX script does: in reduced mode the LJ pair's
    sigma and epsilon (its energy equals the JAX pair's under that tree,
    to 1e-6), in water mode a water fit's checkpoint (the SchNet and the
    prior, every weight equal); the dry run starts from it."""
    script = load_script("run_npt_fit_torch.py")
    tree = {"sigma": np.asarray(1.013, np.float32),
            "epsilon": np.asarray(0.912, np.float32)}
    pkl = tmp_path / "lj.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"params": tree, "epoch": 3}, f)
    system = fit_rdf.get_system("lj_0.845_1.2", 3, pair_data_dict,
                                rng=np.random.default_rng(0))
    system_j = fit_rdf_j.get_system("lj_0.845_1.2", 3, pair_data_dict_j,
                                    rng=np.random.default_rng(0))
    pair = mt.PairPotentials(system, mt.potentials.LennardJones(
        sigma=0.92, epsilon=0.7), cutoff=2.5, mode="dense", device="cpu")
    script.load_init_pkl(pair, str(pkl))
    q = system.get_positions()
    pair_j = PairPotentialsJ(system_j, potentials_j.LennardJones(0.92, 0.7),
                             cutoff=2.5)
    x = torch.tensor(q, dtype=torch.float32)
    e = pair.energy(x, pair.aux_init(x)).item()
    q_j = jnp.asarray(q, jnp.float32)
    e_j = float(pair_j.energy(jax.device_put(tree), q_j,
                              pair_j.aux_init(q_j)))
    assert abs(e - e_j) <= 1e-6 * abs(e_j)

    # water mode: the checkpoint's {'nn', 'pair'} into the script's stack
    water = fit_rdf.get_system("H20_298K_redd", 2, exp_rdf_data_dict,
                               rng=np.random.default_rng(0))
    gnn = mt.SchNet({"n_atom_basis": 128, "n_filters": 128,
                     "n_gaussians": 30, "n_convolutions": 2, "cutoff": 6.0,
                     "compute_dtype": "bf16"})
    stack = mt.Stack({
        "nn": mt.GNNPotentials(water, gnn, cutoff=6.0, nbr_mode="table",
                               capacity_slack=1.6, device="cpu"),
        "pair": mt.PairPotentials(water, mt.potentials.ExcludedVolume(
            epsilon=0.010637550996566496, sigma=2.61227614490785,
            power=12), cutoff=6.0, device="cpu")})
    script.load_init_pkl(stack, WATER_CKPT)
    src = read_jax_pickle(WATER_CKPT)["params"]
    ref = schnet_params_from_numpy(src["nn"])
    assert all(torch.equal(v, ref[k]) for k, v in gnn.state_dict().items())
    prior = stack.models["pair"].model
    assert prior.sigma.item() == float(src["pair"]["sigma"])
    assert prior.epsilon.item() == float(src["pair"]["epsilon"])

    out = script.main(["--dry_run", "-device", "cpu", "-init_pkl", str(pkl),
                       "-logdir", str(tmp_path / "npt")])
    assert f"warm start from {pkl}" in capsys.readouterr().out
    assert np.isfinite(out["rho_best_eval"])


def test_si_transfer_dry_run_from_the_jax_checkpoint(tmp_path):
    """``si_transfer_torch.py`` defaults to the JAX script's checkpoint
    and its dry run (64 sites, 'table') samples from it: the SchNet holds
    the checkpoint's ``params['nn']``."""
    transfer = load_script("si_transfer_torch.py")
    assert transfer.parse_args([]).ckpt == \
        "results/si_r2/0/fit-ckpt-5699.pkl"
    logs = []
    res = transfer.main(["--dry_run", "-device", "cpu", "-ckpt", SI_CKPT,
                         "-logdir", str(tmp_path / "4k")], log=logs.append)
    assert f"loaded {SI_CKPT} (epoch 5699)" in logs
    assert res["n_atoms"] == 64 and np.isfinite(res["mse"])
    ref = schnet_params_from_numpy(read_jax_pickle(SI_CKPT)["params"]["nn"])
    net = res["sim"].integrator.model.models["nn"].gnn
    assert all(torch.equal(v, ref[k]) for k, v in net.state_dict().items())
