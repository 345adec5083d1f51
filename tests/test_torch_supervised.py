"""The port's supervised stack (``SchNet.batched_energy`` /
``batched_predict``, ``train/supervised.py``, ``train/builders.py``)
against the JAX package's, mirroring tests/test_supervised.py.

The JAX SchNet is not float64 throughout even under
``jax.enable_x64(True)``: its Gaussian centres and widths are float32
constants and its dense layers compute in ``compute_dtype`` (float32 by
default).  The float64 comparisons here build the JAX model with
``compute_dtype=jnp.float64`` and widen the smearing's constants (the
``widened_smearing`` fixture); what stays float32 is each convolution's
output (``mdgrad_tpu/nn/schnet.py``'s ``.astype(jnp.float32)``), which
bounds the agreement at ~1e-8 relative.  Single evaluations compare in
float32.
"""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdgrad_tpu.nn.schnet as schnet_j
from mdgrad_tpu.data.dataset import Dataset as DatasetJ
from mdgrad_tpu.data.dataset import split_train_validation_test as split_j
from mdgrad_tpu.data.loader import DataLoader as DataLoaderJ
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.train import builders as builders_j
from mdgrad_tpu.train import supervised as sup_j
from mdgrad_tpu_torch.data.dataset import (Dataset,
                                           split_train_validation_test)
from mdgrad_tpu_torch.data.loader import DataLoader
from mdgrad_tpu_torch.nn import SchNet
from mdgrad_tpu_torch.nn.convert import schnet_params_from_numpy
from mdgrad_tpu_torch.train import builders, supervised as sup
from test_torch_dataset import make_lj_dataset

MP = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
      "n_convolutions": 1, "cutoff": 3.0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def widened_smearing(monkeypatch):
    """The JAX SchNet's Gaussian centres and widths in the distances'
    dtype (they are float32 constants there)."""
    orig = schnet_j.gaussian_smearing
    monkeypatch.setattr(
        schnet_j, "gaussian_smearing",
        lambda d, o, w, centered=False: orig(d, o.astype(d.dtype),
                                             w.astype(d.dtype), centered))


def _data(cls, loader_cls, split, n_geoms=24, batch_size=6):
    ds = make_lj_dataset(cls, n_geoms)
    ds.generate_neighbor_list(3.0)
    train, val, _ = split(ds, 0.2, 0.0, seed=1)
    return (loader_cls(train, batch_size=batch_size, seed=1),
            loader_cls(val, batch_size=batch_size, shuffle=False))


def _models(mp=MP, f64=False):
    """(JAX SchNet, its params, the port's SchNet with the same weights);
    float64 on both sides with ``f64``."""
    model_j = SchNetJ({**mp, "compute_dtype": jnp.float64} if f64 else mp)
    params = SchNetJ(mp).init_params(jnp.ones(8, dtype=jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = SchNet(mp)
    model.load_state_dict(schnet_params_from_numpy(tree))
    if f64:
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), tree)
        model = model.double()
    return model_j, params, model


def _f64_batch(b):
    return {k: (v.astype(jnp.float64) if jnp.issubdtype(v.dtype,
                                                         jnp.floating)
                else v) for k, v in b.items()}


def _ragged_batch():
    """A padded batch of 4 geometries of 8-10 atoms, padded atoms and
    padded pair rows in every molecule but the largest."""
    ds = make_lj_dataset(DatasetJ, 8)
    ds.generate_neighbor_list(3.0)
    batch = next(iter(DataLoaderJ(ds, batch_size=4, shuffle=False)))
    assert (~batch["atom_mask"]).any() and (~batch["nbr_mask"]).any()
    return batch


def test_batched_predict_matches_jax_vmap_f32():
    """Energies and +dU/dxyz of the disjoint-graph batch equal the JAX
    ``vmap`` of the one-molecule model (float32: energy atol 2e-6 with
    |E| ~ 1.3, energy_grad 1e-6 of its largest entry); zero on padded
    atoms."""
    batch = _ragged_batch()
    model_j, params, model = _models()
    ref = jax.jit(model_j.batched_predict)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():   # evaluation: no graph kept
        got = model.batched_predict(sup.batch_to_tensors(batch, "cpu"))
    e_ref, g_ref = np.asarray(ref["energy"]), np.asarray(ref["energy_grad"])
    np.testing.assert_allclose(got["energy"].numpy(), e_ref, rtol=0,
                               atol=2e-6)
    scale = np.abs(g_ref).max()
    np.testing.assert_allclose(got["energy_grad"].numpy(), g_ref, rtol=0,
                               atol=1e-6 * scale)
    assert not got["energy"].requires_grad
    assert (got["energy_grad"].numpy()[~batch["atom_mask"]] == 0).all()
    # one molecule alone gives its own row: no message crosses molecules
    one = {k: v[1:2] for k, v in batch.items()}
    with torch.no_grad():
        alone = model.batched_predict(sup.batch_to_tensors(one, "cpu"))
    np.testing.assert_allclose(alone["energy"].numpy(),
                               got["energy"].numpy()[1:2], rtol=1e-6)


def test_batched_predict_f64_and_its_parameter_gradient(widened_smearing):
    """In float64 the energies and forces agree to the JAX model's float32
    convolution outputs (rtol 1e-7), and so does the force loss's gradient
    in the parameters (grad-of-grad through the batched pair path, 1e-6
    of each tensor's largest entry)."""
    batch = _ragged_batch()
    coef = {"energy": 0.1, "energy_grad": 1.0}
    with jax.enable_x64(True):
        model_j, params, model = _models(f64=True)
        bj = {k: jnp.asarray(v) for k, v in batch.items()}
        ref = jax.jit(model_j.batched_predict)(params, _f64_batch(bj))
        loss_j = sup_j.build_mse_loss(coef)

        def loss(p):
            return loss_j(bj, model_j.batched_predict(p, _f64_batch(bj)))
        l_ref, g_ref = jax.jit(jax.value_and_grad(loss))(params)
        g_ref = schnet_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                g_ref))
    b = sup.batch_to_tensors(batch, "cpu", torch.float64)
    got = model.batched_predict(b)
    np.testing.assert_allclose(got["energy"].detach().numpy(),
                               np.asarray(ref["energy"]), rtol=1e-7)
    np.testing.assert_allclose(got["energy_grad"].detach().numpy(),
                               np.asarray(ref["energy_grad"]), rtol=0,
                               atol=1e-7 * np.abs(ref["energy_grad"]).max())
    assert got["energy_grad"].requires_grad   # the graph for the loss
    loss_p = sup.build_mse_loss(coef)(b, got)
    np.testing.assert_allclose(loss_p.item(), float(l_ref), rtol=1e-7)
    loss_p.backward()
    for name, p in model.named_parameters():
        ref_g = g_ref[name].numpy()
        torch.testing.assert_close(p.grad, torch.from_numpy(ref_g).double(),
                                   rtol=0,
                                   atol=1e-6 * max(np.abs(ref_g).max(),
                                                   1e-30),
                                   msg=name)


def test_mse_loss_nan_and_batch_weight_match_jax():
    """NaN targets and batch-fill repeats (weight 0) leave numerator and
    denominator alike; the loss equals JAX's (float32, rtol 1e-6)."""
    batch = _ragged_batch()
    rng = np.random.default_rng(2)
    batch["energy_grad"][0, 1, 2] = np.nan
    batch["energy"][2] = np.nan
    batch["batch_weight"][3] = 0.0
    preds = {"energy": rng.normal(size=4).astype(np.float32),
             "energy_grad": rng.normal(size=batch["xyz"].shape).astype(
                 np.float32)}
    coef = {"energy": 0.3, "energy_grad": 1.0}
    ref = sup_j.build_mse_loss(coef)(
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in preds.items()})
    got = sup.build_mse_loss(coef)(
        sup.batch_to_tensors(batch, "cpu"),
        {k: torch.from_numpy(v) for k, v in preds.items()})
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    # the weighted-out molecule does not move the loss
    preds["energy_grad"][3] += 100.0
    again = sup.build_mse_loss(coef)(
        sup.batch_to_tensors(batch, "cpu"),
        {k: torch.from_numpy(v) for k, v in preds.items()})
    assert float(again) == float(got)
    assert sup.mae([1.0, 3.0], [0.0, 0.0]) == sup_j.mae([1.0, 3.0],
                                                        [0.0, 0.0]) == 2.0
    assert sup.rmse(torch.tensor([3.0, 4.0]), [0.0, 0.0], [True, False]) \
        == sup_j.rmse([3.0, 4.0], [0.0, 0.0], [True, False]) == 3.0


class _History(sup.Hook):
    """Records (epoch, train loss, val loss, lr) at each validation."""

    def __init__(self):
        self.rows = []

    def on_validation_end(self, trainer, val_loss):
        self.rows.append((trainer.epoch, trainer.last_train_loss, val_loss,
                          trainer.get_lr()))


def test_trainer_three_epochs_match_jax_f64(tmp_path, widened_smearing):
    """A 3-epoch ``Trainer`` run (Adam at 3e-3, a plateau hook that halves
    the rate after epoch 1) from the same weights and loaders: the loss
    history equals JAX's to rtol 1e-6 and the final parameters to 1e-6 of
    each tensor's largest entry (the JAX model's float32 convolution
    outputs set that)."""
    coef = {"energy": 0.1, "energy_grad": 1.0}
    with jax.enable_x64(True):
        model_j, params, model = _models(f64=True)
        train_j, val_j = _data(DatasetJ, DataLoaderJ, split_j)
        hist_j = _History()
        hooks_j = [sup_j.ReduceLROnPlateauHook(patience=0, factor=0.5),
                   hist_j]
        trainer_j = sup_j.Trainer(
            str(tmp_path / "jax"),
            lambda p, b: model_j.batched_predict(p, _f64_batch(b)), params,
            sup_j.build_mse_loss(coef), train_j, val_j, lr=3e-3,
            hooks=hooks_j)
        trainer_j.train(n_epochs=3)
        final_j = schnet_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, trainer_j.params))
    train, val = _data(Dataset, DataLoader, split_train_validation_test)
    hist = _History()
    trainer = sup.Trainer(str(tmp_path / "port"), model,
                          sup.build_mse_loss(coef), train, val, lr=3e-3,
                          hooks=[sup.ReduceLROnPlateauHook(patience=0,
                                                           factor=0.5),
                                 hist])
    trainer.train(n_epochs=3)
    assert trainer.step == trainer_j.step and trainer.epoch == 3
    rows, rows_j = np.array(hist.rows), np.array(hist_j.rows)
    assert rows.shape == rows_j.shape == (3, 4)
    np.testing.assert_allclose(rows, rows_j, rtol=1e-6)
    assert rows[-1, 3] < rows[0, 3] or rows[-1, 2] < rows[0, 2]
    for name, p in model.state_dict().items():
        ref = final_j[name].numpy()
        np.testing.assert_allclose(p.numpy(), ref, rtol=0,
                                   atol=1e-6 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=name)


def test_schnet_trains_on_lj_data(tmp_path):
    """tests/test_supervised.py's run from the JAX test's own initial
    weights: at its lr 3e-3 the validation loss jumps from epoch to epoch
    (on these weights it ends below its start, as in JAX); its best epoch
    lies well below the first."""
    train_loader, val_loader = _data(Dataset, DataLoader,
                                     split_train_validation_test)
    mp = {"n_atom_basis": 32, "n_filters": 32, "n_gaussians": 16,
          "n_convolutions": 2, "cutoff": 3.0}
    model = builders.get_model(mp, "SchNet", device="cpu")
    model.load_state_dict(schnet_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, SchNetJ(mp).init_params(jnp.ones(8, dtype=jnp.int32)))))
    trainer = builders.get_trainer(model, train_loader, val_loader,
                                   str(tmp_path), lr=3e-3, max_epochs=12,
                                   patience=50, log=lambda *a: None)
    hist = _History()
    trainer.hooks.append(hist)
    trainer.train()
    losses = [r[2] for r in hist.rows]
    assert len(losses) == 12 and losses[-1] < losses[0], losses
    assert min(losses) < 0.8 * losses[0], losses
    for f in ("best_model.pt", "log.csv", "checkpoint-12.pt"):
        assert os.path.exists(os.path.join(str(tmp_path), f)), f
    res = sup.evaluate(model, val_loader)
    assert "energy" in res and "energy_grad" in res
    assert np.isfinite(res["energy"]["mae"])


def test_evaluate_matches_jax():
    """``evaluate`` over the same weights and loader: MAE and RMSE of
    both keys equal JAX's (float32, rtol 1e-5)."""
    model_j, params, model = _models()
    _, val_j = _data(DatasetJ, DataLoaderJ, split_j)
    _, val = _data(Dataset, DataLoader, split_train_validation_test)
    ref = sup_j.evaluate(jax.jit(model_j.batched_predict), params, val_j)
    got = sup.evaluate(model, val)
    assert got.keys() == ref.keys() == {"energy", "energy_grad"}
    for k in got:
        for m in ("mae", "rmse"):
            np.testing.assert_allclose(got[k][m], ref[k][m], rtol=1e-5)


def test_checkpoint_restore_and_resume_equals_uninterrupted(tmp_path):
    """A trainer at a path with checkpoints resumes from the newest (epoch,
    step, model and Adam state, read with ``weights_only=True``), and two
    epochs then two more give the bits of four in one go; three
    checkpoints are kept."""
    ds = make_lj_dataset(Dataset, 12)
    ds.generate_neighbor_list(3.0)
    small = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
             "n_convolutions": 1, "cutoff": 3.0}

    def run(path, loader, max_epochs, model):
        t = builders.get_trainer(model, loader, loader, str(path),
                                 max_epochs=max_epochs, log=lambda *a: None)
        return t

    loader = DataLoader(ds, batch_size=6, seed=1)
    m1 = builders.get_model(small, device="cpu")
    t1 = run(tmp_path / "a", loader, 2, m1)
    t1.train()
    assert t1.epoch == 2
    blob = torch.load(str(tmp_path / "a" / "checkpoint-2.pt"),
                      weights_only=True)
    assert blob["epoch"] == 2 and blob["step"] == t1.step
    m2 = builders.get_model(small, device="cpu")
    t2 = run(tmp_path / "a", loader, 4, m2)
    assert t2.epoch == 2 and t2.step == t1.step
    t2.train()
    assert t2.epoch == 4
    ckpts = sorted(os.listdir(tmp_path / "a"))
    assert [c for c in ckpts if c.startswith("checkpoint-")] == [
        "checkpoint-2.pt", "checkpoint-3.pt", "checkpoint-4.pt"]
    m3 = builders.get_model(small, device="cpu")
    t3 = run(tmp_path / "b", DataLoader(ds, batch_size=6, seed=1), 4, m3)
    t3.train()
    for (name, a), b in zip(m2.state_dict().items(),
                            m3.state_dict().values()):
        assert torch.equal(a, b), name


def test_frozen_prefixes_freeze_by_name(tmp_path):
    """``frozen_prefixes`` leave the named subtrees untouched (the JAX
    package's optax labels on the top-level keys)."""
    train_loader, val_loader = _data(Dataset, DataLoader,
                                     split_train_validation_test, 12)
    model = builders.get_model(MP, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = sup.Trainer(str(tmp_path), model,
                          sup.build_mse_loss({"energy": 0.1,
                                              "energy_grad": 1.0}),
                          train_loader, val_loader,
                          frozen_prefixes=("embedding", "convs.0"))
    trainer.train(n_epochs=1)
    for name, v in model.state_dict().items():
        frozen = name.startswith(("embedding.", "convs.0."))
        assert torch.equal(v, before[name]) == frozen, name


def test_save_load_model_and_the_jax_model_file(tmp_path):
    """``save_model`` / ``load_model`` round trip (.pt), a trainer's bare
    ``best_model.pt``, and the JAX script's ``model.pkl`` (numpy and
    builtins) loaded into the port, predicting as JAX does (float32,
    1e-6 of the largest force)."""
    model_params = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
                    "n_convolutions": 1, "cutoff": 3.0}
    model = builders.get_model(model_params, device="cpu", seed=3)
    path = os.path.join(str(tmp_path), "model.pt")
    builders.save_model(path, "SchNet", {**model_params,
                                         "energy_shift": 1.5}, model)
    model2, mp2 = builders.load_model(path, device="cpu")
    assert model2.cutoff == 3.0 and mp2["energy_shift"] == 1.5
    for a, b in zip(model.state_dict().values(),
                    model2.state_dict().values()):
        assert torch.equal(a, b)
    torch.save(model.state_dict(), os.path.join(str(tmp_path), "best.pt"))
    none, state = builders.load_model(os.path.join(str(tmp_path), "best.pt"),
                                      device="cpu")
    assert none is None and state.keys() == model.state_dict().keys()
    # the JAX package's file
    model_j = builders_j.get_model(model_params, "SchNet")
    params = model_j.init_params(jnp.ones(4, dtype=jnp.int32))
    pkl = os.path.join(str(tmp_path), "model.pkl")
    builders_j.save_model(pkl, "SchNet", {**model_params,
                                          "energy_shift": -2.0}, params)
    model3, mp3 = builders.load_model(pkl, device="cpu")
    assert mp3["energy_shift"] == -2.0
    batch = _ragged_batch()
    ref = jax.jit(model_j.batched_predict)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = model3.batched_predict(sup.batch_to_tensors(batch, "cpu"))
    np.testing.assert_allclose(
        got["energy_grad"].numpy(), np.asarray(ref["energy_grad"]), rtol=0,
        atol=1e-6 * np.abs(np.asarray(ref["energy_grad"])).max())
    with open(pkl, "wb") as f:   # a pickle holding a class is refused
        pickle.dump({"model_type": "SchNet", "obj": SchNet}, f)
    with pytest.raises(pickle.UnpicklingError):
        builders.load_model(pkl, device="cpu")


def test_get_model_validation():
    with pytest.raises(ValueError):
        builders.get_model({}, "NotAModel", device="cpu")
    with pytest.raises(TypeError):
        builders.get_model({"n_atom_basis": "wrong", "n_filters": 16,
                            "n_gaussians": 8, "n_convolutions": 1,
                            "cutoff": 3.0}, "SchNet", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            builders.get_model(MP)   # the card by default


class FakeTrainer:
    def __init__(self, lr=1e-3):
        self.lr, self.epoch, self.step, self.stop = lr, 0, 0, False
        self.last_train_loss = 0.5

    def get_lr(self):
        return self.lr

    def set_lr(self, v):
        self.lr = float(v)


def _events(hook, trainer, vals):
    """Drive ``hook`` through epochs of validation losses ``vals``; the
    (lr, stop) after each."""
    out = []
    hook.on_train_begin(trainer)
    for v in vals:
        hook.on_epoch_begin(trainer)
        trainer.step += 2
        hook.on_batch_end(trainer, v)
        hook.on_validation_end(trainer, v)
        trainer.epoch += 1
        hook.on_epoch_end(trainer)
        out.append((trainer.lr, trainer.stop))
    return out


VALS = [1.0, 0.9, 0.95, 0.95, 0.96, 0.8, 0.85, 0.9, 0.91, 0.92, 0.93]


@pytest.mark.parametrize("name,kw", [
    ("MaxEpochHook", {"max_epochs": 4}),
    ("MaxStepHook", {"max_steps": 7}),
    ("EarlyStoppingHook", {"patience": 2}),
    ("ReduceLROnPlateauHook", {"patience": 1, "factor": 0.5,
                               "min_lr": 2e-4, "stop_after_min": True}),
    ("WarmRestartHook", {"T0": 3, "T_mult": 2, "lr_min": 1e-6,
                         "lr_factor": 0.5, "patience": 1}),
    ("ExponentialDecayHook", {"gamma": 0.8, "min_lr": 4e-4}),
    ("LRScheduleHook", {"schedule": lambda c: 0.1 * 0.5 ** c}),
    ("LRScheduleHook", {"schedule": lambda c: 1.0 / (1 + c),
                        "each_step": True}),
])
def test_hook_matches_jax(name, kw):
    """Each scheduling hook gives JAX's learning rates and stop flags on
    the same sequence of validation losses (exact)."""
    got = _events(getattr(sup, name)(**kw), FakeTrainer(), VALS)
    ref = _events(getattr(sup_j, name)(**kw), FakeTrainer(), VALS)
    assert got == ref


def test_warm_restart_hook_cosine_cycle():
    t = FakeTrainer()
    h = sup.WarmRestartHook(T0=4, T_mult=2, lr_min=1e-6)
    lrs = []
    for _ in range(4):
        h.on_epoch_begin(t)
        lrs.append(t.lr)
    assert lrs[0] == pytest.approx(1e-3) and lrs[-1] < lrs[0]
    h.on_validation_end(t, 1.0)
    assert h.T == 8 and h.epoch_in_cycle == 0
    h.on_epoch_begin(t)
    assert t.lr == pytest.approx(1e-3)


def test_prioritized_sampler_and_hook():
    from mdgrad_tpu_torch.data.loader import PrioritizedSampler
    smp = PrioritizedSampler(10, seed=0)
    hook = sup.UpdatePrioritiesHook(smp)
    batch = {"_idx": np.array([3, 4])}
    hook.on_batch_end(None, 100.0, batch)
    assert smp.weights[3] == 100.0 and smp.weights[4] == 100.0
    assert np.isin(smp.sample(2000), [3, 4]).mean() > 0.9
    sup.UpdatePrioritiesHook(smp, lambda b, l: torch.tensor([1.0, 2.0])
                             ).on_batch_end(None, 0.0, batch)
    assert smp.weights[4] == 2.0
    hook.on_batch_end(None, 5.0, {})   # no _idx: nothing to do
    assert smp.weights[3] == 1.0


def test_logging_hooks_write_what_jax_writes(tmp_path):
    """Tensorboard (its JSONL fallback without the tensorboard package),
    Printing and CSV write the rows JAX's hooks write."""
    t = FakeTrainer()
    t.epoch = 2
    for mod, tag in ((sup, "port"), (sup_j, "jax")):
        path = str(tmp_path / tag)
        h = mod.TensorboardHook(path)
        h.on_epoch_end(t)
        h.on_validation_end(t, 0.25)
        h.on_train_ends(t)
        assert os.listdir(path), "no tensorboard/jsonl output written"
        lines = []
        mod.PrintingHook(log=lines.append).on_validation_end(t, 0.25)
        csv_hook = mod.CSVHook(path)
        csv_hook.on_train_begin(t)
        csv_hook.on_validation_end(t, 0.25)
        with open(os.path.join(path, "log.csv")) as f:
            rows = [r.split(",")[1:] for r in f.read().splitlines()]
        files = sorted(f.split(".tfevents")[0] for f in os.listdir(path))
        if tag == "port":
            port = (files, lines, rows)
    assert port == (files, lines, rows)


def test_trainer_takes_an_optimizer_and_matches_jax_f64(tmp_path,
                                                        widened_smearing):
    """``Trainer(optimizer=...)``: SGD with momentum 0.9 (a factory over
    the trainable parameters, the embedding frozen) for 2 epochs from the
    same weights and loaders equals the JAX ``Trainer`` given
    ``optax.sgd(lr, momentum=0.9)`` with its ``Embed_0`` frozen: the loss
    history to rtol 1e-6, the final parameters to 1e-6 of each tensor's
    largest entry (the JAX model's float32 convolution outputs set that),
    the frozen embedding unchanged."""
    import optax
    coef = {"energy": 0.1, "energy_grad": 1.0}
    lr = 1e-5
    with jax.enable_x64(True):
        model_j, params, model = _models(f64=True)
        train_j, val_j = _data(DatasetJ, DataLoaderJ, split_j)
        hist_j = _History()
        trainer_j = sup_j.Trainer(
            str(tmp_path / "jax"),
            lambda p, b: model_j.batched_predict(p, _f64_batch(b)), params,
            sup_j.build_mse_loss(coef), train_j, val_j,
            optimizer=optax.inject_hyperparams(optax.sgd)(
                learning_rate=lr, momentum=0.9),
            hooks=[hist_j], frozen_prefixes=("Embed_0",))
        trainer_j.train(n_epochs=2)
        final_j = schnet_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, trainer_j.params))
    train, val = _data(Dataset, DataLoader, split_train_validation_test)
    hist = _History()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = sup.Trainer(
        str(tmp_path / "port"), model, sup.build_mse_loss(coef), train, val,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=lr, momentum=0.9),
        hooks=[hist], frozen_prefixes=("embedding",))
    assert isinstance(trainer.optimizer, torch.optim.SGD)
    trainer.train(n_epochs=2)
    assert trainer.step == trainer_j.step and trainer.epoch == 2
    rows, rows_j = np.array(hist.rows), np.array(hist_j.rows)
    assert rows.shape == rows_j.shape == (2, 4)
    np.testing.assert_allclose(rows, rows_j, rtol=1e-6)
    for name, p in model.state_dict().items():
        ref = final_j[name].numpy()
        np.testing.assert_allclose(p.numpy(), ref, rtol=0,
                                   atol=1e-6 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=name)
        frozen = name.startswith("embedding.")
        assert torch.equal(p, start[name]) == frozen, name
