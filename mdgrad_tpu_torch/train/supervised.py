"""Supervised force-field training: Trainer, hooks, losses, metrics.

Port of ``mdgrad_tpu/train/supervised.py``: ``build_mse_loss`` with
per-key coefficients, NaN masking and the loader's ``batch_weight``;
``mae`` and ``rmse``; the hooks (``MaxEpochHook``, ``MaxStepHook``,
``EarlyStoppingHook``, ``ReduceLROnPlateauHook``, ``WarmRestartHook``,
``ExponentialDecayHook``, ``LRScheduleHook``, ``UpdatePrioritiesHook``,
``TensorboardHook``, ``PrintingHook``, ``CSVHook``); the ``Trainer``
with its epoch loop, validation, best-model file and rotating
checkpoints; ``evaluate``.

Where the JAX package threads a params pytree and an optax state, the
port trains the model's own parameters: the model is an ``nn.Module``
whose ``batched_predict(batch)`` (``nn/schnet.py``, ``nn/glue.py``)
gives the predictions.  The optimizer is ``torch.optim.Adam`` with
optax's defaults (betas 0.9 / 0.999, eps 1e-8, bias-corrected); its
learning rate is read and set at run time (``get_lr`` / ``set_lr``), as
``optax.inject_hyperparams`` lets the JAX hooks do.  ``frozen_prefixes``
freezes every parameter whose dotted name starts with one of them
(``requires_grad_(False)``), where JAX labels the subtrees for
``optax.multi_transform``.  Checkpoints are ``checkpoint-<epoch>.pt``,
the best model ``best_model.pt``: ``torch.save`` of state_dicts, which
``torch.load(weights_only=True)`` reads (the JAX package pickles
``.pkl`` files).  A loader's numpy batch goes to the model's device,
its floating arrays in the parameters' dtype.
"""

import csv
import glob
import json
import os
import time

import numpy as np
import torch


# ---------------------------------------------------------------------------
# batches, losses & metrics
# ---------------------------------------------------------------------------

def batch_to_tensors(batch, device, dtype=torch.float32):
    """A loader's numpy batch as tensors on ``device``: floating arrays in
    ``dtype``, integers as int64, booleans as they are."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(np.asarray(value))
        if t.is_floating_point():
            t = t.to(dtype)
        elif t.dtype != torch.bool:
            t = t.long()
        out[key] = t.to(device)
    return out


def _param_device_dtype(model):
    p = next(p for p in model.parameters() if p.is_floating_point())
    return p.device, p.dtype


def build_mse_loss(loss_coef):
    """Weighted multi-key MSE with NaN masking.

    loss_coef: {key: coefficient}; per-atom keys are masked by
    ``atom_mask``, and the batch-filling repeats (``batch_weight`` 0)
    leave both the numerator and the denominator.
    """
    def loss_fn(batch, preds):
        loss = 0.0
        for key, coef in loss_coef.items():
            targ = batch[key]
            pred = preds[key]
            valid = torch.isfinite(targ)
            if targ.dim() >= 2 and "atom_mask" in batch:
                valid = valid & batch["atom_mask"][
                    (...,) + (None,) * (targ.dim() - 2)]
            if "batch_weight" in batch:
                w = batch["batch_weight"].reshape(
                    (-1,) + (1,) * (targ.dim() - 1))
                valid = valid & (w > 0)
            diff = torch.where(valid, pred - torch.where(valid, targ, 0.0),
                               0.0)
            loss = loss + coef * (diff ** 2).sum() / \
                valid.sum().clamp(min=1)
        return loss
    return loss_fn


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def mae(pred, targ, mask=None):
    d = np.abs(_numpy(pred) - _numpy(targ))
    if mask is not None:
        d = d[_numpy(mask)]
    return float(d.mean())


def rmse(pred, targ, mask=None):
    d = (_numpy(pred) - _numpy(targ)) ** 2
    if mask is not None:
        d = d[_numpy(mask)]
    return float(np.sqrt(d.mean()))


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------

class Hook:
    def on_train_begin(self, trainer):
        pass

    def on_epoch_begin(self, trainer):
        pass

    def on_batch_end(self, trainer, loss, batch=None):
        pass

    def on_validation_end(self, trainer, val_loss):
        pass

    def on_epoch_end(self, trainer):
        pass

    def on_train_ends(self, trainer):
        pass

    def on_train_failed(self, trainer):
        pass


class MaxEpochHook(Hook):
    def __init__(self, max_epochs):
        self.max_epochs = max_epochs

    def on_epoch_begin(self, trainer):
        if trainer.epoch >= self.max_epochs:
            trainer.stop = True


class MaxStepHook(Hook):
    def __init__(self, max_steps):
        self.max_steps = max_steps

    def on_batch_end(self, trainer, loss, batch=None):
        if trainer.step >= self.max_steps:
            trainer.stop = True


class EarlyStoppingHook(Hook):
    """Stop when validation loss hasn't improved for ``patience`` epochs."""

    def __init__(self, patience, threshold_ratio=0.0001):
        self.patience = patience
        self.threshold_ratio = threshold_ratio
        self.best = np.inf
        self.counter = 0

    def on_validation_end(self, trainer, val_loss):
        if val_loss <= (1 - self.threshold_ratio) * self.best:
            self.best = val_loss
            self.counter = 0
        else:
            self.counter += 1
        if self.counter > self.patience:
            trainer.stop = True


class ReduceLROnPlateauHook(Hook):
    """Scale the runtime LR by ``factor`` on a validation plateau."""

    def __init__(self, patience=25, factor=0.5, min_lr=1e-6,
                 window_length=1, stop_after_min=False):
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.best = np.inf
        self.counter = 0
        self.stop_after_min = stop_after_min

    def on_validation_end(self, trainer, val_loss):
        if val_loss < self.best:
            self.best = val_loss
            self.counter = 0
            return
        self.counter += 1
        if self.counter > self.patience:
            new_lr = max(trainer.get_lr() * self.factor, self.min_lr)
            trainer.set_lr(new_lr)
            self.counter = 0
            if self.stop_after_min and new_lr <= self.min_lr:
                trainer.stop = True


class WarmRestartHook(Hook):
    """Cosine-annealed LR with warm restarts: lr follows a half-cosine
    from lr_max to lr_min over T epochs; at each restart T grows by
    ``T_mult`` and lr_max by ``lr_factor``; more than ``patience`` cycles
    in a row that end worse than the best stop the run."""

    def __init__(self, T0=10, T_mult=2, lr_min=1e-6, lr_factor=1.0,
                 patience=1):
        self.T = T0
        self.T_mult = T_mult
        self.lr_min = lr_min
        self.lr_factor = lr_factor
        self.patience = patience
        self.epoch_in_cycle = 0
        self.lr_max = None
        self.best_cycle = np.inf
        self.failed_cycles = 0

    def on_epoch_begin(self, trainer):
        if self.lr_max is None:
            self.lr_max = trainer.get_lr()
        frac = min(self.epoch_in_cycle / max(self.T, 1), 1.0)
        lr = self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (
            1 + np.cos(np.pi * frac))
        trainer.set_lr(lr)
        self.epoch_in_cycle += 1

    def on_validation_end(self, trainer, val_loss):
        if self.epoch_in_cycle < self.T:
            return
        # cycle finished: restart
        self.epoch_in_cycle = 0
        self.T *= self.T_mult
        self.lr_max *= self.lr_factor
        if val_loss > self.best_cycle:
            self.failed_cycles += 1
            if self.failed_cycles > self.patience:
                trainer.stop = True
        else:
            self.best_cycle = val_loss
            self.failed_cycles = 0


class ExponentialDecayHook(Hook):
    """lr <- max(lr * gamma, min_lr) each epoch."""

    def __init__(self, gamma=0.96, min_lr=1e-6):
        self.gamma = gamma
        self.min_lr = min_lr

    def on_epoch_end(self, trainer):
        trainer.set_lr(max(trainer.get_lr() * self.gamma, self.min_lr))


class LRScheduleHook(Hook):
    """Set the LR from a schedule ``count -> lr`` (e.g.
    ``train/optim.py``'s ``cosine_decay`` times a base rate).  With
    ``each_step`` the count is ``trainer.step``, else ``trainer.epoch``."""

    def __init__(self, schedule, each_step=False):
        self.schedule = schedule
        self.each_step = each_step

    def on_epoch_begin(self, trainer):
        if not self.each_step:
            trainer.set_lr(float(self.schedule(trainer.epoch)))

    def on_batch_end(self, trainer, loss, batch=None):
        if self.each_step:
            trainer.set_lr(float(self.schedule(trainer.step)))


class UpdatePrioritiesHook(Hook):
    """Feed per-batch priorities back into a
    :class:`mdgrad_tpu_torch.data.loader.PrioritizedSampler`.
    ``priority_fn(batch, loss)`` returns one priority per example in the
    batch (default: the batch loss broadcast over its examples); the
    batch is the loader's, of numpy arrays."""

    def __init__(self, prioritized_sampler, priority_fn=None):
        self.sampler = prioritized_sampler
        self.priority_fn = priority_fn

    def on_batch_end(self, trainer, loss, batch=None):
        if batch is None or "_idx" not in batch:
            return
        idx = _numpy(batch["_idx"])
        if self.priority_fn is not None:
            pri = _numpy(self.priority_fn(batch, loss)).reshape(-1)
        else:
            pri = np.full(len(idx), float(loss))
        self.sampler.update_weights(idx, pri)


class TensorboardHook(Hook):
    """Scalar logging to TensorBoard event files through
    ``torch.utils.tensorboard`` when it can be imported, else to a JSONL
    scalar log (``scalars.jsonl``) in the same directory."""

    def __init__(self, log_path, every_n_epochs=1, log_train_loss=True,
                 log_validation_loss=True, log_learning_rate=True):
        os.makedirs(log_path, exist_ok=True)
        self.log_path = log_path
        self.every_n_epochs = every_n_epochs
        self.log_train_loss = log_train_loss
        self.log_validation_loss = log_validation_loss
        self.log_learning_rate = log_learning_rate
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(log_path)
            self._jsonl = None
        except Exception:
            self.writer = None
            self._jsonl = os.path.join(log_path, "scalars.jsonl")

    def _scalar(self, tag, value, step):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
        else:
            with open(self._jsonl, "a") as f:
                f.write(json.dumps(
                    {"tag": tag, "value": float(value), "step": step}) + "\n")

    def on_epoch_end(self, trainer):
        if trainer.epoch % self.every_n_epochs:
            return
        if self.log_train_loss:
            self._scalar("train/loss", trainer.last_train_loss,
                         trainer.epoch)
        if self.log_learning_rate:
            self._scalar("train/learning_rate", trainer.get_lr(),
                         trainer.epoch)

    def on_validation_end(self, trainer, val_loss):
        if self.log_validation_loss and \
                trainer.epoch % self.every_n_epochs == 0:
            self._scalar("train/val_loss", val_loss, trainer.epoch)

    def _close(self):
        if self.writer is not None:
            self.writer.close()

    def on_train_ends(self, trainer):
        self._close()

    def on_train_failed(self, trainer):
        self._close()


class PrintingHook(Hook):
    def __init__(self, every=1, log=print):
        self.every = every
        self.log = log

    def on_validation_end(self, trainer, val_loss):
        if trainer.epoch % self.every == 0:
            self.log(f"epoch {trainer.epoch} | train "
                     f"{trainer.last_train_loss:.6f} | val "
                     f"{val_loss:.6f} | lr {trainer.get_lr():.2e}")


class CSVHook(Hook):
    """Append per-epoch metrics to log.csv."""

    def __init__(self, log_path):
        self.path = os.path.join(log_path, "log.csv")
        os.makedirs(log_path, exist_ok=True)
        self.t0 = None

    def on_train_begin(self, trainer):
        self.t0 = time.time()
        if not os.path.exists(self.path):
            with open(self.path, "w", newline="") as f:
                csv.writer(f).writerow(
                    ["time", "epoch", "lr", "train_loss", "val_loss"])

    def on_validation_end(self, trainer, val_loss):
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(
                [time.time() - self.t0, trainer.epoch, trainer.get_lr(),
                 trainer.last_train_loss, val_loss])


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Epoch/validation loop with hooks and rotating checkpoints.

    ``model``: an ``nn.Module`` on its device whose
    ``batched_predict(batch)`` gives the predictions the loss keys name.
    ``optimizer``: a factory ``params -> torch.optim.Optimizer`` over the
    trainable parameters (those ``frozen_prefixes`` leave); by default
    Adam at ``lr``, the JAX ``Trainer``'s default optax transformation.
    A checkpoint under ``model_path`` is restored at construction, so a
    new trainer at the same path resumes.
    """

    def __init__(self, model_path, model, loss_fn, train_loader, val_loader,
                 lr=1e-3, hooks=None, checkpoint_interval=1,
                 keep_n_checkpoints=3, frozen_prefixes=(), optimizer=None):
        self.model_path = model_path
        self.model = model
        self.loss_fn = loss_fn
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.hooks = hooks or []
        self.checkpoint_interval = checkpoint_interval
        self.keep_n_checkpoints = keep_n_checkpoints
        self.device, self.dtype = _param_device_dtype(model)

        prefixes = tuple(frozen_prefixes)
        for name, p in model.named_parameters():
            if any(name == f or name.startswith(f + ".") for f in prefixes):
                p.requires_grad_(False)
        self.params = [p for p in model.parameters() if p.requires_grad]
        if optimizer is None:
            def optimizer(params):
                return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                        eps=1e-8)
        self.optimizer = optimizer(self.params)
        self.epoch = 0
        self.step = 0
        self.stop = False
        self.best_loss = np.inf
        self.last_train_loss = np.nan

        os.makedirs(model_path, exist_ok=True)
        if self._latest_checkpoint() is not None:
            self.restore_checkpoint()

    def _tensors(self, batch):
        return batch_to_tensors(batch, self.device, self.dtype)

    def _train_step(self, batch):
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch, self.model.batched_predict(batch))
        loss.backward()
        for p in self.params:   # a zero cotangent, as JAX's
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return loss.detach()

    # -- runtime LR -----------------------------------------------------------
    def get_lr(self):
        return float(self.optimizer.param_groups[0]["lr"])

    def set_lr(self, lr):
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    # -- checkpoints ----------------------------------------------------------
    def _ckpt_files(self):
        return sorted(glob.glob(
            os.path.join(self.model_path, "checkpoint-*.pt")),
            key=lambda p: int(p.split("-")[-1].split(".")[0]))

    def _latest_checkpoint(self):
        files = self._ckpt_files()
        return files[-1] if files else None

    def store_checkpoint(self):
        blob = {"epoch": self.epoch, "step": self.step,
                "best_loss": float(self.best_loss),
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}
        torch.save(blob, os.path.join(self.model_path,
                                      f"checkpoint-{self.epoch}.pt"))
        for old in self._ckpt_files()[:-self.keep_n_checkpoints]:
            os.remove(old)

    def restore_checkpoint(self, path=None):
        path = path or self._latest_checkpoint()
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.epoch = blob["epoch"]
        self.step = blob["step"]
        self.best_loss = blob["best_loss"]
        self.model.load_state_dict(blob["model"])
        self.optimizer.load_state_dict(blob["optimizer"])

    def save_best(self):
        torch.save(self.model.state_dict(),
                   os.path.join(self.model_path, "best_model.pt"))

    # -- main loop ------------------------------------------------------------
    def train(self, n_epochs=None):
        for h in self.hooks:
            h.on_train_begin(self)
        try:
            while not self.stop:
                if n_epochs is not None and self.epoch >= n_epochs:
                    break
                for h in self.hooks:
                    h.on_epoch_begin(self)
                if self.stop:
                    break

                losses = []
                for batch in self.train_loader:
                    loss = float(self._train_step(self._tensors(batch)))
                    self.step += 1
                    losses.append(loss)
                    for h in self.hooks:
                        h.on_batch_end(self, loss, batch)
                    if self.stop:
                        break
                self.last_train_loss = float(np.mean(losses))

                val_loss = self.validate()
                for h in self.hooks:
                    h.on_validation_end(self, val_loss)
                if val_loss < self.best_loss:
                    self.best_loss = val_loss
                    self.save_best()

                self.epoch += 1
                if self.epoch % self.checkpoint_interval == 0:
                    self.store_checkpoint()
                for h in self.hooks:
                    h.on_epoch_end(self)
            self.store_checkpoint()
            for h in self.hooks:
                h.on_train_ends(self)
        except Exception:
            for h in self.hooks:
                h.on_train_failed(self)
            raise
        return self.model

    def validate(self):
        losses = []
        with torch.no_grad():
            for batch in self.val_loader:
                b = self._tensors(batch)
                losses.append(float(self.loss_fn(
                    b, self.model.batched_predict(b))))
        return float(np.mean(losses)) if losses else np.nan


def evaluate(model, loader):
    """{key: {'mae', 'rmse'}} of ``model.batched_predict`` against the
    targets over ``loader``, every predicted key that the batches hold.
    (The JAX function's ``metric_fns`` argument was never read; it is
    gone.)"""
    device, dtype = _param_device_dtype(model)
    all_preds, all_targs = {}, {}
    with torch.no_grad():
        for batch in loader:
            preds = model.batched_predict(batch_to_tensors(batch, device,
                                                           dtype))
            for k, v in preds.items():
                if k in batch:
                    all_preds.setdefault(k, []).append(_numpy(v))
                    all_targs.setdefault(k, []).append(np.asarray(batch[k]))
    out = {}
    for k in all_preds:
        p = np.concatenate([a.reshape(a.shape[0], -1)
                            for a in all_preds[k]])
        t = np.concatenate([a.reshape(a.shape[0], -1)
                            for a in all_targs[k]])
        out[k] = {"mae": mae(p, t), "rmse": rmse(p, t)}
    return out
