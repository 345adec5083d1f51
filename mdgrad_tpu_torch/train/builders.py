"""Model builders: construct and persist models from parameter dicts.

Port of ``mdgrad_tpu/train/builders.py``: ``PARAMS_TYPE`` config checks,
``get_model``, ``save_model`` / ``load_model`` and ``get_trainer``, the
standard supervised trainer (max epochs, early stopping, plateau LR,
printing and the CSV log).  The port's model files are ``.pt``:
``torch.save`` of ``{'model_type', 'model_params', 'state_dict'}``, read
with ``torch.load(weights_only=True)``.  ``load_model`` also reads the
JAX package's ``model.pkl`` (its ``save_model``: the model type, its
dict and the flax tree) through ``train/checkpoint.py::read_jax_pickle``,
and a bare
``best_model.pt`` state_dict.
"""

import torch

from .._device import resolve_device
from ..nn import SchNet
from .supervised import (CSVHook, EarlyStoppingHook, MaxEpochHook,
                         PrintingHook, ReduceLROnPlateauHook, Trainer,
                         build_mse_loss)

PARAMS_TYPE = {
    "SchNet": {
        "n_atom_basis": int,
        "n_filters": int,
        "n_gaussians": int,
        "n_convolutions": int,
        "cutoff": float,
        "trainable_gauss": bool,
        "readout_keys": (tuple, list),
    },
}

MODEL_DICT = {"SchNet": SchNet}


def check_parameters(params_type, params):
    """Raise TypeError on a config value of the wrong type."""
    for key, val in params.items():
        if key in params_type and not isinstance(val, params_type[key]):
            raise TypeError(f"{key} is not of type {params_type[key]}")


def get_model(params, model_type="SchNet", device="cuda", seed=0):
    """The ``model_type`` model of config ``params`` on ``device``, its
    weights drawn from ``seed``."""
    if model_type not in MODEL_DICT:
        raise ValueError(f"unknown model type {model_type!r}; "
                         f"options: {sorted(MODEL_DICT)}")
    check_parameters(PARAMS_TYPE[model_type], params)
    model = MODEL_DICT[model_type](params, seed=seed)
    return model.to(resolve_device(device))


def save_model(path, model_type, model_params, model):
    torch.save({"model_type": model_type, "model_params": model_params,
                "state_dict": model.state_dict()}, path)


def load_model(path, device="cuda"):
    """(model, model_params) from a file of :func:`save_model` or of the
    JAX package's ``save_model`` (a ``.pkl``); (None, state_dict) from a
    trainer's ``best_model.pt``."""
    device = resolve_device(device)
    if str(path).endswith(".pkl"):
        from ..nn.convert import schnet_params_from_numpy
        from .checkpoint import read_jax_pickle
        blob = read_jax_pickle(path)
        if blob.get("model_type") != "SchNet":
            raise ValueError(f"{path}: no SchNet model file")
        state = schnet_params_from_numpy(blob["params"])
    else:
        blob = torch.load(path, map_location=device, weights_only=True)
        if "model_type" not in blob:
            return None, blob
        state = blob["state_dict"]
    model = get_model(blob["model_params"], blob["model_type"], device)
    model.load_state_dict(state)
    return model, blob["model_params"]


def get_trainer(model, train_loader, val_loader, model_path,
                loss_coef=None, lr=3e-4, max_epochs=200, patience=30,
                log=print):
    """The standard supervised trainer over ``model``'s parameters."""
    loss_coef = loss_coef or {"energy": 0.1, "energy_grad": 1.0}
    hooks = [
        MaxEpochHook(max_epochs),
        EarlyStoppingHook(patience=patience),
        ReduceLROnPlateauHook(patience=max(patience // 2, 5)),
        PrintingHook(log=log),
        CSVHook(model_path),
    ]
    return Trainer(model_path=model_path, model=model,
                   loss_fn=build_mse_loss(loss_coef),
                   train_loader=train_loader, val_loader=val_loader, lr=lr,
                   hooks=hooks)
