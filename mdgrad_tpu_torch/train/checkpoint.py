"""Checkpoint and resume for the fitting drivers (port of
``mdgrad_tpu/train/checkpoint.py``'s ``FitCheckpointer``), and the
best-model files ``best.pt`` / ``best_eval.pt`` (the JAX package's
``best.pkl`` / ``best_eval.pkl``).

Each blob holds the epoch, the learnable module's ``state_dict``, the
optimizer's state (Adam's ``state_dict`` and the plateau state), every
state point's MD state and aux, and the logs, all on the CPU, so that a
fit resumes with the same bits.  The format is the port's own:
``torch.save`` of plain dicts, lists, tuples, numbers and tensors, which
``torch.load(weights_only=True)`` reads back.  The integrators' NamedTuple
states are stored as dicts of their fields (:func:`to_plain`) and rebuilt
on a template of the same structure (:func:`from_plain`).

The JAX package's own pickles (its ``fit-ckpt-<epoch>.pkl``,
``best.pkl``, ``best_eval.pkl`` and ``model.pkl``) are read by
:func:`read_jax_pickle` and :func:`jax_params` (with
:func:`pair_mlp_state` and :func:`load_schnet_checkpoint` over them), and
by nothing else.
"""

import glob
import os
import pickle

import torch

# the globals a JAX pickle may name besides its classes: numpy's arrays,
# dtypes and scalars
_NUMPY = frozenset({"_reconstruct", "ndarray", "dtype", "scalar",
                    "_frombuffer"})
# the top-level modules whose classes become inert records
_JAX_STACK = frozenset({"optax", "mdgrad_tpu", "jax", "jaxlib", "flax"})


class JaxRecord:
    """A class of the JAX stack read as data.  Built with any arguments,
    it keeps them (``args``, ``kwargs``) and the state pickle hands it
    (``state``), and does nothing else: it imports nothing and calls
    nothing.  A NamedTuple of the JAX package (an optax state,
    ``NVTStateF``, ``NeighborTable``) arrives as its fields in order in
    ``args``.  ``jax_global`` names the class it stands for."""

    jax_global = None

    def __new__(cls, *args, **kwargs):
        rec = object.__new__(cls)
        rec.args, rec.kwargs, rec.state = args, kwargs, None
        return rec

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f"<record of {self.jax_global}: {len(self.args)} args>"


_RECORDS = {}


def _record_class(module, name):
    key = f"{module}.{name}"
    if key not in _RECORDS:
        _RECORDS[key] = type(key, (JaxRecord,), {"jax_global": key})
    return _RECORDS[key]


class _JaxUnpickler(pickle.Unpickler):
    """numpy's array globals as they are, each class of the JAX stack as
    a :class:`JaxRecord`, every other global refused."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "numpy" and name in _NUMPY:
            return super().find_class(module, name)
        if top in _JAX_STACK:
            return _record_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name}: a JAX pickle holds numpy arrays and classes "
            f"of {', '.join(sorted(_JAX_STACK))}; no other global is read")


def read_jax_pickle(path):
    """The blob the JAX package pickled to ``path``, as its
    ``pickle.load`` gives it, with two differences: each
    class of optax, ``mdgrad_tpu``, jax, jaxlib or flax is a
    :class:`JaxRecord` that holds its fields and runs no code, and any
    other global but numpy's arrays raises ``pickle.UnpicklingError``
    naming it.  Parameters (dicts of numpy arrays) are the same bits as
    JAX's.

    A fit checkpoint's optimizer state (``opt_state``: optax records) and
    MD states (``md_states``: ``NVTStateF`` and ``NeighborTable``
    records) are carried but read by nothing: resuming a JAX run's
    optimizer or MD state in the port is out of scope; the port resumes
    only from its own ``fit-ckpt-<epoch>.pt``."""
    with open(path, "rb") as f:
        return _JaxUnpickler(f).load()


def jax_params(path, key=None):
    """The parameters of a JAX pickle, as every JAX reader takes them:
    ``blob['params']`` when the blob has it, else the blob; with ``key``
    its ``key`` subtree (``'nn'``, ``'pairnn'``)."""
    blob = read_jax_pickle(path)
    params = blob["params"] if isinstance(blob, dict) and \
        "params" in blob else blob
    return params if key is None else params[key]


def pair_mlp_state(path):
    """The PairMLP ``state_dict`` of a warm start: the port's own
    best-model file (``best.pt`` / ``best_eval.pt``), or any JAX pickle
    whose parameters hold ``'pairnn'`` (``best_eval.pkl``, a fit
    checkpoint), read by :func:`jax_params`."""
    if str(path).endswith(".pt"):
        return torch.load(path, map_location="cpu",
                          weights_only=True)["params"]
    from ..nn.convert import pair_mlp_params_from_numpy
    return pair_mlp_params_from_numpy(jax_params(path, "pairnn"))


def load_schnet_checkpoint(net, path):
    """Load the SchNet ``net`` from a fit checkpoint: the port's
    ``fit-ckpt-<epoch>.pt`` (its ``params``) or the JAX package's
    ``.pkl`` (its ``params['nn']`` flax tree, read by
    :func:`read_jax_pickle`); returns the checkpoint's epoch."""
    if str(path).endswith(".pkl"):
        from ..nn.convert import schnet_params_from_numpy
        blob = read_jax_pickle(path)
        net.load_state_dict(schnet_params_from_numpy(blob["params"]["nn"]))
    else:
        blob = torch.load(path, map_location="cpu", weights_only=True)
        net.load_state_dict(blob["params"])
    return blob.get("epoch")


def to_plain(tree):
    """``tree`` with every NamedTuple turned into a dict of its fields and
    every tensor into a detached CPU copy."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if hasattr(tree, "_fields"):
        return {k: to_plain(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, dict):
        return {k: to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_plain(v) for v in tree)
    return tree


def from_plain(template, plain):
    """Inverse of :func:`to_plain`: ``plain`` rebuilt in the structure of
    ``template`` (its NamedTuple types), each tensor on the device of the
    template's tensor in its place.  Shapes come from ``plain``."""
    if torch.is_tensor(template):
        return plain.to(template.device)
    if hasattr(template, "_fields"):
        return type(template)(**{k: from_plain(getattr(template, k),
                                               plain[k])
                                 for k in template._fields})
    if isinstance(template, dict):
        return {k: from_plain(v, plain[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(from_plain(t, p)
                              for t, p in zip(template, plain))
    return plain


class FitCheckpointer:
    """Rotating checkpoint files ``fit-ckpt-<epoch>.pt`` under
    ``model_path``, the newest ``keep`` kept.  ``model_path=None`` turns
    every method into a no-op."""

    def __init__(self, model_path, every=10, keep=3):
        self.path = model_path
        self.every = max(int(every), 1)
        self.keep = keep
        if model_path:
            os.makedirs(model_path, exist_ok=True)

    def _files(self):
        files = glob.glob(os.path.join(self.path, "fit-ckpt-*.pt"))
        return sorted(files,
                      key=lambda p: int(p.rsplit("-", 1)[-1].split(".")[0]))

    def latest(self):
        if not self.path:
            return None
        files = self._files()
        return files[-1] if files else None

    def restore(self):
        """The latest blob, or None when there is nothing to resume from.
        Its MD states are plain (:func:`from_plain` rebuilds them)."""
        path = self.latest()
        if path is None:
            return None
        return torch.load(path, map_location="cpu", weights_only=True)

    def maybe_save(self, epoch, params, opt_state, md_states=None,
                   logs=None):
        """Save when ``(epoch + 1) % every == 0``, then rotate."""
        if not self.path or (epoch + 1) % self.every:
            return
        self.save(epoch, params, opt_state, md_states, logs)

    def save(self, epoch, params, opt_state, md_states=None, logs=None):
        if not self.path:
            return
        blob = {"epoch": epoch, "params": to_plain(params),
                "opt_state": to_plain(opt_state),
                "md_states": to_plain(md_states), "logs": logs or {}}
        out = os.path.join(self.path, f"fit-ckpt-{epoch}.pt")
        tmp = out + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, out)   # no truncated blob if the process dies
        for old in self._files()[:-self.keep]:
            os.remove(old)

    def save_best(self, epoch, loss, params, fname="best.pt"):
        """Write ``fname`` (epoch, loss, ``params`` on the CPU) whenever
        ``loss`` beats the one stored there: a trajectory fit oscillates
        around its noise floor, so its last epoch is rarely its best."""
        if not self.path:
            return
        best_path = os.path.join(self.path, fname)
        if os.path.exists(best_path) and self.load_best(fname)["loss"] <= loss:
            return
        tmp = best_path + ".tmp"
        torch.save({"epoch": epoch, "loss": float(loss),
                    "params": to_plain(params)}, tmp)
        os.replace(tmp, best_path)

    def load_best(self, fname="best.pt"):
        """The blob :meth:`save_best` wrote to ``fname``, or None."""
        best_path = os.path.join(self.path or "", fname)
        if not self.path or not os.path.exists(best_path):
            return None
        return torch.load(best_path, map_location="cpu", weights_only=True)
