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
on a template of the same structure (:func:`from_plain`).  The JAX
package's pickles, which hold optax classes, are not read.
"""

import glob
import os

import torch


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
