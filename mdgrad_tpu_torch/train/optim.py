"""The fitting drivers' optimizer: gradients clipped to a global norm,
then Adam, scaled by a reduce-on-plateau factor -- the JAX drivers' optax
chain ``clip_by_global_norm -> adam -> reduce_on_plateau`` in PyTorch
(``tests/test_torch_fit.py::test_fit_update_matches_optax_chain`` holds
it to optax)."""

import copy

import numpy as np
import torch


def clip_by_global_norm_(params, max_norm):
    """Scale the ``.grad`` of ``params`` in place as
    ``optax.clip_by_global_norm`` does: ``g / ||g|| * max_norm`` when the
    global norm ``||g||`` is not below ``max_norm``, else unchanged.
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and would
    not match.)  Returns the norm before clipping, a device scalar."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau`` with ``rtol`` 1e-4, in float32
    as optax keeps its state.

    :meth:`update` takes this step's value and averages it over
    ``accumulation_size`` steps; each full average improves on the best
    iff ``avg < (1 - rtol) * best - atol``, which resets the plateau
    count; otherwise the count grows.  Outside a cooldown, at ``patience``
    the count resets, the scale becomes ``max(scale * factor, min_scale)``
    and ``cooldown`` averages follow in which the count stays 0.  It
    returns the scale that multiplies this step's update.
    """

    rtol = 1e-4

    def __init__(self, factor=0.5, patience=25, min_scale=1e-4, atol=1e-5,
                 cooldown=0, accumulation_size=1):
        self.factor, self.patience = factor, patience
        self.min_scale, self.atol = min_scale, atol
        self.cooldown, self.accumulation_size = cooldown, accumulation_size
        self.reset()

    def reset(self):
        self.scale = np.float32(1.0)
        self.best_value = np.float32(np.inf)
        self.plateau_count = self.cooldown_count = self.count = 0
        self.avg_value = np.float32(0.0)

    def update(self, value):
        count = self.count
        self.count += 1
        self.avg_value = ((np.float32(count) * self.avg_value
                           + np.float32(value)) / np.float32(self.count))
        if self.count != self.accumulation_size:
            return float(self.scale)
        avg = self.avg_value
        self.count, self.avg_value = 0, np.float32(0.0)
        if avg < (np.float32(1 - self.rtol) * self.best_value
                  - np.float32(self.atol)):
            self.best_value, plateau = avg, 0
        else:
            plateau = self.plateau_count + 1
        if self.cooldown_count > 0:
            self.plateau_count = 0
            self.cooldown_count -= 1
        elif plateau == self.patience:
            self.plateau_count, self.cooldown_count = 0, self.cooldown
            self.scale = np.maximum(self.scale * np.float32(self.factor),
                                    np.float32(self.min_scale))
        else:
            self.plateau_count, self.cooldown_count = plateau, 0
            self.scale = np.maximum(self.scale, np.float32(self.min_scale))
        return float(self.scale)

    def state_dict(self):
        return {"scale": float(self.scale),
                "best_value": float(self.best_value),
                "plateau_count": self.plateau_count,
                "cooldown_count": self.cooldown_count, "count": self.count,
                "avg_value": float(self.avg_value)}

    def load_state_dict(self, state):
        self.scale = np.float32(state["scale"])
        self.best_value = np.float32(state["best_value"])
        self.plateau_count = int(state["plateau_count"])
        self.cooldown_count = int(state.get("cooldown_count", 0))
        self.count = int(state.get("count", 0))
        self.avg_value = np.float32(state.get("avg_value", 0.0))


def cosine_decay(n_steps, alpha):
    """``optax.cosine_decay_schedule``'s factor at step ``count``: from 1
    down to ``alpha`` over ``n_steps``, then ``alpha``."""
    def factor(count):
        frac = min(count, n_steps) / n_steps
        return (1 - alpha) * 0.5 * (1 + np.cos(np.pi * frac)) + alpha
    return factor


class FitUpdate:
    """The update step of the fits: clip the gradients of ``params`` to
    global norm ``grad_clip`` (None: no clipping), then one Adam step (optax's defaults: betas
    0.9 / 0.999, eps 1e-8), then clear the gradients.

    With ``plateau`` (a :class:`ReduceOnPlateau`), the step is scaled by
    the plateau scale that this step's ``value`` gives and by
    ``step_scale``, as the JAX fit multiplies optax's update; with
    ``schedule`` (e.g. :func:`cosine_decay`) by ``schedule(k)`` at the
    k-th step, as an optax learning-rate schedule.  Adam's step
    is linear in its learning rate, so the scales go into the rate; the
    gradients, and so Adam's moments, stay unscaled.  A parameter with no
    gradient takes a zero one, as JAX's zero cotangent, so it moves by 0
    and Adam's step count is the same for every parameter.
    """

    def __init__(self, params, lr, grad_clip=10.0, plateau=None,
                 schedule=None):
        self.params = list(params)
        self.lr = lr
        self.grad_clip = grad_clip
        self.plateau = plateau
        self.schedule = schedule
        self.reset()

    def reset(self):
        """A fresh optimizer state."""
        self.opt = torch.optim.Adam(self.params, lr=self.lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.count = 0
        if self.plateau is not None:
            self.plateau.reset()

    def __call__(self, value=None, step_scale=1.0):
        """Returns the gradients' global norm before clipping (None
        without clipping)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = (None if self.grad_clip is None
                else clip_by_global_norm_(self.params, self.grad_clip))
        scale = 1.0 if self.plateau is None else self.plateau.update(value)
        if self.schedule is not None:
            scale *= self.schedule(self.count)
        self.count += 1
        for group in self.opt.param_groups:
            group["lr"] = self.lr * scale * step_scale
        self.opt.step()
        self.zero_grad()
        return norm

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self):
        """A copy of the optimizer's state, which later steps leave
        alone."""
        return {"adam": copy.deepcopy(self.opt.state_dict()),
                "plateau": (None if self.plateau is None
                            else self.plateau.state_dict()),
                "count": self.count}

    def load_state_dict(self, state):
        # Adam adopts the tensors it is given: give it copies, so that its
        # steps never write into a snapshot
        self.opt.load_state_dict(copy.deepcopy(state["adam"]))
        self.count = int(state.get("count", 0))
        if self.plateau is not None:
            self.plateau.load_state_dict(state["plateau"])
