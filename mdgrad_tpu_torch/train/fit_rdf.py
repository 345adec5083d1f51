"""The water SchNet RDF fit: its target, its differentiable epoch loss and
its clipped-Adam update.

Port of part of ``mdgrad_tpu/train/fit_rdf.py``: ``get_observer``,
``_make_epoch_loss`` (as :func:`make_epoch_loss`, without ``kT_override``
and ``angle_extra``) and the optimizer of ``fit_rdf`` --
``clip_by_global_norm`` then Adam on the learnable ``nn`` interaction,
the prior frozen.  The outer ``fit_rdf`` loop (annealing, backtrack, NaN
recovery, overflow regrow, ``reduce_on_plateau``) is not ported yet;
``reduce_on_plateau`` keeps its scale at 1 for its first 25 epochs, so a
few-step trainer without it takes the JAX package's steps.
"""

import numpy as np
import torch

from ..data.registry import exp_rdf_data_dict, get_exp_rdf
from ..observables import rdf
from .loss import compute_D


def get_observer(system, data_tag, nbins, registry=None, backend="xla",
                 device="cuda"):
    """(r_axis, g_obs (nbins,) float32 tensor, rdf observable) for the
    registry entry ``data_tag``."""
    registry = exp_rdf_data_dict if registry is None else registry
    entry = registry[data_tag]
    data = np.loadtxt(entry["fn"], delimiter=",")
    r_range = (entry["start"], entry["end"])
    x, g_obs = get_exp_rdf(data, nbins, r_range)
    obs = rdf(system, nbins, r_range, backend=backend, device=device)
    return x, torch.tensor(g_obs, dtype=torch.float32,
                           device=obs.bins.device), obs


def make_epoch_loss(sim, obs, g_target, system, tau, dt, frame_skip=20):
    """One state point's epoch objective.

    Returns ``loss_fn(state, aux, ctrl) -> (loss, (g, last, final_aux))``:
    it runs one epoch of ``tau - 1`` steps through ``sim.epoch_fn``, takes
    the RDF of every ``frame_skip``-th frame, and returns
    ``compute_D(g - g_target)`` after backpropagating it, so ``.grad``
    holds the loss gradient of every parameter that requires grad.  All
    returned tensors are detached; ``last`` is the epoch's last state.
    """
    ode = sim.epoch_fn(dt, tau)
    rho = system.get_number_of_atoms() / system.get_volume()
    rrange = torch.linspace(float(obs.bins[0]), float(obs.bins[-1]),
                            obs.nbins, device=g_target.device)

    def loss_fn(state, aux, ctrl):
        traj, final_aux = ode(state, aux, ctrl)
        _, _, g = obs(traj.q[::frame_skip])
        loss = compute_D(g - g_target, rho, rrange)
        loss.backward()
        last = traj._replace(**{
            k: getattr(traj, k)[-1].detach() for k in traj._fields
            if torch.is_tensor(getattr(traj, k))})
        return loss.detach(), (g.detach(), last, final_aux)

    return loss_fn


def fit_parameters(stack, key="nn"):
    """The parameters the fit trains: those of ``stack.models[key]``.
    Every other parameter of the stack (the prior) is frozen
    (``requires_grad`` False), as the JAX fit labels them."""
    train = list(stack.models[key].parameters())
    ids = {id(p) for p in train}
    for p in stack.parameters():
        if id(p) not in ids:
            p.requires_grad_(False)
    return train


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


class FitUpdate:
    """The update step of the RDF fit: clip the gradients of ``params`` to
    global norm ``grad_clip``, then one Adam step (optax's defaults:
    betas 0.9 / 0.999, eps 1e-8), then clear the gradients."""

    def __init__(self, params, lr, grad_clip=10.0):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    def __call__(self):
        """Returns the gradients' global norm before clipping."""
        norm = clip_by_global_norm_(self.params, self.grad_clip)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return norm
