"""Boltzmann-inversion pretraining of learnable pair potentials (port of
``mdgrad_tpu/train/pretrain.py``).

Before trajectory fitting, the pair MLP is regressed onto the
Boltzmann-inverted target RDF u_BI(r) = -kB T log g(r), averaged over
state points (or one target per state point for a temperature-dependent
``TPairMLP``), with the prior subtracted: Adam with reduce-on-plateau
(:class:`~mdgrad_tpu_torch.train.optim.FitUpdate`, no clipping).
"""

import numpy as np
import torch

from .. import units
from .optim import FitUpdate, ReduceOnPlateau


def boltzmann_inversion_targets(r_axis_list, g_obs_list, T_list,
                                rrange, posinf=100.0, g_support=1e-3):
    """(states, len(rrange)) float64 numpy: u_BI(r) of each state point on
    ``rrange``.  Bins with g <= ``g_support`` carry no information: the
    core below the first supported bin is continued linearly from the
    slope of the first two supported bins (monotonically repulsive, no
    cliff), and everything is capped at +-``posinf``."""
    pots = []
    for x, g, T in zip(r_axis_list, g_obs_list, T_list):
        x = np.asarray(x)
        g = np.asarray(g)
        supported = g > g_support
        if supported.sum() < 2:
            raise ValueError("target RDF has <2 supported bins")
        xs, gs = x[supported], g[supported]
        with np.errstate(divide="ignore"):
            us = -units.kB * T * np.log(gs)
        u = np.interp(rrange, xs, us)
        core = rrange < xs[0]
        if core.any():
            slope = min((us[1] - us[0]) / max(xs[1] - xs[0], 1e-9), 0.0)
            u[core] = us[0] + slope * (rrange[core] - xs[0])
        pots.append(np.clip(u, -posinf, posinf))
    return np.stack(pots)


def boltzmann_inversion_pretrain(net, prior, r_axis_list, g_obs_list,
                                 T_list, rrange=None, n_iters=2000, lr=1e-3,
                                 temperature_dependent=False,
                                 log_every=None):
    """Fit ``net``'s parameters in place so that net(r) + prior(r) matches
    u_BI(r) on ``rrange`` (default 2.5 .. 7.5, 1000 points); returns the
    loss of the last iteration.  T in Kelvin; ``g_obs_list`` numpy arrays
    or tensors.

    ``temperature_dependent`` (a ``TPairMLP``): each state point is
    regressed at its own kT, the losses summed; otherwise one target, the
    state points' mean.  The prior is a constant here.
    """
    if rrange is None:
        rrange = np.linspace(2.5, 7.5, 1000)
    g_obs_list = [g.detach().cpu().numpy() if torch.is_tensor(g)
                  else np.asarray(g) for g in g_obs_list]
    targets = boltzmann_inversion_targets(r_axis_list, g_obs_list, T_list,
                                          rrange)
    params = [p for p in net.parameters() if p.requires_grad]
    kw = {"dtype": params[0].dtype, "device": params[0].device}
    r = torch.tensor(rrange, **kw)[:, None]
    with torch.no_grad():
        u_prior = prior(r).squeeze(-1)
    if temperature_dependent:
        kTs = [torch.tensor(units.kB * T, **kw) for T in T_list]
        u_targets = torch.tensor(targets, **kw)

        def loss_fn():
            return sum(((net(r, kT).squeeze(-1) + u_prior - u_t) ** 2).mean()
                       for kT, u_t in zip(kTs, u_targets))
    else:
        u_target = torch.tensor(targets.mean(0), **kw)

        def loss_fn():
            return ((net(r).squeeze(-1) + u_prior - u_target) ** 2).mean()

    update = FitUpdate(params, lr, grad_clip=None,
                       plateau=ReduceOnPlateau(factor=0.5, patience=25,
                                               min_scale=1e-4, atol=1e-5))
    loss = None
    for i in range(n_iters):
        loss = loss_fn()
        loss.backward()
        update(loss.item())
        if log_every and i % log_every == 0:
            print(f"  BI pretrain {i}: {loss.item():.6f}")
    return None if loss is None else loss.item()
