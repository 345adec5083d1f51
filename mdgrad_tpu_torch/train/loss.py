"""Fitting losses for observable matching (port of
``mdgrad_tpu/train/loss.py``)."""

import numpy as np
import torch


def JS_rdf(g_obs, g, eps=1e-4):
    """epsilon-regularised Jensen-Shannon divergence between RDFs."""
    g_m = 0.5 * (g_obs + g)
    loss = (-(g_obs + eps) * (torch.log(g_m + eps)
                              - torch.log(g_obs + eps))).mean()
    loss = loss + (-(g + eps) * (torch.log(g_m + eps)
                                 - torch.log(g + eps))).mean()
    return loss


def compute_D(dev, rho, rrange):
    """Density-weighted shell-integrated squared deviation: the integral
    of 4 pi rho r^2 (g - g_obs)^2 dr on the grid ``rrange``."""
    dr = rrange[2] - rrange[1]
    return (4 * np.pi * rho * rrange ** 2 * dev ** 2 * dr).sum()


def mse_loss(a, b):
    return ((a - b) ** 2).mean()
