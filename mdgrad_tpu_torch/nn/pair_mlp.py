"""Learnable pair potentials: ``PairMLP``, ``TPairMLP``, ``MLP`` and
``MLP2d`` (port of ``mdgrad_tpu/nn/pair_mlp.py``).

``PairMLP`` is u(r) from an MLP over a Gaussian featurization of r whose
centres and widths are parameters; ``TPairMLP`` is u(r, T) = E(r) - T S(r)
with one such MLP for each of E and S; ``MLP`` adds the fixed
(0.6 / r)^12 core to a plain MLP of r; ``MLP2d`` is a plain MLP of 2-D
points.  Each call returns (..., 1) (``MLP2d``: (...,)).

The layers are ``nn.Linear``s in the order of the flax ``Dense_0 ..
Dense_k`` (``nn/convert.py::pair_mlp_params_from_numpy`` carries the JAX
package's parameters across), with flax's default init: a LeCun truncated
normal kernel and a zero bias, drawn on the CPU from
``torch.Generator().manual_seed(seed)`` so that every device gets the same
weights, then moved to ``device`` (default ``"cuda"``; a CUDA device
without a card raises).  Activations come by name from
``nn/layers.ACTIVATIONS``.
"""

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from .layers import ACTIVATIONS, gaussian_smearing
from .schnet import _dense


class _TrainableSmearing(nn.Module):
    """Gaussian basis with learnable centres ``offsets`` (evenly from
    ``start`` to ``stop``) and ``widths`` (the spacing)."""

    def __init__(self, start, stop, n_gaussians):
        super().__init__()
        init_off = np.linspace(start, stop, n_gaussians)
        self.offsets = nn.Parameter(torch.tensor(init_off,
                                                 dtype=torch.float32))
        self.widths = nn.Parameter(torch.full(
            (n_gaussians,), init_off[1] - init_off[0], dtype=torch.float32))

    def forward(self, r):
        return gaussian_smearing(r, self.offsets, self.widths)


class _PairNet(nn.Module):
    """Smearing -> Dense(n_gauss) -> Dense(n_width) -> n_layers x
    Dense(n_width) -> Dense(n_gauss), each followed by the activation
    (with ``res``, added to its input where the widths match) -> Dense(1).
    """

    def __init__(self, n_gauss, r_start, r_end, n_layers, n_width,
                 nonlinear, res, generator):
        super().__init__()
        self.act = ACTIVATIONS[nonlinear]
        self.res = res
        self.smear = _TrainableSmearing(r_start, r_end, n_gauss)
        widths = [n_gauss, n_width] + [n_width] * n_layers + [n_gauss]
        ins = [n_gauss] + widths[:-1]
        self.dense = nn.ModuleList(
            [_dense(i, o, generator) for i, o in zip(ins, widths)]
            + [_dense(widths[-1], 1, generator)])

    def forward(self, r):
        x = self.smear(r)
        for layer in self.dense[:-1]:
            y = self.act(layer(x))
            x = x + y if (self.res and y.shape[-1] == x.shape[-1]) else y
        return self.dense[-1](x)


class PairMLP(nn.Module):
    """u(r) (..., 1) from r (..., 1): an MLP over a trainable Gaussian
    featurization of ``n_gauss`` centres from ``r_start`` to ``r_end``."""

    def __init__(self, n_gauss, r_start, r_end, n_layers, n_width,
                 nonlinear="SELU", res=False, seed=0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.net = _PairNet(n_gauss, r_start, r_end, n_layers, n_width,
                            nonlinear, res, gen)
        self.to(resolve_device(device))

    def forward(self, r):
        return self.net(r)


class TPairMLP(nn.Module):
    """u(r, T) = E(r) - T S(r): ``nets[0]`` is E, ``nets[1]`` S, each a
    :class:`PairMLP` network; ``T`` (a scalar, kT in the fits) broadcasts."""

    def __init__(self, n_gauss, r_start, r_end, n_layers, n_width,
                 nonlinear="SELU", res=False, seed=0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.nets = nn.ModuleList([
            _PairNet(n_gauss, r_start, r_end, n_layers, n_width, nonlinear,
                     res, gen) for _ in range(2)])
        self.to(resolve_device(device))

    def forward(self, r, T):
        return self.nets[0](r) - T * self.nets[1](r)


class MLP(nn.Module):
    """Dense(H) -> num_layers x Dense(H), each activated, -> Dense(1) on
    x (..., D_in), plus (0.6 / x)^12 with ``excluded_vol``."""

    def __init__(self, D_in=1, H=128, num_layers=3, act="relu",
                 excluded_vol=True, seed=0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.act = ACTIVATIONS[act]
        self.excluded_vol = excluded_vol
        ins = [D_in] + [H] * (num_layers + 1)
        outs = [H] * (num_layers + 1) + [1]
        self.dense = nn.ModuleList([_dense(i, o, gen)
                                    for i, o in zip(ins, outs)])
        self.to(resolve_device(device))

    def forward(self, x):
        y = x
        for layer in self.dense[:-1]:
            y = self.act(layer(y))
        out = self.dense[-1](y)
        return out + (0.6 / x) ** 12 if self.excluded_vol else out


class MLP2d(MLP):
    """A 2-D surface u(x, y): :class:`MLP` without the core on points
    (..., 2); returns (...,)."""

    def __init__(self, D_in=2, H=128, num_layers=3, act="relu", seed=0,
                 device="cuda"):
        super().__init__(D_in, H, num_layers, act, excluded_vol=False,
                         seed=seed, device=device)

    def forward(self, xy):
        xy = xy.reshape(1, -1) if xy.dim() < 2 else xy
        return super().forward(xy).squeeze(-1)
