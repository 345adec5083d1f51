"""Quantum-yield optimisation of retinal isomerization (a control
problem).

Port of ``mdgrad_tpu/train/isom.py``: the retinal model's operators
(Hahn & Stock 2000) are read in place from the JAX package's
``data/targets/isom/`` (``MDGRAD_ISOM_DIR`` overrides it) and cast to
float32; a Gaussian pulse is the initial field (:func:`initialize_Et`);
each epoch integrates ~30k RK4 steps through the replay adjoint
(:func:`~mdgrad_tpu_torch.md.adjoint.make_odeint`), computes four
quantum-yield definitions over every frame (:func:`calc_yields`) and
takes one SGD (or Adam) step on E(t) that raises the mean yield over the
last ``look_back`` frames.
"""

import json
import os
from math import pi

import numpy as np
import torch

from .._device import resolve_device
from ..md.adjoint import make_odeint
from ..md.isomerization import Isomerization

# time conversion and pulse constants
FS_TO_EV = 41.341 / 27.2
DT = 2 * pi / 2.8 / 30
TMAX = 1500 * FS_TO_EV
TAU = 10 * FS_TO_EV
W0 = 2.4
TP = 3 * TAU

ISOM_DATA_DIR = os.environ.get(
    "MDGRAD_ISOM_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "mdgrad_tpu", "data",
                 "targets", "isom"))


def make_quants(data_dir=None):
    """The retinal operators as float32 numpy arrays: ``ham``, ``dipole``,
    ``prod_op``, ``reac_op``, and ``dim``."""
    d = data_dir or ISOM_DATA_DIR

    def load(f):
        return np.load(os.path.join(d, f)).astype(np.float32)

    ham = load("hamiltonian.npy")
    return {"ham": ham, "dipole": load("unitless_mu.npy"),
            "prod_op": load("Pt_11.npy"), "reac_op": load("Pc_00.npy"),
            "dim": ham.shape[0]}


def initialize_Et(dt=DT, tmax=TMAX, w0=W0, tau=TAU, tp=TP):
    """A Gaussian pulse on a uniform grid over the first half of the run:
    ``(t_field, e_t, n_steps)``."""
    num_steps = int(tmax / dt)
    first_num_steps = int(tmax / dt / 5)
    t_grid_0 = np.linspace(0, tmax / 2, first_num_steps)
    e0 = pi ** 0.5 / tau
    e_t = (e0 * np.cos(w0 * (t_grid_0 - tp))
           * np.exp(-(t_grid_0 - tp) ** 2 / tau ** 2))
    return t_grid_0, e_t, num_steps


def calc_yields(psi_t, prod_op, reac_op):
    """The four quantum-yield definitions over the frames of ``psi_t`` (T,
    2 D).  Definition 2 keeps the reference's own cross term, whose real
    part alone carries the factor ``pr[:, 0]``."""
    dim = psi_t.shape[-1] // 2
    pr, pi_ = psi_t[..., :dim], psi_t[..., dim:]

    def expect(op, a):
        return ((a @ op) * a).sum(-1)

    prod = expect(prod_op, pr) + expect(prod_op, pi_)
    reac = expect(reac_op, pr) + expect(reac_op, pi_)
    pg = pr[:, 0] ** 2 + pi_[:, 0] ** 2

    y1 = prod / (prod + reac - pg)
    cross = ((reac_op[0, 1:] * pr[:, 1:]).sum(-1) * pr[:, 0]
             + (reac_op[0, 1:] * pi_[:, 1:]).sum(-1))
    y2 = prod / (prod + reac - (pg + 2 * cross))
    y3 = prod / (1 - pg)

    prod_exc, reac_exc = prod_op[1:, 1:], reac_op[1:, 1:]
    pr_e, pi_e = pr[:, 1:], pi_[:, 1:]
    prod_e = expect(prod_exc, pr_e) + expect(prod_exc, pi_e)
    reac_e = expect(reac_exc, pr_e) + expect(reac_exc, pi_e)
    y4 = prod_e / (prod_e + reac_e)
    return y1, y2, y3, y4


def objective(y_t, look_back=20000):
    """The negative mean yield over the last ``look_back`` frames."""
    return -torch.mean(y_t[-look_back:])


def make_epoch(ode_obj, n_steps, dt=DT):
    """``odeint(params, psi0, aux, ctrl) -> (traj, aux)``: ``n_steps`` RK4
    steps of ``ode_obj`` from t = 0 through the replay adjoint."""
    def step_fn(state, aux, ctrl, i, create_graph):
        return ode_obj.step(state, ode_obj.time(i, dt), dt)

    return make_odeint(step_fn, lambda s, a: a, n_steps, adjoint=True)


def fit_isomerization(n_epochs=5, lr=1e-2, adam=False, n_steps=None,
                      look_back=20000, data_dir=None, logdir=None,
                      log=print, yield_def=4, device="cuda",
                      dtype=torch.float32):
    """Optimise E(t) to maximise the quantum yield ``yield_def``.

    Returns a dict: ``q_yields`` (the mean yield of each epoch, before its
    update), ``e_field`` (the final field, numpy), ``yields_t`` (the four
    yields over the frames of the last epoch, numpy) and ``params`` (the
    final field, a tensor).  With ``logdir`` it writes ``q_yields.json``
    and ``e_fields.json`` (each epoch's field before its update).
    """
    device = resolve_device(device)
    q = make_quants(data_dir)
    t_field, e_t, full_steps = initialize_Et()
    n_steps = n_steps or full_steps
    look_back = min(look_back, n_steps)
    ode_obj = Isomerization(q["ham"], q["dipole"], t_field, e_t,
                            max_e_t=float(t_field.max()), device=device,
                            dtype=dtype)
    odeint = make_epoch(ode_obj, n_steps)
    prod_op = torch.as_tensor(q["prod_op"], dtype=dtype, device=device)
    reac_op = torch.as_tensor(q["reac_op"], dtype=dtype, device=device)
    psi0 = ode_obj.initial_state()
    params = [ode_obj.e_field]
    opt = (torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
           if adam else torch.optim.SGD(params, lr=lr))

    q_yields, fields, yields_t = [], [], None
    for epoch in range(n_epochs):
        opt.zero_grad(set_to_none=True)
        traj, _ = odeint(params, psi0, (), {})
        ys = calc_yields(traj.psi, prod_op, reac_op)
        loss = objective(ys[yield_def - 1], look_back)
        loss.backward()
        q_yields.append(-loss.item())
        fields.append(ode_obj.e_field.detach().cpu().numpy().tolist())
        yields_t = [y.detach().cpu().numpy() for y in ys]
        log(f"epoch {epoch}: average quantum yield {q_yields[-1]:.6f}")
        opt.step()

    out = {"q_yields": q_yields,
           "e_field": ode_obj.e_field.detach().cpu().numpy(),
           "yields_t": yields_t, "params": ode_obj.e_field.detach()}
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "q_yields.json"), "w") as f:
            json.dump(q_yields, f)
        with open(os.path.join(logdir, "e_fields.json"), "w") as f:
            json.dump(fields, f)
    return out
