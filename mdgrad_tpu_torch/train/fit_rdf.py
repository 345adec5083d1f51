"""The RDF-fitting driver: learn a potential from target g(r) through MD
gradients.

Port of the GNN (SchNet) branch of ``mdgrad_tpu/train/fit_rdf.py``.
:func:`build_fit` makes one system per state point from a registry entry,
one SchNet shared by every state point's ``GNNPotentials`` with a frozen
ExcludedVolume prior in a ``Stack``, a Nose-Hoover chain (Q = 50, 5
chains) and an RDF observer.  :func:`fit_rdf` then trains: each epoch
simulates ``opt_freq`` frames per state point, takes the soft-histogram
RDF of every ``frame_skip``-th, and backpropagates ``compute_D`` against
the target through the trajectory (:func:`make_epoch_loss`, the replay
adjoint by default); the gradients of the training state points are
summed, clipped to a global norm and fed to Adam with reduce-on-plateau
and a step scale (:class:`FitUpdate`).  Around that: temperature
annealing, NaN recovery (restore the last good snapshot, rethermalize,
halve the step scale), a backtrack to an older snapshot when failures
persist, the ``overflow_policy`` branches ('warn', 'skip', 'regrow'),
checkpoints and resume (:mod:`.checkpoint`), an ``init_pkl`` warm start,
and the inference phase: ``n_sim`` rollouts of 100 steps and the
``test_nbins`` RDF, whose MSE against the target is the ``objective``.

The JAX loop is functional; here the state is mutable, so three things
are explicit.  ``.grad`` is cleared at every epoch start and after every
epoch that applies no update, and a validation state point runs without
backward.  Snapshots hold copies of the module's and the optimizer's
state.  One numpy Generator draws every velocity in the JAX package's
order: ``get_system``, the annealing start, each rethermalize.

The SchNet's ``compute_dtype`` (float32, bf16, 'mixed'), the Verlet skin
(``gnn_skin``, exact with ``topology_update_freq > 1``) and the neighbor
modes 'table', 'topk' and 'sparse' (``nbr_mode``) are the JAX driver's.
The pair-MLP families, Boltzmann-inversion pretraining, the angle target,
multi-timestep integration, a shared prior table and the 'cells' mode
are not ported: :func:`build_fit` raises ``NotImplementedError`` naming
the ROADMAP item that ports each.
"""

import copy
import json
import os
import pickle

import numpy as np
import torch

from .. import units
from .. import potentials as pot_zoo
from ..data.registry import (exp_rdf_data_dict, get_exp_rdf, get_unit_len,
                             load_target, number_density_unit_len)
from ..interface import GNNPotentials, PairPotentials, Stack
from ..md import NoseHooverChain, Simulation, rethermalize
from ..nn import SchNet
from ..nn.convert import schnet_params_from_numpy
from ..observables import rdf
from ..system import System
from .checkpoint import FitCheckpointer, from_plain
from .loss import JS_rdf, compute_D

WIDTH_DICT = {"tiny": 64, "low": 128, "mid": 256, "high": 512}


def _traj_finite(last):
    """Whether an epoch's last state has finite positions (module-level so
    that tests can inject failures)."""
    return bool(torch.isfinite(last.q).all())


def _dt_scale(entry):
    """dt is in femtoseconds for physical-units entries and in reduced
    time units for reduced-units (LJ-style) entries."""
    return 1.0 if entry.get("reduced_units") else units.fs


def get_temp(T_start, T_equil, n_epochs, i, anneal_rate):
    """Annealing schedule: exponential decay from ``T_start`` to
    ``T_equil`` over the fit."""
    return ((T_start - T_equil) * np.exp(-i * (1 / n_epochs) * anneal_rate)
            + T_equil)


def registry_T_kelvin(entry):
    """The entry's temperature in Kelvin: registry temperatures are Kelvin
    for physical-units targets and kT for reduced-units ones."""
    T = entry["T"]
    return T / units.kB if entry.get("reduced_units") else T


def get_system(data_tag, size, registry=None, rng=None):
    """Lattice-initialised System for the registry entry ``data_tag``,
    with Maxwell-Boltzmann velocities at its temperature from ``rng``."""
    registry = exp_rdf_data_dict if registry is None else registry
    entry = registry[data_tag]
    if entry.get("dim", 3) == 2:
        raise NotImplementedError(
            f"{data_tag}: 2-D registry entries (the stripe systems) are not "
            "ported yet (ROADMAP Queue 1, Slice B: pair fitting)")
    if entry.get("reduced_units"):
        L = number_density_unit_len(entry["rho"], entry["N_unitcell"])
    else:
        L = get_unit_len(entry["rho"], entry["mass"], entry["N_unitcell"])
    system = System.from_lattice(entry["cell"], size, L,
                                 symbol=entry["element"])
    system.masses = np.full(system.get_number_of_atoms(), entry["mass"])
    system.set_temperature(registry_T_kelvin(entry), rng=rng)
    return system


def get_observer(system, data_tag, nbins, registry=None, backend="xla",
                 device="cuda"):
    """(r_axis, g_obs (nbins,) float32 tensor, rdf observable) for the
    registry entry ``data_tag``; its target file is ``entry['fn']`` or,
    for the simulated pair targets, ``entry['rdf_fn']``.  (The JAX
    package reads it comma-delimited only, and so cannot read the argon
    target.)"""
    registry = exp_rdf_data_dict if registry is None else registry
    entry = registry[data_tag]
    data = load_target(entry.get("fn") or entry["rdf_fn"])
    r_range = (entry["start"], entry["end"])
    x, g_obs = get_exp_rdf(data, nbins, r_range)
    obs = rdf(system, nbins, r_range, backend=backend, device=device)
    return x, torch.tensor(g_obs, dtype=torch.float32,
                           device=obs.bins.device), obs


def _check_ported(sys_params):
    """Raise NotImplementedError for a branch of the JAX driver that this
    port does not have yet, naming the ROADMAP item that ports it."""
    get = sys_params.get
    unported = [
        ("pair_flag", bool(get("pair_flag")),
         "the pair-MLP fit with its Boltzmann-inversion pretraining "
         "(ROADMAP Queue 1, Slice B)"),
        ("tpair_flag", bool(get("tpair_flag")),
         "the temperature-dependent pair-MLP fit (ROADMAP Queue 1, Slices "
         "B and D)"),
        ("u_reg_weight", float(get("u_reg_weight", 0.0)) > 0,
         "the pair families' well-depth guard (ROADMAP Queue 1, Slice B)"),
        ("share_prior_aux", bool(get("share_prior_aux")),
         "Stack(share_aux=...) (ROADMAP Queue 1, Slice D)"),
        ("mts_inner", int(get("mts_inner", 0) or 0) > 1,
         "the multi-timestep MTSNoseHooverChain (ROADMAP Queue 1, Slice D)"),
        ("angle_flag", bool(get("angle_flag")),
         "the angle-distribution target (ROADMAP Queue 1, Slice F2)"),
    ]
    for key, on, what in unported:
        if on:
            raise NotImplementedError(f"{key}: {what} is not ported yet")
    if sys_params.get("nbr_mode", "table") == "cells":
        raise NotImplementedError(
            "nbr_mode 'cells': the cell-list table is not ported yet "
            "(ROADMAP Queue 1, Slice E)")


def _build_net_and_prior(assignments):
    """The learnable SchNet and the frozen ExcludedVolume prior."""
    cutoff = assignments["cutoff"]
    prior = pot_zoo.ExcludedVolume(
        epsilon=assignments["epsilon"], sigma=assignments["sigma"],
        power=assignments.get("power", 12))

    def w(v):
        return WIDTH_DICT[v] if isinstance(v, str) else int(v)

    net = SchNet({
        "n_atom_basis": w(assignments["n_atom_basis"]),
        "n_filters": w(assignments["n_filters"]),
        "n_gaussians": int(cutoff // assignments["gaussian_width"]),
        "n_convolutions": assignments["n_convolutions"],
        "cutoff": cutoff, "trainable_gauss": False,
        "compute_dtype": assignments.get("compute_dtype", "float32")})
    return net, prior


def build_fit(assignments, sys_params, registry=None, rng=None,
              device="cuda"):
    """Systems, simulations and observers of every state point.

    Returns a dict: ``systems``, ``sims``, ``observers``, ``targets``,
    ``r_axes`` (one each per tag of ``all_sys``, the training tags
    ``train_list`` first, then ``sys_params['val']``), ``net`` (the SchNet
    every state point shares), ``prior``, ``params`` (the parameters the
    fit trains: the SchNet's) and ``registry``.
    """
    _check_ported(sys_params)
    registry = exp_rdf_data_dict if registry is None else registry
    size = sys_params["size"]
    cutoff = assignments["cutoff"]
    nbins = assignments["nbins"]
    train_list = list(sys_params["data"])
    all_sys = train_list + list(sys_params.get("val") or [])
    net, prior = _build_net_and_prior(assignments)
    # Q = 50 and 5 chains: the reference convention; nhc_tau selects the
    # N-invariant MTK masses instead
    Q = float(sys_params.get("Q") or 50.0)
    nhc_tau = sys_params.get("nhc_tau")
    slack = float(sys_params.get("capacity_slack", 1.6))

    systems, sims, observers, targets, r_axes = [], [], [], [], []
    for tag in all_sys:
        entry = registry[tag]
        system = get_system(tag, size, registry, rng=rng)
        if str(sys_params.get("anneal_flag")) == "True":
            system.set_temperature(assignments["start_T"], rng=rng)
        stack = Stack({
            "nn": GNNPotentials(system, net, cutoff=cutoff,
                                capacity_slack=slack,
                                nbr_mode=sys_params.get("nbr_mode", "table"),
                                skin=float(sys_params.get("gnn_skin", 0.0)),
                                device=device),
            "pair": PairPotentials(system, prior, cutoff=cutoff,
                                   mode=sys_params.get("prior_mode", "auto"),
                                   device=device)})
        params = fit_parameters(stack)
        integ = NoseHooverChain(
            stack, system, T=registry_T_kelvin(entry), Q=Q, tau=nhc_tau,
            num_chains=5, adjoint=bool(sys_params.get("adjoint", True)),
            topology_update_freq=sys_params.get("topology_update_freq", 1),
            device=device)
        x, g_obs, obs = get_observer(
            system, tag, nbins, registry,
            backend=assignments.get("rdf_backend", "xla"), device=device)
        systems.append(system)
        sims.append(Simulation(system, integ))
        observers.append(obs)
        targets.append(g_obs)
        r_axes.append(x)

    return {"systems": systems, "sims": sims, "observers": observers,
            "targets": targets, "r_axes": r_axes, "net": net,
            "prior": prior, "params": params, "train_list": train_list,
            "all_sys": all_sys, "registry": registry}


def make_epoch_loss(sim, obs, g_target, system, tau, dt, frame_skip=20,
                    backward=True):
    """One state point's epoch objective.

    Returns ``loss_fn(state, aux, ctrl) -> (loss, (g, last, final_aux))``:
    it runs one epoch of ``tau - 1`` steps through ``sim.epoch_fn``, takes
    the RDF of every ``frame_skip``-th frame, and returns
    ``compute_D(g - g_target)``.  With ``backward`` it backpropagates the
    loss, so ``.grad`` gains its gradient in every parameter that requires
    grad; without, it runs under ``torch.no_grad()`` and leaves ``.grad``
    alone (a validation state point).  All returned tensors are detached;
    ``last`` is the epoch's last state.
    """
    ode = sim.epoch_fn(dt, tau)
    rho = system.get_number_of_atoms() / system.get_volume()
    rrange = torch.linspace(float(obs.bins[0]), float(obs.bins[-1]),
                            obs.nbins, device=g_target.device)

    def loss_fn(state, aux, ctrl):
        with torch.set_grad_enabled(backward):
            traj, final_aux = ode(state, aux, ctrl)
            _, _, g = obs(traj.q[::frame_skip])
            loss = compute_D(g - g_target, rho, rrange)
            if backward:
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


class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau`` with ``rtol`` 1e-4, no cooldown
    and an accumulation size of 1, in float32 as optax keeps its state.

    :meth:`update` takes this step's value: it improves on the best iff
    ``value < (1 - rtol) * best - atol``, which resets the plateau count;
    otherwise the count grows, and at ``patience`` it resets and the scale
    becomes ``max(scale * factor, min_scale)``.  It returns the new scale,
    the one that multiplies this step's update.
    """

    rtol = 1e-4

    def __init__(self, factor=0.5, patience=25, min_scale=1e-4, atol=1e-5):
        self.factor, self.patience = factor, patience
        self.min_scale, self.atol = min_scale, atol
        self.reset()

    def reset(self):
        self.scale = np.float32(1.0)
        self.best_value = np.float32(np.inf)
        self.plateau_count = 0

    def update(self, value):
        value = np.float32(value)
        if value < (np.float32(1 - self.rtol) * self.best_value
                    - np.float32(self.atol)):
            self.best_value, self.plateau_count = value, 0
        else:
            self.plateau_count += 1
        if self.plateau_count == self.patience:
            self.plateau_count = 0
            self.scale = np.maximum(self.scale * np.float32(self.factor),
                                    np.float32(self.min_scale))
        return float(self.scale)

    def state_dict(self):
        return {"scale": float(self.scale),
                "best_value": float(self.best_value),
                "plateau_count": self.plateau_count}

    def load_state_dict(self, state):
        self.scale = np.float32(state["scale"])
        self.best_value = np.float32(state["best_value"])
        self.plateau_count = int(state["plateau_count"])


class FitUpdate:
    """The update step of the RDF fit: clip the gradients of ``params`` to
    global norm ``grad_clip``, then one Adam step (optax's defaults: betas
    0.9 / 0.999, eps 1e-8), then clear the gradients.

    With ``plateau`` (a :class:`ReduceOnPlateau`), the step is scaled by
    the plateau scale that this step's ``value`` gives and by
    ``step_scale``, as the JAX fit multiplies optax's update.  Adam's step
    is linear in its learning rate, so the scales go into the rate; the
    gradients, and so Adam's moments, stay unscaled.  A parameter with no
    gradient takes a zero one, as JAX's zero cotangent, so it moves by 0
    and Adam's step count is the same for every parameter.
    """

    def __init__(self, params, lr, grad_clip=10.0, plateau=None):
        self.params = list(params)
        self.lr = lr
        self.grad_clip = grad_clip
        self.plateau = plateau
        self.reset()

    def reset(self):
        """A fresh optimizer state."""
        self.opt = torch.optim.Adam(self.params, lr=self.lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        if self.plateau is not None:
            self.plateau.reset()

    def __call__(self, value=None, step_scale=1.0):
        """Returns the gradients' global norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_(self.params, self.grad_clip)
        scale = 1.0 if self.plateau is None else self.plateau.update(value)
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
                            else self.plateau.state_dict())}

    def load_state_dict(self, state):
        # Adam adopts the tensors it is given: give it copies, so that its
        # steps never write into a snapshot
        self.opt.load_state_dict(copy.deepcopy(state["adam"]))
        if self.plateau is not None:
            self.plateau.load_state_dict(state["plateau"])


class _NumpyUnpickler(pickle.Unpickler):
    """Reads containers and numpy arrays, nothing else: an ``init_pkl``
    holds parameters only, and unpickling a class could run any code."""

    _NUMPY = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" and name in self._NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"init_pkl holds {module}.{name}: only dicts, lists and numpy "
            "arrays are read")


def _load_init_pkl(path):
    """The ``nn`` subtree of the parameters in ``path``: a pickle of
    ``{'params': {'nn': ...}}`` (or of the parameter dict itself) whose
    SchNet tree holds dicts and numpy arrays, as the JAX package's
    checkpointer writes them."""
    with open(path, "rb") as f:
        blob = _NumpyUnpickler(f).load()
    params = blob["params"] if isinstance(blob, dict) and \
        "params" in blob else blob
    return params["nn"]


def _net_state(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def fit_rdf(assignments, sys_params, model_path=None, log=print,
            registry=None, rng=None, device="cuda"):
    """Train; returns a dict with ``loss_log``, ``js_log``, the inference
    RDFs under ``final``, ``objective`` (the inference MSE summed over
    state points) and ``params`` (the SchNet's final ``state_dict`` on
    the CPU), or a NaN-bailout dict with the penalty ``objective``.

    ``device`` is where the fit runs: "cuda" (the kernels) unless "cpu" is
    asked for.
    """
    registry = exp_rdf_data_dict if registry is None else registry
    rng = np.random.default_rng(0) if rng is None else rng
    n_epochs = sys_params["n_epochs"]
    n_sim = sys_params.get("n_sim", 2)
    tau = assignments["opt_freq"]
    frame_skip = sys_params.get("frame_skip", 20)

    comps = build_fit(assignments, sys_params, registry, rng=rng,
                      device=device)
    sims, observers, targets = (comps["sims"], comps["observers"],
                                comps["targets"])
    systems, all_sys = comps["systems"], comps["all_sys"]
    train_list, net = comps["train_list"], comps["net"]

    if model_path:
        os.makedirs(model_path, exist_ok=True)
        with open(os.path.join(model_path, "assignments.json"), "w") as f:
            json.dump({k: str(v) for k, v in assignments.items()}, f)

    ckpt = FitCheckpointer(model_path, every=sys_params.get("ckpt_every", 10))
    resume = ckpt.restore()

    # parameters-only warm start: the optimizer and MD states start fresh
    init_pkl = sys_params.get("init_pkl")
    if resume is None and init_pkl:
        net.load_state_dict(schnet_params_from_numpy(_load_init_pkl(init_pkl)))
        log(f"warm start (nn subtree) from {init_pkl}")

    # Adam with reduce-on-plateau on the SchNet only, the prior frozen
    update = FitUpdate(comps["params"], assignments["lr"],
                       assignments.get("grad_clip", 10.0),
                       ReduceOnPlateau(factor=0.5, patience=25,
                                       min_scale=1e-4, atol=1e-5))

    def dt_for(tag):
        return sys_params["dt"] * _dt_scale(registry[tag])

    loss_fns, md_states = [], []
    for tag, sim, obs, g_t, system in zip(all_sys, sims, observers, targets,
                                          systems):
        loss_fns.append(make_epoch_loss(sim, obs, g_t, system, tau,
                                        dt_for(tag), frame_skip,
                                        backward=tag in train_list))
        md_states.append(sim.initial_state())

    loss_log, js_log = [], []
    start_epoch = 0
    if resume is not None:
        net.load_state_dict(resume["params"])
        if sys_params.get("reset_opt_on_resume"):
            # a fresh optimizer over the checkpointed parameters, e.g. to
            # leave a plateau scale that has reached its floor
            update.reset()
            log("optimizer state reset on resume")
        else:
            update.load_state_dict(resume["opt_state"])
        md_states = from_plain(md_states, resume["md_states"])
        loss_log = list(resume["logs"].get("loss_log", []))
        js_log = list(resume["logs"].get("js_log", []))
        start_epoch = resume["epoch"] + 1
        log(f"resumed from checkpoint at epoch {resume['epoch']}")

    # overflow_policy: 'warn' logs; 'skip' also drops the epoch's update
    # (gradients from a trajectory that lost neighbors are corrupt);
    # 'regrow' grows the overflowed tables and restarts the state point
    # from the epoch's entry state
    overflow_policy = sys_params.get("overflow_policy", "warn")
    regrow_factor = float(sys_params.get("regrow_factor", 1.5))
    # NaN recovery: on a non-finite epoch restore the last good snapshot,
    # rethermalize, halve the step scale and retry; after repeated
    # failures go back to an older snapshot of the ring (the last good
    # parameters may be the unstable iterate itself)
    step_scale = 1.0
    snap_every = max(int(sys_params.get("backtrack_every", 10)), 1)
    backtrack_after = int(sys_params.get("backtrack_after", 2))
    max_backtracks = int(sys_params.get("max_backtracks", 8))
    last_good = (_net_state(net), update.state_dict(), list(md_states))
    snaps = []
    fails = backtracks = 0

    def restore(snapshot):
        net_state, opt_state, states = snapshot
        net.load_state_dict(net_state)
        update.load_state_dict(opt_state)
        # fresh momenta: a deterministic replay of the restored state would
        # reproduce a blowup driven by the state
        return [(rethermalize(s, registry_T_kelvin(registry[t]) * units.kB,
                              sims[j].system.get_masses(), rng=rng,
                              dim=sims[j].system.dim), a)
                for j, ((s, a), t) in enumerate(zip(states, all_sys))]

    epoch = start_epoch
    while epoch < n_epochs:
        total_loss = 0.0
        update.zero_grad()
        epoch_overflow = False
        epoch_nan_tag = None
        overflow_js = []
        js_entry_len = len(js_log)
        entry_states = list(md_states)
        for j, tag in enumerate(all_sys):
            sim = sims[j]
            integ = sim.integrator
            if (str(sys_params.get("anneal_flag")) == "True"
                    and epoch % assignments.get("anneal_freq", 5) == 0):
                new_T = get_temp(assignments["start_T"],
                                 registry_T_kelvin(registry[tag]), n_epochs,
                                 epoch, assignments.get("anneal_rate", 2.0))
                integ.update_T(new_T)
            state, aux = md_states[j]
            loss, (g, last, final_aux) = loss_fns[j](state, aux,
                                                     integ.default_ctrl())
            overflowed, _ = sim.check_flags()
            if not _traj_finite(last):
                epoch_nan_tag = tag
                break
            if overflowed:
                log(f"WARNING: neighbor capacity overflow ({tag}, epoch "
                    f"{epoch}) -- results drop neighbors; raise "
                    "k_max/capacity_slack")
                overflow_js.append(j)
                if tag in train_list:
                    epoch_overflow = True
            md_states[j] = (last, final_aux)
            if tag in train_list:
                total_loss += loss.item()
                js_log.append(JS_rdf(targets[j], g).item())

        if epoch_nan_tag is not None:
            update.zero_grad()
            fails += 1
            step_scale *= 0.5
            del js_log[js_entry_len:]
            if ((fails >= backtrack_after or step_scale < 0.1)
                    and snaps and backtracks < max_backtracks):
                sn_epoch, *snapshot = snaps.pop()
                md_states = restore(snapshot)
                last_good = (_net_state(net), update.state_dict(),
                             list(md_states))
                backtracks += 1
                step_scale, fails = 0.25, 0
                log(f"epoch {epoch} ({epoch_nan_tag}): non-finite "
                    f"persists; BACKTRACK to the epoch-{sn_epoch} "
                    f"snapshot ({len(snaps)} snapshots left, "
                    f"{max_backtracks - backtracks} backtracks left)")
                continue
            if step_scale < 1 / 64:
                log(f"NaN bailout at epoch {epoch} ({epoch_nan_tag}, "
                    "step_scale exhausted)")
                return {"objective": 5 - (epoch / n_epochs) * 5,
                        "nan_bailout": True, "loss_log": loss_log}
            md_states = restore(last_good)
            log(f"epoch {epoch} ({epoch_nan_tag}): non-finite trajectory; "
                f"restored last-good + rethermalized, "
                f"step_scale -> {step_scale:g}")
            continue

        if overflow_js and overflow_policy == "regrow":
            if epoch_overflow:
                log(f"epoch {epoch}: parameter update skipped "
                    "(overflow_policy='regrow')")
            for j in overflow_js:
                model = sims[j].integrator.model
                entry_state, _ = entry_states[j]
                if model.grow_capacity(regrow_factor):
                    md_states[j] = (entry_state,
                                    model.aux_init(entry_state.q))
                    log(f"regrow: {all_sys[j]} neighbor capacity grown; "
                        "epoch entry state restored")
                else:
                    log(f"regrow: {all_sys[j]} already at maximum "
                        "capacity -- overflow is unrecoverable here")
        if epoch_overflow and overflow_policy in ("skip", "regrow"):
            if overflow_policy == "skip":
                log(f"epoch {epoch}: parameter update skipped "
                    "(overflow_policy='skip')")
            update.zero_grad()
        else:
            update(total_loss, step_scale)
        fails = 0
        if epoch % snap_every == 0:
            # this verified epoch's entry parameters (still last_good's)
            # with its final MD states
            snaps.append((epoch, last_good[0], last_good[1],
                          list(md_states)))
            del snaps[:-3]
        last_good = (_net_state(net), update.state_dict(), list(md_states))
        # grow a halved scale back slowly after clean epochs
        step_scale = min(1.0, step_scale * 1.26)
        loss_log.append(total_loss)
        log(f"epoch {epoch} | loss: {total_loss:.5f}")
        ckpt.maybe_save(epoch, net.state_dict(), update.state_dict(),
                        md_states, {"loss_log": loss_log, "js_log": js_log})
        epoch += 1

    # inference: longer sampling and the test_nbins RDF
    results = {"loss_log": loss_log, "js_log": js_log, "final": {}}
    total = 0.0
    test_nbins = sys_params.get("test_nbins", 800)
    for j, tag in enumerate(all_sys):
        sim = sims[j]
        sim.state, sim.aux = md_states[j]
        # the last training frame, then each rollout's last; a diverged
        # rollout's frame is skipped and the next restarts from the last
        # training state
        frames = [md_states[j][0].q]
        for _ in range(n_sim):
            traj = sim.simulate(steps=100, dt=dt_for(tag), frequency=25)
            f = traj.q[-1]
            if bool(torch.isfinite(f).all()):
                frames.append(f)
            else:
                log(f"inference rollout diverged for {tag}; frame skipped")
                sim.state, sim.aux = md_states[j]
        # the training backend: the dense one materialises (pairs, nbins)
        x, g_obs, obs = get_observer(
            systems[j], tag, test_nbins, registry,
            backend=assignments.get("rdf_backend", "xla"), device=device)
        with torch.no_grad():
            g_sim = np.mean([obs(f)[2].cpu().numpy() for f in frames],
                            axis=0)
        g_obs = g_obs.cpu().numpy()
        mse = float(((g_obs - g_sim) ** 2).mean())
        results["final"][tag] = {"r": x, "g_sim": g_sim, "g_obs": g_obs,
                                 "mse": mse}
        if model_path:
            np.savetxt(os.path.join(model_path, f"rdf_{tag}.csv"),
                       np.vstack([x, g_sim]), delimiter=",")
        total += mse
    results["objective"] = total
    results["params"] = {k: v.cpu() for k, v in _net_state(net).items()}
    if model_path:
        np.savetxt(os.path.join(model_path, "loss.csv"),
                   np.asarray(loss_log))
        from .plots import plot_loss, plot_rdfs
        plot_loss(loss_log, model_path)
        for tag, fin in results["final"].items():
            plot_rdfs(fin["r"], fin["g_obs"], fin["g_sim"],
                      f"rdf_{tag}_final", model_path, pname="final")
    return results
