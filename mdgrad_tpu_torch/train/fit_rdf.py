"""The RDF-fitting driver: learn a potential from target g(r) through MD
gradients.

Port of ``mdgrad_tpu/train/fit_rdf.py``.  :func:`build_fit` makes one
system per state point from a registry entry (the 2-D stripe entries on a
square lattice), one learnable potential shared by every state point --
a SchNet under ``GNNPotentials``, or with ``pair_flag`` / ``tpair_flag`` a
``PairMLP`` / ``TPairMLP`` under ``PairPotentials`` / ``TPairPotentials``
(mode 'table') -- with a frozen ExcludedVolume
prior in a ``Stack``, a Nose-Hoover chain (Q = 50, 5 chains) and an RDF
observer.  :func:`fit_rdf` then trains: each epoch
simulates ``opt_freq`` frames per state point, takes the soft-histogram
RDF of every ``frame_skip``-th, and backpropagates ``compute_D`` against
the target through the trajectory (:func:`make_epoch_loss`, the replay
adjoint by default); the gradients of the training state points are
summed, clipped to a global norm and fed to Adam with reduce-on-plateau
and a step scale (:class:`FitUpdate`).  Around that: temperature
annealing, NaN recovery (restore the last good snapshot, rethermalize,
halve the step scale), a backtrack to an older snapshot when failures
persist, the ``overflow_policy`` branches ('warn', 'skip', 'regrow'),
checkpoints and resume (:mod:`.checkpoint`), an ``init_pkl`` warm start
(any JAX pickle, :func:`.checkpoint.jax_params`),
for the pair families Boltzmann-inversion pretraining (skipped on resume
and on ``init_pkl``) and the well-depth guard ``u_reg_weight``, and the
inference phase: ``n_sim`` rollouts of 100 steps and the
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
Each ``TPairPotentials`` holds its own state point's kT, where the JAX
driver grafts it into the shared params (``kT_override``).
``share_prior_aux`` (SchNet only) hands the GNN's neighbor table to the
prior, which then runs in mode 'table' (``Stack(share_aux=...)``);
``mts_inner`` k > 1 (SchNet only) integrates with the
``MTSNoseHooverChain`` -- the SchNet the slow force, the prior the fast
one at dt / k -- at an outer step of k dt, over ``opt_freq // k`` frames
an epoch and every ``frame_skip // k``-th of them, so the inner step and
the simulated window stay the single-rate fit's.  ``angle_flag`` adds the
water angle-distribution target (``angle_data_dict``, ``angle_cutoff``
2.7 or 3.7) to every state point's epoch loss, weighted by
``angle_weight``, and reports ``angle_sim`` / ``angle_obs`` /
``angle_mse`` after inference; ``nbr_mode='cells'`` builds the SchNet's
table through the cell list (``ops/cells.py``).  ``u_reg_weight`` with a
SchNet raises ``NotImplementedError`` (the JAX package's fit ignores it
there).
"""

import json
import os

import numpy as np
import torch

from .. import units
from .. import potentials as pot_zoo
from ..data.registry import (angle_data_dict, exp_angle_data,
                             exp_rdf_data_dict, get_exp_rdf, get_unit_len,
                             load_target, number_density_unit_len)
from ..interface import GNNPotentials, PairPotentials, Stack, TPairPotentials
from ..lattice import square_lattice_2d
from ..md import MTSNoseHooverChain, NoseHooverChain, Simulation, rethermalize
from ..nn import PairMLP, SchNet, TPairMLP
from ..nn.convert import pair_mlp_params_from_numpy, schnet_params_from_numpy
from ..observables import angle_distribution, rdf
from ..system import System
from .checkpoint import FitCheckpointer, from_plain, jax_params
from .loss import JS_rdf, compute_D
from .optim import FitUpdate, ReduceOnPlateau
from .pretrain import boltzmann_inversion_pretrain

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
    with Maxwell-Boltzmann velocities at its temperature from ``rng``.
    A 2-D entry (the stripe systems, reduced units) takes a square lattice
    of ``entry['size']`` (else ``size``) sites a side at its density."""
    registry = exp_rdf_data_dict if registry is None else registry
    entry = registry[data_tag]
    if entry.get("dim", 3) == 2:
        positions, cell = square_lattice_2d(entry["rho"],
                                            entry.get("size", size))
        system = System(positions, cell, dim=2)
        system.masses = np.full(len(positions), entry.get("mass", 1.0))
        system.set_temperature(entry["T"] / units.kB, rng=rng)
        return system
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
                 device="cuda", dtype=torch.float32):
    """(r_axis, g_obs (nbins,) ``dtype`` tensor, rdf observable) for the
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
    return x, torch.tensor(g_obs, dtype=dtype, device=obs.bins.device), obs


def _check_ported(sys_params):
    """Raise NotImplementedError for a branch of the JAX driver that this
    port does not have yet, naming the ROADMAP item that ports it."""
    get = sys_params.get
    unported = [
        ("u_reg_weight", float(get("u_reg_weight", 0.0)) > 0
         and not _pair_family(sys_params),
         "the well-depth guard with a SchNet (it guards the pair families "
         "only; the JAX driver ignores it here)"),
    ]
    for key, on, what in unported:
        if on:
            raise NotImplementedError(f"{key}: {what} is not ported yet")


def _pair_family(sys_params):
    return bool(sys_params.get("pair_flag") or sys_params.get("tpair_flag"))




def _build_net_and_prior(assignments, sys_params=None, device="cuda"):
    """The learnable potential -- a SchNet, or for the pair families a
    ``PairMLP`` / ``TPairMLP`` without residual connections -- and the
    frozen ExcludedVolume prior."""
    sys_params = sys_params or {}
    cutoff = assignments["cutoff"]
    prior = pot_zoo.ExcludedVolume(
        epsilon=assignments["epsilon"], sigma=assignments["sigma"],
        power=assignments.get("power", 12))
    if _pair_family(sys_params):
        cls = TPairMLP if sys_params.get("tpair_flag") else PairMLP
        net = cls(n_gauss=int(cutoff // assignments["gaussian_width"]),
                  r_start=0.0, r_end=cutoff, n_layers=assignments["n_layers"],
                  n_width=assignments["n_width"],
                  nonlinear=assignments["nonlinear"], res=False,
                  device=device)
        return net, prior

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
              device="cuda", dtype=torch.float32):
    """Systems, simulations and observers of every state point.

    Returns a dict: ``systems``, ``sims``, ``observers``, ``targets``,
    ``r_axes`` (one each per tag of ``all_sys``, the training tags
    ``train_list`` first, then ``sys_params['val']``), ``net`` (the
    potential every state point shares), ``prior``, ``params`` (the
    parameters the fit trains: the net's, never a ``TPairPotentials``' kT)
    and ``registry``.  ``dtype``: the MD's, the models' and the targets'
    (float64 for parity checks).
    """
    _check_ported(sys_params)
    registry = exp_rdf_data_dict if registry is None else registry
    size = sys_params["size"]
    cutoff = assignments["cutoff"]
    nbins = assignments["nbins"]
    train_list = list(sys_params["data"])
    all_sys = train_list + list(sys_params.get("val") or [])
    net, prior = _build_net_and_prior(assignments, sys_params, device)
    # Q = 50 and 5 chains: the reference convention; nhc_tau selects the
    # N-invariant MTK masses instead
    Q = float(sys_params.get("Q") or 50.0)
    nhc_tau = sys_params.get("nhc_tau")
    slack = float(sys_params.get("capacity_slack", 1.6))
    # the prior reads the GNN's table; the pair families never share
    share = bool(sys_params.get("share_prior_aux")) and not \
        _pair_family(sys_params)
    mts_k = int(sys_params.get("mts_inner", 0) or 0)

    systems, sims, observers, targets, r_axes = [], [], [], [], []
    for tag in all_sys:
        entry = registry[tag]
        system = get_system(tag, size, registry, rng=rng)
        if str(sys_params.get("anneal_flag")) == "True":
            system.set_temperature(assignments["start_T"], rng=rng)
        # the pair MLPs run on the (N, K) table: dense mode's
        # (N, N, hidden) activations are the memory traffic at fit scale
        if sys_params.get("pair_flag"):
            nn_int = PairPotentials(system, net, cutoff=cutoff, mode="table",
                                    capacity_slack=slack, device=device)
        elif sys_params.get("tpair_flag"):
            nn_int = TPairPotentials(system, net, registry_T_kelvin(entry),
                                     cutoff=cutoff, mode="table",
                                     capacity_slack=slack, device=device)
        else:
            nn_int = GNNPotentials(
                system, net, cutoff=cutoff, capacity_slack=slack,
                nbr_mode=sys_params.get("nbr_mode", "table"),
                skin=float(sys_params.get("gnn_skin", 0.0)), device=device)
        stack = Stack({
            "nn": nn_int,
            "pair": PairPotentials(
                system, prior, cutoff=cutoff, device=device,
                mode="table" if share else sys_params.get("prior_mode",
                                                          "auto"))},
            share_aux={"pair": "nn"} if share else None)
        if dtype != torch.float32:
            stack.to(dtype)
        params = fit_parameters(stack)
        kw = dict(T=registry_T_kelvin(entry), Q=Q, tau=nhc_tau, num_chains=5,
                  adjoint=bool(sys_params.get("adjoint", True)),
                  topology_update_freq=sys_params.get("topology_update_freq",
                                                      1),
                  device=device, dtype=dtype)
        if mts_k > 1 and not _pair_family(sys_params):
            # the SchNet at the outer step, the prior at dt / k
            integ = MTSNoseHooverChain(stack, system, fast_keys=("pair",),
                                       n_inner=mts_k, **kw)
        else:
            integ = NoseHooverChain(stack, system, **kw)
        x, g_obs, obs = get_observer(
            system, tag, nbins, registry,
            backend=assignments.get("rdf_backend", "xla"), device=device,
            dtype=dtype)
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
                    backward=True, angle_extra=None):
    """One state point's epoch objective.

    Returns ``loss_fn(state, aux, ctrl) -> (loss, (g, last, final_aux))``:
    it runs one epoch of ``tau - 1`` steps through ``sim.epoch_fn``, takes
    the RDF of every ``frame_skip``-th frame, and returns
    ``compute_D(g - g_target)``; ``angle_extra = (angle_distribution,
    target, weight)`` adds weight times the summed squared difference of
    the same frames' angle distribution from the target.  With
    ``backward`` it backpropagates the
    loss, so ``.grad`` gains its gradient in every parameter that requires
    grad; without, it runs under ``torch.no_grad()`` and leaves ``.grad``
    alone (a validation state point).  All returned tensors are detached;
    ``last`` is the epoch's last state.
    """
    ode = sim.epoch_fn(dt, tau)
    rho = system.get_number_of_atoms() / system.get_volume()
    rrange = torch.linspace(float(obs.bins[0]), float(obs.bins[-1]),
                            obs.nbins, dtype=g_target.dtype,
                            device=g_target.device)

    def loss_fn(state, aux, ctrl):
        with torch.set_grad_enabled(backward):
            traj, final_aux = ode(state, aux, ctrl)
            frames = traj.q[::frame_skip]
            _, _, g = obs(frames)
            loss = compute_D(g - g_target, rho, rrange)
            if angle_extra is not None:
                aobs, a_target, a_w = angle_extra
                _, a_count, _ = aobs(frames)
                loss = loss + a_w * ((a_count - a_target) ** 2).sum()
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


def _net_state_from_numpy(net, tree):
    """The state_dict of ``net`` from the JAX package's tree of its
    counterpart (a ``TPairPotentials``' tree holds the model under
    ``model``, beside kT)."""
    if isinstance(net, SchNet):
        return schnet_params_from_numpy(tree)
    return pair_mlp_params_from_numpy(tree.get("model", tree))


class _DepthGuard:
    """``u_reg_weight * sum over training kT of relu(floor - depth)^2``,
    depth the minimum of net + prior on the guard's grid; calling it adds
    its gradient to the net's ``.grad`` and returns its value."""

    def __init__(self, energy, kTs, weight, mult):
        self.energy, self.kTs, self.weight = energy, kTs, weight
        with torch.no_grad():
            self.d0 = np.array([self.depth(kT).item() for kT in kTs])
        self.floor = mult * np.minimum(self.d0, 0.0)

    def depth(self, kT):
        return self.energy(kT).min()

    def __call__(self):
        d = torch.stack([self.depth(kT) for kT in self.kTs])
        floor = torch.as_tensor(self.floor, dtype=d.dtype, device=d.device)
        reg = self.weight * (torch.relu(floor - d) ** 2).sum()
        reg.backward()
        return reg.item()


def _depth_guard(net, prior, all_sys, train_list, registry, cutoff, weight,
                 mult, tpair):
    """The well-depth guard of the JAX driver: a 200-point grid from the
    lowest target start + 0.3 to the cutoff, the depths after
    pretraining."""
    p0 = next(net.parameters())
    kw = {"dtype": p0.dtype, "device": p0.device}
    rr_lo = min(registry[t]["start"] for t in all_sys)
    grid = torch.linspace(rr_lo + 0.3, cutoff, 200, **kw)[:, None]
    kTs = [torch.tensor(registry_T_kelvin(registry[t]) * units.kB, **kw)
           for t in train_list]

    def energy(kT):
        u = net(grid, kT) if tpair else net(grid)
        return u.squeeze(-1) + prior(grid).squeeze(-1)

    return _DepthGuard(energy, kTs, weight, mult)


def _angle_extras(assignments, sys_params, systems, like, device):
    """Per state point ``(angle_distribution, target, weight)`` of the
    angle target with ``angle_flag``, else None each: ``angle_nbins``
    (64) bins over (``angle_start`` (0.5), pi), neighbors inside
    ``angle_cutoff`` (3.7, which with 2.7 picks the target file of
    ``angle_data_dict[angle_species]`` unless ``angle_fn`` is given), at
    most ``angle_k_max`` (24) of them; the target in ``like``'s dtype."""
    if not sys_params.get("angle_flag"):
        return [None] * len(systems)
    a_cut = float(assignments.get("angle_cutoff", 3.7))
    a_nbins = int(assignments.get("angle_nbins", 64))
    a_range = (float(assignments.get("angle_start", 0.5)), float(np.pi))
    a_w = float(assignments.get("angle_weight", 1.0))
    species = sys_params.get("angle_species", "water")
    fn = sys_params.get("angle_fn") or angle_data_dict[species][a_cut]
    a_target = torch.tensor(exp_angle_data(a_nbins, a_range, fn),
                            dtype=like.dtype, device=like.device)
    return [(angle_distribution(system, a_nbins, a_range, cutoff=a_cut,
                                k_max=int(sys_params.get("angle_k_max", 24)),
                                device=device), a_target, a_w)
            for system in systems]


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
    # multiple time steps: the outer step is k dt, so an epoch takes
    # tau // k frames and every (frame_skip // k)-th of them (as in the JAX
    # driver, also for a pair family, which integrates at one rate)
    dt_mult = max(int(sys_params.get("mts_inner", 0) or 0), 1)
    if dt_mult > 1:
        tau = max(2, tau // dt_mult)
        frame_skip = max(1, frame_skip // dt_mult)

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
        net.load_state_dict(_net_state_from_numpy(
            net, jax_params(init_pkl, "nn")))
        log(f"warm start (nn subtree) from {init_pkl}")

    # Boltzmann-inversion pretraining of the pair families; a resumed or
    # warm-started fit already holds it
    pair_family = _pair_family(sys_params)
    if resume is None and not init_pkl and pair_family:
        T_list = [registry_T_kelvin(registry[t]) for t in all_sys]
        rr_lo = min(registry[t]["start"] for t in all_sys)
        rr_hi = max(registry[t]["end"] for t in all_sys)
        boltzmann_inversion_pretrain(
            net, comps["prior"], comps["r_axes"], targets, T_list,
            rrange=np.linspace(rr_lo + 0.5, rr_hi, 500),
            n_iters=sys_params.get("pretrain_iters", 1000),
            temperature_dependent=bool(sys_params.get("tpair_flag")))

    # Adam with reduce-on-plateau on the net only, the prior frozen
    update = FitUpdate(comps["params"], assignments["lr"],
                       assignments.get("grad_clip", 10.0),
                       ReduceOnPlateau(factor=0.5, patience=25,
                                       min_scale=1e-4, atol=1e-5))

    # the pair families' well-depth guard: penalise u(r, kT) deepening past
    # u_floor_mult times the pretrained depth (at each training kT)
    u_reg_weight = float(sys_params.get("u_reg_weight", 0.0))
    depth_guard = None
    if u_reg_weight > 0 and pair_family:
        depth_guard = _depth_guard(
            net, comps["prior"], all_sys, train_list, registry,
            assignments["cutoff"], u_reg_weight,
            float(sys_params.get("u_floor_mult", 1.5)),
            bool(sys_params.get("tpair_flag")))
        log(f"depth guard: pretrained depths "
            f"{np.round(depth_guard.d0, 3)}, floors "
            f"{np.round(depth_guard.floor, 3)}")

    def dt_for(tag):
        return sys_params["dt"] * _dt_scale(registry[tag]) * dt_mult

    angle_extras = _angle_extras(assignments, sys_params, systems,
                                 targets[0], device)
    loss_fns, md_states = [], []
    for tag, sim, obs, g_t, system, a_extra in zip(
            all_sys, sims, observers, targets, systems, angle_extras):
        loss_fns.append(make_epoch_loss(sim, obs, g_t, system, tau,
                                        dt_for(tag), frame_skip,
                                        backward=tag in train_list,
                                        angle_extra=a_extra))
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
            if depth_guard is not None:
                total_loss += depth_guard()
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
        if angle_extras[j] is not None:
            aobs, a_target, _ = angle_extras[j]
            with torch.no_grad():
                _, a_count, _ = aobs(torch.stack(frames))
            a_sim, a_obs = a_count.cpu().numpy(), a_target.cpu().numpy()
            results["final"][tag].update(
                angle_sim=a_sim, angle_obs=a_obs,
                angle_mse=float(((a_sim - a_obs) ** 2).mean()))
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
