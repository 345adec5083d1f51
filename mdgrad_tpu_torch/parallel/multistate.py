"""Multi-state-point RDF fitting on one device.

Port of ``mdgrad_tpu/parallel/multistate.py``.  Each state point has its
own box, temperature and target g(r); one loss sums theirs, and its
gradient is the sum of the per-state gradients.  The JAX package ``vmap``s
the states and shards them over a mesh; here they run one after another
in one process, and :func:`make_stack_multistate_train_step` splits them
over the ranks of a ``torch.distributed`` group (dp), each rank running
its share in turn.  Each state's loss
is backpropagated as soon as its epoch ends (the replay adjoint re-runs
that state's steps with its own kT and cell), so ``.grad`` holds the
summed gradient: what the JAX ``dp = 1`` program computes.

* :func:`make_multistate_fit` -- the dense pair-potential engine: a
  masked i < j pair sum with the safe square root under the library
  Nose-Hoover chain's step without the force cache, a wrap before every
  step, the soft RDF of the last frame and its mean squared error.
* :func:`make_stack_multistate_fit` -- any interaction through the
  library integrator: the model is a ``WithDynamicCell`` on a prototype
  system, so the state's cell rides the aux and one integrator serves
  every box; the wrap before each refresh reads that cell from the aux.
  ``_soft_rdf_frames`` is plain torch, as the JAX package's is plain
  ``jnp`` (the per-state cell and the ``end + 0.5`` cut make it another
  function than the RDF kernels).
"""

import typing

import numpy as np
import torch

from .. import topology
from ..interface import Interaction
from ..md.adjoint import make_odeint
from ..md.integrators import NoseHooverChain, NVTState
from ..observables import generate_vol_bins
from ..system import System
from ..train.loss import compute_D
from .mesh import _rank, _size, all_gather_rows, all_reduce_grads


class MultiStateConfig(typing.NamedTuple):
    """The configuration every state point shares."""
    cutoff: float
    dt: float
    n_steps: int
    Q: typing.Any                # NHC chain masses (C,)
    n_dof: int
    nbins: int
    rdf_range: typing.Tuple[float, float]


def _min_image_elem(disp, cell_len):
    """Elementwise single-image minimum image for a diagonal cell given as
    its (3,) lengths."""
    off = (-(disp > 0.5 * cell_len).to(disp.dtype)
           + (disp < -0.5 * cell_len).to(disp.dtype))
    return disp + off * cell_len


def _wrap_q_grad_safe(q, cell_len):
    """Periodic wrap of ``q`` by a lattice shift computed without gradient
    (an identity Jacobian)."""
    with torch.no_grad():
        shift = -torch.floor(q / cell_len) * cell_len
    return q + shift


def _rdf_grid(nbins, rdf_range, dim, like):
    """(offsets, widths, cut_b, vol_bins, V, rrange) of the soft RDF on
    ``like``'s dtype and device."""
    start, end = rdf_range
    kw = {"dtype": like.dtype, "device": like.device}
    offsets = torch.linspace(start, end, nbins, **kw)
    widths = torch.full((nbins,), (offsets[1] - offsets[0]).item(), **kw)
    V, vol_bins, _ = generate_vol_bins(start, end, nbins, dim=dim)
    return (offsets, widths, end + 0.5, torch.tensor(vol_bins, **kw), V,
            torch.linspace(start, end, nbins, **kw))


def _soft_rdf_frames(frames, cell_len, offsets, widths, cut_b, vol_bins, V):
    """Soft-histogram g(r) over (F, N, 3) frames in the cell of lengths
    ``cell_len``: Gaussians of width ``widths`` at ``offsets`` over every
    i < j pair inside ``cut_b``, counts summed over the frames, normalised,
    then divided by the shell volumes' share of ``V``."""
    n = frames.shape[-2]
    i, j = torch.triu_indices(n, n, offset=1, device=frames.device)
    d = _min_image_elem(frames[:, j] - frames[:, i], cell_len)
    dist_sq = (d ** 2).sum(-1)
    mask = dist_sq < cut_b ** 2
    dist = torch.sqrt(torch.where(mask, dist_sq, torch.ones_like(dist_sq)))
    g = torch.exp(-0.5 * ((dist[..., None] - offsets) / widths) ** 2)
    counts = (g * mask[..., None]).sum((0, 1))
    counts = counts / counts.sum()
    return counts / (vol_bins / V)


class _DensePairSum(Interaction):
    """The pair engine's energy: ``pair_model`` summed over the i < j
    pairs within ``cutoff`` in the cell of lengths ``aux``, the square root
    taken of 1 on masked pairs so that they give no NaN gradient."""

    def __init__(self, pair_model, cutoff):
        super().__init__()
        self.model, self.cutoff = pair_model, cutoff

    def energy(self, q, aux, cell=None):
        disp = _min_image_elem(q[None, :, :] - q[:, None, :], aux)
        dist_sq = (disp ** 2).sum(-1)
        ids = torch.arange(q.shape[0], device=q.device)
        mask = (ids[None, :] > ids[:, None]) & (dist_sq < self.cutoff ** 2)
        safe = torch.sqrt(torch.where(mask, dist_sq,
                                      torch.ones_like(dist_sq)))
        u = self.model(safe[..., None]).squeeze(-1)
        return torch.where(mask, u, torch.zeros_like(u)).sum()


def make_multistate_fit(pair_model, cfg):
    """The dense pair-potential multi-state objective.

    Returns ``loss_fn(states, cell_lens, kTs, targets, masses) ->
    (summed loss, finals)``: ``states`` an ``NVTState`` with q / v (S, N,
    3) and pv (S, C), ``cell_lens`` (S, 3), ``kTs`` (S,), ``targets`` (S,
    nbins), ``masses`` (N,); ``finals`` the S final states, stacked.  Each
    state takes ``cfg.n_steps`` steps of the library chain
    (``NoseHooverChain.step`` on a state without the force cache, with the
    chain masses ``cfg.Q`` and ``cfg.n_dof`` degrees of freedom), wrapped
    before every step; its loss is the mean squared deviation of the soft
    RDF of its last frame.  The loss is differentiable in ``pair_model``'s
    parameters (forces at ``create_graph`` when grad is enabled); the
    states' losses are summed before the caller's backward, as the JAX
    engine sums them over its mesh.
    """
    model = _DensePairSum(pair_model, cfg.cutoff)

    def loss_fn(states, cell_lens, kTs, targets, masses):
        like = states.q
        kw = {"dtype": like.dtype, "device": like.device}
        S, n = like.shape[:2]
        masses = np.asarray(torch.as_tensor(masses).cpu(), dtype=np.float64)
        # the system gives the masses only: the cell rides the aux, kT the
        # ctrl, and the chain masses and degrees of freedom are cfg's
        integ = NoseHooverChain(model, System(np.zeros((n, 3)), np.ones(3),
                                              masses=masses),
                                T=0.0, num_chains=states.pv.shape[1],
                                adjoint=False, device=like.device,
                                dtype=like.dtype)
        integ.Q = torch.as_tensor(cfg.Q).to(**kw)
        integ.n_dof = cfg.n_dof
        create_graph = torch.is_grad_enabled()
        total, finals = 0.0, []
        for j in range(S):
            cell_len = torch.as_tensor(cell_lens[j], **kw)
            ctrl = {"kT": torch.as_tensor(kTs[j], **kw)}
            s = NVTState(v=states.v[j], q=states.q[j], pv=states.pv[j])
            for _ in range(cfg.n_steps):
                # the wrap before every step, as the epoch's refresh wraps
                s = s._replace(q=_wrap_q_grad_safe(s.q, cell_len))
                s = integ.step(s, cell_len, ctrl, cfg.dt, create_graph)
            offsets, widths, cut_b, vol_bins, V, _ = _rdf_grid(
                cfg.nbins, cfg.rdf_range, 3, s.q)
            g = _soft_rdf_frames(s.q[None], cell_len, offsets, widths,
                                 cut_b, vol_bins, V)
            total = total + ((g - torch.as_tensor(targets[j]).to(g)) ** 2
                             ).mean()
            finals.append(s)
        return total, NVTState(*(torch.stack(x) for x in zip(*finals)))

    return loss_fn


def make_multistate_train_step(pair_model, cfg, lr=1e-3):
    """``train_step(states, cell_lens, kTs, targets, masses) -> (loss,
    finals)``: one multi-state epoch, then one SGD step of ``lr`` on
    ``pair_model``'s parameters with the summed gradient, in place."""
    loss_fn = make_multistate_fit(pair_model, cfg)
    params = [p for p in pair_model.parameters() if p.requires_grad]

    def train_step(states, cell_lens, kTs, targets, masses):
        loss, finals = loss_fn(states, cell_lens, kTs, targets, masses)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p -= lr * g
        return loss.detach(), NVTState(*(x.detach() for x in finals))

    return train_step


def make_stack_multistate_fit(integ, dt, n_steps, nbins, rdf_range,
                              frame_skip=1, loss_type="shell", dim=3,
                              set_kT=None):
    """The multi-state epoch objective for any interaction through the
    library integrator.

    ``integ`` is an integrator over a ``WithDynamicCell`` model built on a
    prototype system (a bare model keeps the entry wrap only).  Returns
    ``loss_fn(states, cell_lens, kTs, targets, rhos, backward=True) ->
    (total, (losses, gs, finals, overflow))``: ``states`` a list of the S
    states (``integ.initial_state()``'s type), ``cell_lens`` (S, 3),
    ``kTs`` (S,), ``targets`` (S, nbins), ``rhos`` (S,) number densities
    (the shell weight; ones for ``loss_type='mse'``).  Each state runs one
    epoch of ``n_steps`` steps from its wrapped state, the aux built in its
    own cell and the force primed there, and its loss is the shell-weighted
    (``compute_D``) or plain mean squared deviation of the soft RDF of
    every ``frame_skip``-th frame.  With ``backward`` and grad enabled each
    state's loss is backpropagated right after its epoch, so ``.grad``
    gains the summed gradient; every returned tensor is detached.
    ``finals`` are the last states, ``overflow`` a bool per state, ORed
    over every refresh of its epoch.

    ``set_kT(kT)``: for a model whose temperature is a buffer (a
    ``TPairPotentials``' ``kT``), called with each state's kT before its
    epoch, the counterpart of the JAX ``kT_to_params`` graft; no gradient
    reaches it.
    """
    model = integ.model
    can_prime = integ.default_method in ("verlet", "NH_verlet")
    flags = []

    def step_fn(state, aux, ctrl, i, create_graph):
        return integ.step(state, aux, ctrl, dt, create_graph, t=i * dt)

    def aux_up(state, aux):
        aux = integ.aux_update(state.q.detach(), aux)
        flags.append(topology.aux_flag(aux, "overflow"))
        return aux

    wrap_fn = None
    if hasattr(model, "cell_len0"):
        def wrap_fn(s, a):
            return s._replace(q=_wrap_q_grad_safe(s.q, a[0]))

    ode = make_odeint(step_fn, aux_up, n_steps,
                      update_freq=integ.topology_update_freq,
                      adjoint=bool(integ.adjoint),
                      skip_first_refresh=can_prime, wrap_fn=wrap_fn)

    def one_state(state, cell_len, kT, target, rho, backward):
        if set_kT is not None:
            set_kT(kT)
        flags.clear()
        with torch.set_grad_enabled(backward):
            state = state._replace(q=_wrap_q_grad_safe(state.q, cell_len))
            aux = model.aux_init(state.q.detach(), cell=cell_len)
            flags.append(topology.aux_flag(aux, "overflow"))
            if can_prime:
                state, aux = integ.prime_state(
                    state, aux, create_graph=backward, fresh_aux=True)
            params = [p for p in model.parameters() if p.requires_grad]
            traj, _ = ode(params, state, aux, {"kT": kT})
            offsets, widths, cut_b, vol_bins, V, rrange = _rdf_grid(
                nbins, rdf_range, dim, traj.q)
            g = _soft_rdf_frames(traj.q[::frame_skip], cell_len, offsets,
                                 widths, cut_b, vol_bins, V)
            dev = g - target
            loss = (compute_D(dev, rho, rrange) if loss_type == "shell"
                    else (dev ** 2).mean())
            if backward:
                loss.backward()
        last = traj._replace(**{
            k: getattr(traj, k)[-1].detach() for k in traj._fields
            if torch.is_tensor(getattr(traj, k))})
        over = [f for f in flags if f is not None]
        overflow = bool(torch.stack(over).any()) if over else False
        return loss.detach(), g.detach(), last, overflow

    def loss_fn(states, cell_lens, kTs, targets, rhos, backward=True):
        backward = backward and torch.is_grad_enabled()
        like = states[0].q
        kw = {"dtype": like.dtype, "device": like.device}
        out = [one_state(s, torch.as_tensor(c, **kw),
                         torch.as_tensor(kT, **kw),
                         torch.as_tensor(t, **kw), float(rho), backward)
               for s, c, kT, t, rho in zip(states, cell_lens, kTs, targets,
                                           rhos)]
        losses, gs, finals, overflow = (list(x) for x in zip(*out))
        losses = torch.stack(losses)
        return losses.sum(), (losses, torch.stack(gs), finals, overflow)

    return loss_fn


def make_stack_multistate_train_step(integ, dt, n_steps, nbins, rdf_range,
                                     opt, group=None, frame_skip=1,
                                     loss_type="shell", dim=3, set_kT=None):
    """``train_step(states, cell_lens, kTs, targets, rhos) -> (loss,
    (losses, gs, finals, overflow))``: one multi-state epoch of
    :func:`make_stack_multistate_fit` and one step of ``opt`` (a
    ``torch.optim.Optimizer`` over the model's trainable parameters) on
    the summed gradients; a parameter without a gradient gets zeros, as
    the JAX package's optax update sees them.

    With ``group`` (a ``torch.distributed`` process group, dp), rank k
    runs the k-th of its equal blocks of the S states, the gradients are
    summed over the group before the step (the same step on every rank,
    so the parameters stay equal), and ``losses``, ``gs``, ``overflow``
    and ``finals`` are gathered back to all S states on every rank.
    ``loss`` is the sum over the S states.  Every returned tensor is
    detached.
    """
    loss_fn = make_stack_multistate_fit(integ, dt, n_steps, nbins,
                                        rdf_range, frame_skip, loss_type,
                                        dim, set_kT)
    params = [p for p in integ.model.parameters() if p.requires_grad]

    def gather(x):
        return x if group is None else all_gather_rows(x, group)

    def train_step(states, cell_lens, kTs, targets, rhos):
        S, size = len(states), _size(group)
        if S % size:
            raise ValueError(f"{S} states do not split into {size} equal "
                             "blocks")
        b = S // size
        sl = slice(_rank(group) * b, (_rank(group) + 1) * b)
        for p in params:
            p.grad = None
        _, (losses, gs, finals, overflow) = loss_fn(
            list(states)[sl], cell_lens[sl], kTs[sl], targets[sl],
            rhos[sl])
        all_reduce_grads(params, group)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        with torch.no_grad():
            losses, gs = gather(losses), gather(gs)
            overflow = gather(torch.tensor(overflow,
                                           device=losses.device)).tolist()
            if group is not None:
                cols = {k: gather(torch.stack([getattr(f, k) for f in
                                               finals]))
                        for k in finals[0]._fields
                        if torch.is_tensor(getattr(finals[0], k))}
                finals = [finals[0]._replace(**{k: v[j] for k, v in
                                                cols.items()})
                          for j in range(S)]
        return losses.sum(), (losses, gs, finals, overflow)

    return train_step
