"""Fixed-grid epoch integration with the replay and reverse-time adjoints.

Port of ``mdgrad_tpu/md/adjoint.py`` (``make_odeint``: its stored-state
replay and, with ``reverse_step_fn``, its reverse-time reconstruction).

``odeint(params, state0, aux0, ctrl) -> (traj, final_aux)`` runs
``n_steps`` steps; ``traj`` stacks the ``n_steps + 1`` states field by
field (frame 0 is ``state0``).  ``params`` are the trainable tensors that
``step_fn`` reads (the potential's ``nn.Parameter``s); gradients reach
them, ``state0`` (its cached force included) and the tensors of ``ctrl``,
never ``aux``.  A ``ctrl`` entry that is not a tensor (Langevin's host
integer ``noise_step0``) is passed to every step as it is.

* ``adjoint=True``: a ``torch.autograd.Function``.  Its forward runs under
  no grad and stores each step's pre-step state -- after the wrap, exactly
  what the step consumed -- and the aux it used: O(T x state), no
  activations.  Its backward walks the steps in reverse, re-runs each step
  at its stored state with forces at ``create_graph=True`` and takes the
  vector-Jacobian product with respect to (params, state, ctrl), the
  running adjoint plus that frame's trajectory cotangent as
  ``grad_outputs``.  Because the stored state is the one the forward
  consumed, the gradients equal direct backprop to roundoff.
* ``adjoint=False``: plain autograd through the step loop, forces at
  ``create_graph=True``; it keeps every step's graph.

* ``reverse_step_fn`` with ``adjoint`` set: the O(1)-memory adjoint.  The
  forward keeps the endpoints only (``traj`` has 2 frames, ``state0`` and
  the last state); the backward re-integrates from the last state with
  ``reverse_step_fn`` (the stepper at -dt, time reversibility), wraps and
  refreshes the topology at each reconstructed state, and takes each
  step's vector-Jacobian product there.  Reconstruction drifts at the
  rate of float roundoff, so its gradients equal the replay's only to
  that; ``update_freq`` must be 1.

With grad disabled, or nothing requiring grad, both run the bare loop and
store nothing: that is the sampling path.
"""

import torch
from torch.autograd.function import once_differentiable


def _tensor_fields(state):
    return [k for k in state._fields if torch.is_tensor(getattr(state, k))]


def _stack(frames):
    first = frames[0]
    return first._replace(**{k: torch.stack([getattr(s, k) for s in frames])
                             for k in _tensor_fields(first)})


class _Epoch:
    """One epoch's loop, shared by the sampling, direct and replay paths."""

    def __init__(self, step_fn, aux_update_fn, n_steps, update_freq,
                 skip_first_refresh, wrap_fn, reverse_step_fn=None):
        self.step_fn = step_fn
        self.aux_update_fn = aux_update_fn
        self.n_steps = n_steps
        self.update_freq = update_freq
        self.skip_first_refresh = skip_first_refresh
        self.wrap_fn = wrap_fn
        self.reverse_step_fn = reverse_step_fn

    def _refreshes(self, i):
        # with update_freq == 1 the step-0 rebuild is kept: it is the
        # same deterministic build, as in the JAX package
        if self.update_freq == 1:
            return True
        return i % self.update_freq == 0 and not (
            self.skip_first_refresh and i == 0)

    def advance(self, i, state, aux):
        """The wrap and refresh before step ``i``: the wrap goes with the
        refresh, so the table is built from the representative the step
        consumes."""
        if self._refreshes(i):
            if self.wrap_fn is not None:
                state = self.wrap_fn(state, aux)
            aux = self.aux_update_fn(state, aux)
        return state, aux

    def run(self, state, aux, ctrl, create_graph, stored=None,
            endpoints=False):
        """(traj, final aux); appends each step's (state, aux) to
        ``stored`` when given.  ``endpoints``: traj holds only the first
        and the last state."""
        frames = [state]
        for i in range(self.n_steps):
            state, aux = self.advance(i, state, aux)
            if stored is not None:
                stored.append((state, aux))
            state = self.step_fn(state, aux, ctrl, i, create_graph)
            if not endpoints:
                frames.append(state)
        if endpoints:
            frames.append(state)
        return _stack(frames), aux


class _Replay(torch.autograd.Function):
    """Inputs: (job, *params, *state0 tensors, *ctrl tensors); outputs:
    the stacked trajectory fields.  ``job`` carries the epoch, the input
    layout and, after the forward, the stored states and the final aux."""

    @staticmethod
    def forward(ctx, job, *inputs):
        params, s0, c0 = job.split(inputs)
        stored = []
        traj, job.final_aux = job.epoch.run(
            job.state(job.state0, s0), job.aux0, job.ctrl(c0),
            create_graph=False, stored=stored)
        ctx.job, ctx.stored, ctx.params, ctx.ctrl = job, stored, params, c0
        return tuple(getattr(traj, k) for k in job.fields)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cts):
        job, params = ctx.job, ctx.params
        adj = [ct[-1] for ct in cts]
        d_params = [None] * len(params)
        d_ctrl = [None] * len(ctx.ctrl)
        for i in range(len(ctx.stored) - 1, -1, -1):
            state_i, aux_i = ctx.stored[i]
            with torch.enable_grad():
                s = [getattr(state_i, k).detach().requires_grad_()
                     for k in job.fields]
                c = [t.detach().requires_grad_(t.is_floating_point())
                     for t in ctx.ctrl]
                out = job.epoch.step_fn(job.state(state_i, s), aux_i,
                                        job.ctrl(c), i, True)
                wrt = [*params, *s, *(t for t in c if t.requires_grad)]
                grads = torch.autograd.grad(
                    [getattr(out, k) for k in job.fields], wrt,
                    grad_outputs=adj, allow_unused=True)
            n_p, n_s = len(params), len(s)
            d_params = [_add(a, g) for a, g in zip(d_params, grads[:n_p])]
            d_s = grads[n_p:n_p + n_s]
            d_c = iter(grads[n_p + n_s:])
            d_ctrl = [_add(a, next(d_c)) if t.requires_grad else a
                      for a, t in zip(d_ctrl, c)]
            adj = [ct[i] if g is None else g + ct[i]
                   for g, ct in zip(d_s, cts)]
        need = ctx.needs_input_grad[1 + len(params):]
        return (None, *d_params, *(g if n else None for g, n in zip(
            [*adj, *d_ctrl], need)))


class _Reverse(torch.autograd.Function):
    """The reverse-time adjoint: inputs and outputs as :class:`_Replay`'s,
    the outputs two frames deep; nothing stored but the last state."""

    @staticmethod
    def forward(ctx, job, *inputs):
        params, s0, c0 = job.split(inputs)
        traj, job.final_aux = job.epoch.run(
            job.state(job.state0, s0), job.aux0, job.ctrl(c0),
            create_graph=False, endpoints=True)
        ctx.job, ctx.params, ctx.ctrl = job, params, c0
        ctx.final = traj._replace(**{k: getattr(traj, k)[-1]
                                     for k in job.fields})
        return tuple(getattr(traj, k) for k in job.fields)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cts):
        job, params, epoch = ctx.job, ctx.params, ctx.job.epoch
        ctrl = job.ctrl(ctx.ctrl)
        adj = [ct[-1] for ct in cts]
        d_params = [None] * len(params)
        d_ctrl = [None] * len(ctx.ctrl)
        cur, aux = ctx.final, job.aux0
        for i in range(epoch.n_steps - 1, -1, -1):
            # undo step i from the current state, its topology refreshed
            # there (every step: update_freq is 1); the wrap's lattice
            # shift leaves the potential alone
            with torch.no_grad():
                cur, aux = epoch.advance(i, cur, aux)
                s_i = epoch.reverse_step_fn(cur, aux, ctrl, i)
                state_i, aux_i = epoch.advance(i, s_i, aux)
            with torch.enable_grad():
                s = [getattr(state_i, k).detach().requires_grad_()
                     for k in job.fields]
                c = [t.detach().requires_grad_(t.is_floating_point())
                     for t in ctx.ctrl]
                out = epoch.step_fn(job.state(state_i, s), aux_i,
                                    job.ctrl(c), i, True)
                wrt = [*params, *s, *(t for t in c if t.requires_grad)]
                grads = torch.autograd.grad(
                    [getattr(out, k) for k in job.fields], wrt,
                    grad_outputs=adj, allow_unused=True)
            n_p, n_s = len(params), len(s)
            d_params = [_add(a, g) for a, g in zip(d_params, grads[:n_p])]
            d_c = iter(grads[n_p + n_s:])
            d_ctrl = [_add(a, next(d_c)) if t.requires_grad else a
                      for a, t in zip(d_ctrl, c)]
            adj = [torch.zeros_like(t) if g is None else g
                   for g, t in zip(grads[n_p:n_p + n_s], s)]
            cur, aux = state_i, aux_i
        adj = [a + ct[0] for a, ct in zip(adj, cts)]
        need = ctx.needs_input_grad[1 + len(params):]
        return (None, *d_params, *(g if n else None for g, n in zip(
            [*adj, *d_ctrl], need)))


def _add(acc, g):
    if g is None:
        return acc
    return g if acc is None else acc + g


class _Job:
    """The flattened inputs of one replayed epoch."""

    def __init__(self, epoch, state0, aux0, ctrl, n_params):
        self.epoch = epoch
        self.state0 = state0
        self.aux0 = aux0
        self.fields = _tensor_fields(state0)
        self.ctrl_keys = [k for k, v in ctrl.items() if torch.is_tensor(v)]
        self.ctrl_static = {k: v for k, v in ctrl.items()
                            if not torch.is_tensor(v)}
        self.n_params = n_params
        self.final_aux = None

    def split(self, inputs):
        n_p, n_s = self.n_params, len(self.fields)
        return (inputs[:n_p], inputs[n_p:n_p + n_s], inputs[n_p + n_s:])

    def state(self, template, tensors):
        return template._replace(**dict(zip(self.fields, tensors)))

    def ctrl(self, tensors):
        return {**self.ctrl_static, **dict(zip(self.ctrl_keys, tensors))}


def make_odeint(step_fn, aux_update_fn, n_steps, update_freq=1,
                adjoint=True, skip_first_refresh=False, wrap_fn=None,
                reverse_step_fn=None):
    """Build ``odeint(params, state0, aux0, ctrl) -> (traj, final_aux)``.

    step_fn:       (state, aux, ctrl, i, create_graph) -> state, one step;
                   ``create_graph`` is passed on to the force.
    aux_update_fn: (state, aux) -> aux, the topology refresh (not
                   differentiated).
    n_steps:       step count; traj has n_steps + 1 frames.
    update_freq:   refresh aux every k-th step.
    adjoint:       True -> the replay adjoint; False -> direct autograd.
    skip_first_refresh: the caller refreshed ``aux0`` at ``state0``; with
                   update_freq > 1 the step-0 rebuild is skipped.
    wrap_fn:       optional gradient-safe ``(state, aux) -> state``
                   periodic wrap, applied right before each refresh with
                   the aux it replaces (a dynamic-cell model reads its
                   cell there).
    reverse_step_fn: optional ``(state, aux, ctrl, i) -> state`` undoing
                   step i (the stepper at -dt); with ``adjoint`` it selects
                   the reverse-time adjoint, whose traj holds the first
                   and the last state only.  Needs ``update_freq == 1``.
    """
    reverse = reverse_step_fn is not None and adjoint
    if reverse and update_freq != 1:
        raise ValueError("reverse-time adjoint requires "
                         "topology_update_freq == 1")
    epoch = _Epoch(step_fn, aux_update_fn, n_steps, update_freq,
                   skip_first_refresh, wrap_fn, reverse_step_fn)

    def odeint(params, state0, aux0, ctrl):
        params = list(params)
        leaves = [*params, *(getattr(state0, k)
                             for k in _tensor_fields(state0)),
                  *(v for v in ctrl.values() if torch.is_tensor(v))]
        differentiable = torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves)
        if not differentiable:
            return epoch.run(state0, aux0, ctrl, create_graph=False,
                             endpoints=reverse)
        if not adjoint:
            return epoch.run(state0, aux0, ctrl, create_graph=True)
        job = _Job(epoch, state0, aux0, ctrl, len(params))
        fields = (_Reverse if reverse else _Replay).apply(job, *leaves)
        return job.state(state0, fields), job.final_aux

    return odeint
