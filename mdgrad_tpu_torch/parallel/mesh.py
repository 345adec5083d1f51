"""Device meshes and the collectives that autograd differentiates.

Port of ``mdgrad_tpu/parallel/mesh.py``.  The JAX package lays replicas
('dp') and atoms ('sp') over a ``jax.sharding.Mesh`` and lets XLA insert
and transpose the collectives.  Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group (gloo on the CPU, NCCL on the card), and the collectives that sit
on an autograd graph are written out, each beside its adjoint:

* :func:`all_gather_rows` -- this rank's row block to the full rows,
  every rank the same; backward sums the full cotangent over the group
  and keeps this rank's block (the XLA transpose of ``all_gather`` is a
  reduce-scatter).
* :func:`sum_replicated` -- all-reduce forward, identity backward: a
  quantity each rank holds a part of (an energy over its rows, RDF
  counts, a kinetic energy) becomes one value every rank holds.
* :func:`replicate` -- identity forward, all-reduce backward: a value
  every rank holds (positions, thermostat momenta) enters computation
  that differs between ranks, so its cotangent is the sum of theirs.

A replicated tensor's cotangent is the whole cotangent, the same on
every rank; a sharded tensor's is this rank's.  Each Function's backward
calls the other Function of its pair, so the cotangents stay right under
grad of grad (a fit differentiates through forces).  A parameter used
only in sharded computation gets a part of its gradient on each rank:
:func:`all_reduce_grads` sums them once after the backward.  Every rank
must run the same collectives in the same order: flags that decide host
control flow are ORed over the group first (:func:`or_over`).
"""

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device


def make_mesh(axes, device_type=None):
    """DeviceMesh from an {axis_name: size} dict over the default process
    group, e.g. {'dp': 2, 'sp': 4}.

    Sizes must multiply to the world size; pass -1 for one axis to infer
    it.  ``device_type`` defaults to ``'cuda'`` (no card raises); pass
    ``'cpu'`` for gloo.  A CUDA mesh puts rank r on card r mod the card
    count.
    """
    from torch.distributed.device_mesh import DeviceMesh
    device_type = resolve_device(device_type or "cuda").type
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's default "
                           "process group: call init_process_group first")
    world = dist.get_world_size()
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    total = int(np.prod(sizes))
    if total != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {world}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(world).reshape(sizes),
                      mesh_dim_names=tuple(names))


def axis_group(mesh, axis):
    """The process group of ``mesh``'s ``axis``, or None (every
    collective a no-op) when the mesh is None or lacks the axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def _size(group):
    return 1 if group is None else dist.get_world_size(group)


def _rank(group):
    return 0 if group is None else dist.get_rank(group)


# A group of one rank still runs its collectives (an NCCL world of one
# on a single card exercises the same calls as a larger one); only
# ``group=None`` skips them.

def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather(x, group):
    if group is None:
        return x.clone()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _ReduceRows.apply(ct, ctx.group, ctx.rows), None, None


class _ReduceRows(torch.autograd.Function):
    """Sum over the group, then this rank's block of ``rows`` rows: the
    adjoint of :class:`_AllGatherRows`."""

    @staticmethod
    def forward(ctx, x, group, rows):
        ctx.group = group
        k = _rank(group)
        return _all_reduce(x, group)[k * rows:(k + 1) * rows]

    @staticmethod
    def backward(ctx, ct):
        return _AllGatherRows.apply(ct, ctx.group), None, None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _Replicate.apply(ct, ctx.group), None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, ct):
        return _SumReplicated.apply(ct, ctx.group), None


def all_gather_rows(x, group):
    """Every rank's (rows, ...) block of ``x``, concatenated in rank order
    (equal blocks); differentiable (see the module docstring)."""
    return _AllGatherRows.apply(x, group)


def sum_replicated(x, group):
    """The sum of ``x`` over ``group``, held by every rank; its backward
    hands each rank the cotangent as it is."""
    return _SumReplicated.apply(x, group)


def replicate(x, group):
    """``x`` (the same on every rank) as it enters rank-dependent
    computation; its backward sums the ranks' cotangents."""
    return _Replicate.apply(x, group)


def all_reduce_grads(params, group):
    """Sum each parameter's ``.grad`` over ``group`` in place (one
    collective a parameter); parameters without a gradient are
    skipped."""
    if group is None:
        return
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)


def or_over(flags, group):
    """Bool tensors (a tuple of 0-d flags) ORed over ``group`` in one
    collective, every rank the same answer; None entries stay None."""
    if group is None:
        return flags
    real = [f for f in flags if f is not None]
    if not real:
        return flags
    x = torch.stack([f.reshape(()) for f in real]).to(torch.int32)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    ored = iter(x.bool().unbind())
    return tuple(None if f is None else next(ored).reshape(f.shape)
                 for f in flags)
