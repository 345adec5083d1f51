"""Multi-replica, atom-sharded MD: the scaling path of the pair fits.

Port of ``mdgrad_tpu/parallel/replica.py``.  R replicas of an N-atom
system run over a dp x sp mesh (``parallel/mesh.make_mesh``):

    dp (replicas):  each dp group holds R / dp replicas; the loss is
                    summed over dp
    sp (atoms):     each rank of an sp group holds N / sp atoms of its
                    group's replicas; positions are all-gathered once an
                    energy, each rank evaluates its row block of the i < j
                    pair sum, and energies and RDF counts are summed over
                    sp

The JAX package writes the per-rank program once (``shard_map``) and
lets XLA transpose its collectives; here they are the differentiable
collectives of ``parallel/mesh.py``, and the Nose-Hoover chain is this
module's own (not the library integrator), with the kinetic energy
summed over sp.  A fit step is differentiated directly through its
``n_steps`` steps (the JAX ``lax.scan``), forces taken with
``create_graph``; each rank's parameter gradient holds its part, and the
step sums them over the whole mesh before the SGD update.
"""

import typing

import numpy as np
import torch

from .. import topology
from ..md.integrators import NVTState
from ..observables import generate_vol_bins
from .mesh import (all_gather_rows, all_reduce_grads, axis_group, _rank,
                   _size, replicate, sum_replicated)


def _row_block(xyz_local, cell, cutoff, group):
    """(all-gathered positions, this block's (N/sp, N) distance squares
    and the i < j, within-``cutoff`` mask of its rows)."""
    blk = xyz_local.shape[0]
    xyz_full = all_gather_rows(xyz_local, group)
    n = xyz_full.shape[0]
    disp, _ = topology.min_image(xyz_full[None, :, :] - xyz_local[:, None, :],
                                 cell)
    dist_sq = (disp ** 2).sum(-1)
    row_ids = _rank(group) * blk + torch.arange(blk, device=xyz_local.device)
    col_ids = torch.arange(n, device=xyz_local.device)
    mask = (col_ids[None, :] > row_ids[:, None]) & (dist_sq < cutoff ** 2)
    return dist_sq, mask


def _local_pair_energy(pair_model, xyz_local, cell, cutoff, group):
    """This rank's row block of the masked pair sum (no sum over sp)."""
    dist_sq, mask = _row_block(xyz_local, cell, cutoff, group)
    safe = torch.sqrt(torch.where(mask, dist_sq, torch.ones_like(dist_sq)))
    u = pair_model(safe[..., None]).squeeze(-1)
    return torch.where(mask, u, torch.zeros_like(u)).sum()


def spatial_pair_energy(pair_model, xyz_local, cell, cutoff, group=None):
    """Pair energy of one replica with its atoms sharded over ``group``
    (an sp process group; None: one rank).

    ``xyz_local``: (N/sp, 3) this rank's atom block; ``pair_model`` maps
    distances (..., 1) to energies (..., 1).  All-gathers the positions,
    evaluates this block's rows of the masked minimum-image i < j pair
    sum and sums the scalar over the group: every rank holds the total,
    and its gradient in ``xyz_local`` is the full dE/dq of the block.
    """
    cell = torch.as_tensor(cell, dtype=xyz_local.dtype,
                           device=xyz_local.device)
    return sum_replicated(
        _local_pair_energy(pair_model, xyz_local, cell, cutoff, group),
        group)


def _soft_rdf_counts(xyz_local, cell, smear_offsets, smear_widths, cutoff,
                     group=None):
    """Soft-histogram RDF counts of one replica, atoms sharded over
    ``group``: Gaussians at ``smear_offsets`` over this block's i < j
    pairs within ``cutoff``, summed over the group."""
    dist_sq, mask = _row_block(xyz_local, cell, cutoff, group)
    dist = torch.sqrt(torch.where(mask, dist_sq, torch.ones_like(dist_sq)))
    g = torch.exp(-0.5 * ((dist[..., None] - smear_offsets)
                          / smear_widths) ** 2)
    return sum_replicated((g * mask[..., None]).sum((0, 1)), group)


class ShardedMDConfig(typing.NamedTuple):
    cell: typing.Any
    cutoff: float
    masses: typing.Any            # (N,): each rank takes its sp block
    dt: float
    n_steps: int
    kT: float
    Q: typing.Any                 # NHC bath masses (C,)
    n_dof: int


def _block(x, group, axis=0):
    """This rank's equal block of ``x`` along ``axis``."""
    k, size = _rank(group), _size(group)
    n = x.shape[axis]
    if n % size:
        raise ValueError(f"axis of {n} does not split into {size} equal "
                         "blocks")
    b = n // size
    return x.narrow(axis, k * b, b)


def _gather(x, group, axis=0):
    """The blocks of ``x`` along ``axis`` from every rank (no gradient)."""
    with torch.no_grad():
        return all_gather_rows(x.detach().movedim(axis, 0).contiguous(),
                               group).movedim(0, axis)


def make_sharded_epoch(pair_model, cfg, mesh, rdf_range=None, nbins=64):
    """Build the dp x sp sharded epoch and its RDF-loss objective.

    Returns ``(epoch_fn, loss_fn)``:

      epoch_fn(states, masses_local, g_target, kT) -> (loss, finals)
          the per-rank program: ``states`` an ``NVTState`` of this rank's
          blocks (v, q (R/dp, N/sp, 3), pv (R/dp, C)), ``masses_local``
          (N/sp,); one NHC epoch per replica, then the mean squared
          deviation of each replica's soft g(r) of its last frame from
          ``g_target``, summed over the replicas and over dp.
      loss_fn(states, masses, g_target, kT=None) -> (loss, finals)
          the same from the whole arrays (v, q (R, N, 3), pv (R, C),
          masses (N,), the same on every rank): each rank takes its
          blocks; ``finals`` are gathered back to (R, N, 3) / (R, C),
          detached.

    ``loss`` is held by every rank and is differentiable in
    ``pair_model``'s parameters (each rank's gradient a part: sum them
    over the mesh, as :func:`make_sharded_fit_step` does).  ``mesh`` may
    lack either axis (None: one rank).
    """
    sp, dp = axis_group(mesh, "sp"), axis_group(mesh, "dp")
    start, end = rdf_range or (0.5, cfg.cutoff)
    V, vol_bins, _ = generate_vol_bins(start, end, nbins, dim=3)

    def consts(like):
        kw = {"dtype": like.dtype, "device": like.device}
        offsets = torch.linspace(start, end, nbins, **kw)
        widths = torch.full((nbins,), (offsets[1] - offsets[0]).item(), **kw)
        return (torch.as_tensor(np.asarray(cfg.cell), **kw), offsets, widths,
                torch.as_tensor(vol_bins, **kw),
                torch.as_tensor(cfg.Q, **kw))

    def epoch_fn(states, masses_local, g_target, kT):
        cell, offsets, widths, vol, Q = consts(states.q)
        m = torch.as_tensor(masses_local).to(states.q)[:, None]
        kT = torch.as_tensor(kT).to(states.q)
        create_graph = torch.is_grad_enabled()

        def force(q):
            with torch.enable_grad():
                q = q if q.requires_grad else q.detach().requires_grad_(True)
                e = _local_pair_energy(pair_model, q, cell, cfg.cutoff, sp)
                (g,) = torch.autograd.grad(e, q, create_graph=create_graph)
            return -g

        def derivs(v, q, pv):
            # the per-replica chain with the atoms sharded: the kinetic
            # energy summed over sp, the bath momenta the same on every
            # rank of the group
            p = v * m
            sys_ke = sum_replicated(0.5 * (p ** 2 / m).sum(), sp)
            pv_loc = replicate(pv, sp)
            dvdt = (force(q) - pv_loc[0] * p / Q[0]) / m
            dpv0 = (2 * (sys_ke - kT * cfg.n_dof * 0.5)
                    - pv[0] * pv[1] / Q[1])
            dpv_mid = (pv[:-2] ** 2 / Q[:-2] - kT) - pv[2:] * pv[1:-1] / Q[2:]
            dpv_last = pv[-2] ** 2 / Q[-2] - kT
            return dvdt, v, torch.cat([dpv0[None], dpv_mid, dpv_last[None]])

        def step(v, q, pv):
            dv, dq, dpv = derivs(v, q, pv)
            hv, hq, hpv = (v + 0.5 * cfg.dt * dv, q + 0.5 * cfg.dt * dq,
                           pv + 0.5 * cfg.dt * dpv)
            q_new = q + hv * cfg.dt
            dv, _, dpv = derivs(hv, q_new, hpv)
            return hv + 0.5 * cfg.dt * dv, q_new, hpv + 0.5 * cfg.dt * dpv

        finals, loss_local = [], 0.0
        for v, q, pv in zip(states.v, states.q, states.pv):
            for _ in range(cfg.n_steps):
                v, q, pv = step(v, q, pv)
            finals.append(NVTState(v=v, q=q, pv=pv))
            counts = _soft_rdf_counts(q, cell, offsets, widths, end + 0.5,
                                      sp)
            counts = counts / counts.sum()
            g = counts / (vol / V)
            loss_local = loss_local + ((g - g_target) ** 2).mean()
        loss = sum_replicated(torch.as_tensor(loss_local).to(states.q), dp)
        return loss, NVTState(*(torch.stack(x) for x in zip(*finals)))

    def loss_fn(states, masses, g_target, kT=None):
        like = states.q
        g_t = torch.as_tensor(g_target).to(like)
        local = NVTState(v=_block(_block(states.v, dp), sp, 1),
                         q=_block(_block(states.q, dp), sp, 1),
                         pv=_block(states.pv, dp))
        m = _block(torch.as_tensor(masses).to(like), sp)
        loss, finals = epoch_fn(local, m, g_t, cfg.kT if kT is None else kT)
        return loss, NVTState(v=_gather(_gather(finals.v, sp, 1), dp),
                              q=_gather(_gather(finals.q, sp, 1), dp),
                              pv=_gather(finals.pv, dp))

    return epoch_fn, loss_fn


def make_sharded_fit_step(pair_model, cfg, mesh, g_target, rdf_range=None,
                          nbins=64, lr=1e-3):
    """One dp x sp-sharded training step: the epoch's RDF loss, its
    gradient in ``pair_model``'s parameters (summed over the mesh) and an
    SGD update of ``lr``, in place.  Returns ``train_step(states, masses)
    -> (loss, finals)`` (whole arrays in and out, as ``loss_fn``'s; the
    loss detached)."""
    _, loss_fn = make_sharded_epoch(pair_model, cfg, mesh, rdf_range, nbins)
    params = [p for p in pair_model.parameters() if p.requires_grad]
    world = None if mesh is None else torch.distributed.group.WORLD

    def train_step(states, masses):
        for p in params:
            p.grad = None
        loss, finals = loss_fn(states, masses, g_target)
        loss.backward()
        all_reduce_grads(params, world)
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p -= lr * p.grad
        return loss.detach(), finals

    return train_step
