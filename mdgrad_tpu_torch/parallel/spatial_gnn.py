"""Atom-sharded (sp) SchNet MD for one large system.

Port of ``mdgrad_tpu/parallel/spatial_gnn.py``.  The JAX package commits
the state and the (N, K) table's rows to the mesh's 'sp' axis and lets
GSPMD partition the unchanged library epoch.  PyTorch has no GSPMD, so
the partition is written out in :class:`ShardedGNNPotentials`, which
stands in for a ``GNNPotentials`` in the ordinary ``Simulation.epoch_fn``
(the replay adjoint included):

* The integrator's state stays replicated: every rank holds all N
  positions, velocities and forces, and takes the same steps.
* The neighbor table is refreshed on every rank from the replicated
  positions (the same table everywhere); each rank owns the rows
  ``[k N/sp, (k + 1) N/sp)`` and computes those atoms' SchNet energy: its
  rows' edges and filters, and their atoms' embeddings and updates.  The
  arithmetic is the SchNet's own: ``GNNPotentials.energy`` with ``rows``
  (the block) and ``senders`` (the all-gather below).
* Before each convolution's aggregation (K1 on the card) the node
  filter's rows are all-gathered over sp: the sender features, the
  all-gather XLA inserts for the one-hot aggregation.  K1 then sums this
  block's table rows; K2a and K2b (its vjp) and the CSR build run on the
  block's (N/sp K) edges.
* The energy is summed over sp (all-reduce forward, identity backward),
  and the replicated positions enter the row computation through the
  conjugate Function (identity forward, all-reduce backward), so forces
  and the replay's grad of grad come out whole and the same on every
  rank.
* Each rank's parameter gradient holds its rows' part:
  :meth:`ShardedGNNPotentials.reduce_grads` sums them once after the
  backward.  Only the SchNet's own parameters are summed; a replicated
  term beside it in a ``Stack`` (a prior) already has the whole
  gradient on every rank.
* The table's overflow and drift flags are ORed over sp at every
  refresh, so every rank takes the same host decisions.
"""

from ..interface import Interaction
from .mesh import (_rank, _size, all_gather_rows, all_reduce_grads,
                   axis_group, or_over, replicate, sum_replicated)


class ShardedGNNPotentials(Interaction):
    """A ``GNNPotentials`` (table or cells mode, a SchNet) whose energy is
    computed row-sharded over ``mesh``'s ``axis`` (see the module
    docstring).  ``aux_init`` / ``aux_update`` / ``grow_capacity``
    delegate to it; the number of atoms must split into equal blocks."""

    def __init__(self, base, mesh, axis="sp"):
        super().__init__()
        if base.nbr_mode not in ("table", "cells"):
            raise ValueError("ShardedGNNPotentials needs a GNNPotentials "
                             "in nbr_mode 'table' or 'cells'")
        self.base = base
        self.group = axis_group(mesh, axis)
        n, size = int(base.z.shape[0]), _size(self.group)
        if n % size:
            raise ValueError(f"{n} atoms do not split into {size} equal "
                             "row blocks")
        self.rows = n // size

    def _or_flags(self, aux):
        overflow, drift = or_over((aux.overflow, aux.drift), self.group)
        return aux._replace(overflow=overflow, drift=drift)

    def aux_init(self, xyz, cell=None):
        return self._or_flags(self.base.aux_init(xyz, cell))

    def aux_update(self, xyz, aux, cell=None):
        return self._or_flags(self.base.aux_update(xyz, aux, cell))

    def grow_capacity(self, factor=1.5):
        return self.base.grow_capacity(factor)

    def reduce_grads(self):
        """Sum the SchNet parameters' ``.grad`` over the sp group (call
        once after the backward)."""
        all_reduce_grads(self.base.parameters(), self.group)

    def energy(self, xyz, aux, cell=None, aggr_wgt=None):
        """This rank's rows of ``base.energy``, summed over sp; the
        replicated inputs (positions, a cell override, TI's ``aggr_wgt``)
        enter through :func:`replicate`."""
        group = self.group
        lo = _rank(group) * self.rows

        def rep(x):
            return None if x is None else replicate(x, group)

        e_rows = self.base.energy(
            rep(xyz), aux, rep(cell), rep(aggr_wgt),
            rows=slice(lo, lo + self.rows),
            senders=lambda rf: all_gather_rows(rf, group))
        return sum_replicated(e_rows, group)
