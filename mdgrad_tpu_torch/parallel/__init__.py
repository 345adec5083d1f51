"""Distribution and multi-state fitting of the port over
``torch.distributed`` (gloo on the CPU, NCCL on the card).

* ``mesh`` -- :func:`make_mesh` (a ``DeviceMesh`` with named dims 'dp',
  'sp') and the differentiable collectives the sharded paths use.
* ``replica`` -- R replicas of a pair-potential system over dp x sp,
  atoms sharded: the sharded epoch and its SGD fit step.
* ``spatial_gnn`` -- :class:`ShardedGNNPotentials`, a SchNet energy
  computed row-sharded over sp inside the ordinary epoch.
* ``multistate`` -- several state points in one loss, their train step
  optionally split over a dp group.
* ``dryrun`` -- :func:`dryrun_multichip`, one sharded fit step on n ranks.
"""

from .mesh import make_mesh
from .multistate import (MultiStateConfig, make_multistate_fit,
                         make_multistate_train_step,
                         make_stack_multistate_fit,
                         make_stack_multistate_train_step)
from .replica import (ShardedMDConfig, make_sharded_epoch,
                      make_sharded_fit_step, spatial_pair_energy)
from .spatial_gnn import ShardedGNNPotentials

__all__ = ["make_mesh", "spatial_pair_energy", "make_sharded_epoch",
           "make_sharded_fit_step", "ShardedMDConfig",
           "ShardedGNNPotentials", "MultiStateConfig",
           "make_multistate_fit", "make_multistate_train_step",
           "make_stack_multistate_fit",
           "make_stack_multistate_train_step"]
