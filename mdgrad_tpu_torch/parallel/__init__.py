"""Multi-state-point fitting of the port (one device; the mesh and
``torch.distributed`` are ROADMAP Queue 1, Slice H1)."""

from .multistate import (MultiStateConfig, make_multistate_fit,
                         make_multistate_train_step,
                         make_stack_multistate_fit)

__all__ = ["MultiStateConfig", "make_multistate_fit",
           "make_multistate_train_step", "make_stack_multistate_fit"]
