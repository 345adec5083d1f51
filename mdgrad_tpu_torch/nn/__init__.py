"""Neural-network force fields of the port."""

from .schnet import SchNet

__all__ = ["SchNet"]
