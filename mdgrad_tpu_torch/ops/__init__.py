"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

Every wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors.  ``launches`` counts kernel
launches by name and ``plain_calls`` counts plain-version calls, so a run
can show which path it took.
"""

from . import gather, pair, rdf
from .pair import PallasLJPair, lj_energy_forces

__all__ = ["PallasLJPair", "counts", "lj_energy_forces", "reset_counts"]

_MODULES = (gather, rdf, pair)


def counts():
    """{'launches': {...}, 'plain_calls': {...}} over every kernel."""
    return {"launches": {k: v for m in _MODULES
                         for k, v in m.launches.items()},
            "plain_calls": {k: v for m in _MODULES
                            for k, v in m.plain_calls.items()}}


def reset_counts():
    for m in _MODULES:
        for d in (m.launches, m.plain_calls):
            for k in d:
                d[k] = 0
