"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

Every wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors.  ``launches`` counts kernel
launches by name and ``plain_calls`` counts plain-version calls, so a run
can show which path it took; ``launches_bf16`` and ``plain_calls_bf16``
count the gather kernels' bf16 instantiations (``split=False``) apart.
"""

from . import gather, pair, rdf
from .pair import PallasLJPair, lj_energy_forces

__all__ = ["PallasLJPair", "counts", "lj_energy_forces", "reset_counts"]

_MODULES = (gather, rdf, pair)


def counts():
    """{'launches': {...}, 'plain_calls': {...}} over every kernel, and
    'launches_bf16', 'plain_calls_bf16' over the gather kernels' bf16
    instantiations."""
    return {"launches": {k: v for m in _MODULES
                         for k, v in m.launches.items()},
            "plain_calls": {k: v for m in _MODULES
                            for k, v in m.plain_calls.items()},
            "launches_bf16": dict(gather.launches_bf16),
            "plain_calls_bf16": dict(gather.plain_calls_bf16)}


def reset_counts():
    for d in (*(c for m in _MODULES for c in (m.launches, m.plain_calls)),
              gather.launches_bf16, gather.plain_calls_bf16):
        for k in d:
            d[k] = 0
