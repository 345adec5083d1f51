"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

Every wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors.  ``launches`` counts kernel
launches by name and ``plain_calls`` counts plain-version calls, so a run
can show which path it took.
"""

from . import gather, rdf


def counts():
    """{'launches': {...}, 'plain_calls': {...}} over every kernel."""
    return {"launches": {**gather.launches, **rdf.launches},
            "plain_calls": {**gather.plain_calls, **rdf.plain_calls}}


def reset_counts():
    for d in (gather.launches, gather.plain_calls, rdf.launches,
              rdf.plain_calls):
        for k in d:
            d[k] = 0
