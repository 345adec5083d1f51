"""Inputs and timers of the gather kernels K1, K2a and K2b.

The edge cases the kernels special-case (:func:`gather_index` over
``GATHER_F`` x ``GATHER_K`` x ``GATHER_LAYOUTS``), held against the plain
versions by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``; the bytes
each kernel must move (:func:`bound_bytes`); and warm and cold device
times (:func:`warm_cold`) on ``N_SETS`` sets of inputs and outputs at the
index's shape, every kernel called through its C entry point.  The warm
reading replays one set (the inputs stay in the L2, as on the MD path);
the cold one cycles through all the sets, more bytes than the 50 MB L2
holds (:mod:`.timing`).
"""

import numpy as np
import torch

from . import _build, timing

N_SETS = 12    # x ~8-11 MB a set at the water shape: more than the L2
KERNELS = ("gather_mul_reduce", "table_gather", "table_scatter")
GATHER_F = (1, 3, 40, 128, 130)   # F % 4 != 0: scalar; F > 128: two passes
GATHER_K = (1, 12, 40)            # 1, 3 and 10 warps a row in K1
GATHER_LAYOUTS = ("suffix", "interleaved", "negative", "whole_rows")


def gather_index(rng, layout, n, n_out, k):
    """(n_out * k,) int32 index of an atom-major (n_out, k) table over n
    rows, its sentinels laid out as in ``layout``: each row's real entries
    first (the water table's order, some rows all sentinel), scattered
    (30% == n), scattered below 0 and above n, or every third row."""
    idx = rng.integers(0, n, size=(n_out, k))
    if layout == "suffix":
        real = rng.integers(0, k + 1, size=n_out)
        idx[np.arange(k) >= real[:, None]] = n
    elif layout == "interleaved":
        idx[rng.random(idx.shape) < 0.3] = n
    elif layout == "negative":
        hole = rng.random(idx.shape) < 0.3
        idx[hole] = rng.choice([-1, -7, n + 3], size=int(hole.sum()))
    else:
        idx[::3] = n
    return idx.reshape(-1).astype(np.int32)


def bound_bytes(n, f, n_edges, n_real):
    """Bytes each kernel must move: every input read once, every output
    written once.  K1 and K2b read w and g only at the real edges (they
    never load a sentinel row); K2a writes every slot."""
    return {
        "gather_mul_reduce": 4 * (n * f + n_real * f + n_edges + n * f),
        "table_gather": 4 * (n * f + n_edges + n_edges * f),
        "table_scatter": 4 * (n_real * f + n_real + (n + 1) + n * f),
    }


def make_sets(index, k, n_sets, gen, f):
    """``n_sets`` independent input and output sets at the index's shape:
    values (n, f), w and g (E, f), the index and its CSR, and the three
    outputs."""
    order, rowptr = index.csr()
    n, e = index.n, index.idx.shape[0]
    dev = index.idx.device
    sets = []
    for _ in range(n_sets):
        sets.append({
            "values": torch.randn(n, f, device=dev, generator=gen),
            "w": torch.randn(e, f, device=dev, generator=gen),
            "g": torch.randn(e, f, device=dev, generator=gen),
            "idx": index.idx.clone(), "order": order.clone(),
            "rowptr": rowptr.clone(),
            "gather_mul_reduce": torch.empty(e // k, f, device=dev),
            "table_gather": torch.empty(e, f, device=dev),
            "table_scatter": torch.empty(n, f, device=dev),
        })
    return sets


def kernel_calls(lib, s, k):
    """{kernel: fn} launching ``lib``'s entry points on set ``s`` into its
    own outputs (no allocation, no launch count)."""
    n, f = s["values"].shape
    e = s["idx"].shape[0]
    p = {name: t.data_ptr() for name, t in s.items()}

    def stream():   # the current one: a graph captures on its own
        return _build.stream_of(s["values"])

    def k1():
        _build.check(lib.mdg_gather_mul_reduce(
            p["values"], p["w"], p["idx"], p["gather_mul_reduce"], n, e // k,
            k, f, stream()), "gather_mul_reduce")

    def k2a():
        _build.check(lib.mdg_table_gather(
            p["values"], p["idx"], p["table_gather"], n, e, f, stream()),
            "table_gather")

    def k2b():
        _build.check(lib.mdg_table_scatter(
            p["g"], p["order"], p["rowptr"], p["table_scatter"], n, f,
            stream()), "table_scatter")

    return dict(zip(KERNELS, (k1, k2a, k2b)))


def warm_cold(lib, sets, k):
    """{kernel: {"ms": warm, "cold_ms": cold}} on the card, and under
    "launch_floor" the warm time of K1 and K2a on the first output row
    alone (one block each): what a launch costs before it moves bytes."""
    calls = [kernel_calls(lib, s, k) for s in sets]
    out = {name: {"ms": timing.time_graph(calls[0][name]),
                  "cold_ms": timing.time_cold([c[name] for c in calls])}
           for name in KERNELS}
    one_row = kernel_calls(lib, dict(sets[0], idx=sets[0]["idx"][:k]), k)
    out["launch_floor"] = {name: timing.time_graph(one_row[name])
                           for name in KERNELS[:2]}
    return out
