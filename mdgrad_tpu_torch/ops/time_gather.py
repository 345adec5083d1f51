"""Inputs and timers of the gather kernels K1, K2a and K2b and of K2b's
CSR build.

The edge cases the kernels special-case (:func:`gather_index` over
``GATHER_F`` x ``GATHER_K`` x ``GATHER_LAYOUTS``, :func:`csr_index_cases`),
held against the plain versions by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``; the bytes
each kernel must move (:func:`bound_bytes`); and warm and cold device
times (:func:`warm_cold`) on ``N_SETS`` sets of inputs and outputs at the
index's shape, every kernel called through its C entry point.  The warm
reading replays one set (the inputs stay in the L2, as on the MD path);
the cold one cycles through all the sets, more bytes than the 50 MB L2
holds (:mod:`.timing`).  The sets take a dtype: float32 for the f32
kernels, bfloat16 for their bf16 instantiations (``split=False``: bf16
in, K1 and K2a bf16 out, K2b f32 out).
"""

import re

import numpy as np
import torch

from . import _build, gather, timing

N_SETS = 12    # x ~8-11 MB a set at the water shape: more than the L2
KERNELS = ("gather_mul_reduce", "table_gather", "table_scatter")
# F % 4 != 0: the scalar path; F > 128: a second pass of K1's warps; 132
# (F % 4 == 0, F % 8 != 0): K1's 4-element lanes (float4, uint2) in two
# passes, K2a's scalar path in bf16
GATHER_F = (1, 3, 40, 128, 130, 132)
GATHER_K = (1, 12, 40)            # 1, 3 and 10 warps a row in K1
GATHER_LAYOUTS = ("suffix", "interleaved", "negative", "whole_rows")
CSR_WATER_K = (16, 40, 48, 56, 72)   # every table width a water path runs
# the CSR grid build's digit and tile (csrc/gather.cu kCsrRadixBits,
# kCsrTile = kCsrThreads x kCsrTileSteps), which the cases straddle
CSR_RADIX_BITS = 8
CSR_GRID_TILE = 4096
# csr_index_cases' tables of the paths that take the grid build: the
# 4096-site cells fit, the a-Si transfer and the 1728-site 'sparse' prior
CSR_GRID_CASES = ("water_4096_k48", "si_4096_k88", "water_1728_k48")


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


def water_table(rng, k, n=512):
    """(n * k,) atom-major table of the water box's shape: each row's real
    neighbours (22-34 of them, ~28 on the lattice) first, the sentinel n
    after; at k = 16 every slot is real (the table a regrow starts from)."""
    idx = rng.integers(0, n, size=(n, k))
    real = rng.integers(22, 35, size=n)
    idx[np.arange(k) >= real[:, None]] = n
    return idx.reshape(-1)


def csr_index_cases():
    """[(name, idx (E,) int32, n)]: the CSR build's edge cases, the water
    shape (512 x 40 slots, ~30% sentinels), the water tables at K = 16, 48,
    56 and 72 (a regrow's start, the fit's width, the skin's and a
    regrow's end), each side of the cluster build's capacity in edges and
    in rows, and the grid build's shapes: the 4096-site water (K = 48, ~42%
    sentinels) and a-Si (K = 88, ~68%) tables, the 1728-site one (K = 48),
    one key holding more than 65536 edges, 48668 rows (``CellLJPair``'s
    atoms) at K = 16, n + 1 keys on each side of a digit's 2^8 and 2^16,
    an E that is no multiple of the grid's tile and one of more than 256
    tiles (blocks owning two), from a numpy seed (shared by
    ``chip_smoke.py`` and ``tests/test_torch_cuda.py``)."""
    rng = np.random.default_rng(3)
    water = rng.integers(0, 512, size=512 * 40)
    water[rng.random(water.size) < 0.3] = 512
    max_e, max_n = gather.CSR_CLUSTER_MAX_EDGES, gather.CSR_CLUSTER_MAX_ROWS
    cases = [
        ("sentinels", rng.integers(-3, 12, size=50), 9),   # < 0, == n, > n
        ("empty_rows", rng.choice([2, 5, 11], size=40), 20),
        ("one_row", np.full(300, 3), 5),   # every edge on one key
        ("all_sentinel", np.full(70, -1), 4),
        ("no_edges", np.zeros(0), 6),
        ("water", water, 512),
        ("water_k16", water_table(rng, 16), 512),
        ("water_k48", water_table(rng, 48), 512),
        ("water_k56", water_table(rng, 56), 512),
        ("water_k72", water_table(rng, 72), 512),
        ("edges_at_capacity", rng.integers(0, 513, size=max_e), 512),
        ("edges_past_capacity", rng.integers(0, 513, size=max_e + 1), 512),
        ("rows_at_capacity", rng.integers(-1, max_n + 2, size=8192), max_n),
        ("rows_past_capacity", rng.integers(-1, max_n + 3, size=8192),
         max_n + 1),
    ]
    one_key = np.full(80000, 5)
    hole = rng.random(one_key.size) < 0.1
    one_key[hole] = rng.integers(-2, 20, size=int(hole.sum()))
    tile = CSR_GRID_TILE
    many_tiles = np.full(257 * tile + 13 * tile + 77, 3000)
    real = rng.random(many_tiles.size) < 0.01
    many_tiles[real] = rng.integers(0, 3000, size=int(real.sum()))
    cases += [
        ("water_4096_k48", water_table(rng, 48, 4096), 4096),
        ("si_4096_k88", water_table(rng, 88, 4096), 4096),
        ("water_1728_k48", water_table(rng, 48, 1728), 1728),
        ("one_key_past_65536", one_key, 16),
        ("cells_48668_k16", water_table(rng, 16, 48668), 48668),
        *((f"keys_{m}", rng.integers(-1, m + 1, size=5000), m - 1)
          for m in (2 ** CSR_RADIX_BITS, 2 ** CSR_RADIX_BITS + 1,
                    2 ** (2 * CSR_RADIX_BITS), 2 ** (2 * CSR_RADIX_BITS) + 1)),
        ("ragged_tail", rng.integers(0, 3001, size=3 * tile + 1234), 3000),
        ("many_tiles", many_tiles, 3000),
    ]
    return [(name, idx.astype(np.int32), n) for name, idx, n in cases]


def bound_bytes(n, f, n_edges, n_real, elem=4):
    """Bytes each kernel must move: every input read once, every output
    written once, ``elem`` bytes a feature (4 for f32, 2 for bf16) and 4
    an index.  K1 and K2b read w and g only at the real edges (they never
    load a sentinel row); K2a writes every slot; K2b writes f32 sums."""
    return {
        "gather_mul_reduce": elem * (n * f + n_real * f + n * f)
        + 4 * n_edges,
        "table_gather": elem * (n * f + n_edges * f) + 4 * n_edges,
        "table_scatter": elem * n_real * f + 4 * (n_real + (n + 1) + n * f),
    }


def make_sets(index, k, n_sets, gen, f, dtype=torch.float32):
    """``n_sets`` independent input and output sets at the index's shape:
    values (n, f), w and g (E, f) in ``dtype``, the index and its CSR, and
    the three outputs (K2b's in f32)."""
    order, rowptr = index.csr()
    n, e = index.n, index.idx.shape[0]
    dev = index.idx.device

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    sets = []
    for _ in range(n_sets):
        sets.append({
            "values": randn(n, f), "w": randn(e, f), "g": randn(e, f),
            "idx": index.idx.clone(), "order": order.clone(),
            "rowptr": rowptr.clone(),
            "gather_mul_reduce": torch.empty(e // k, f, device=dev,
                                             dtype=dtype),
            "table_gather": torch.empty(e, f, device=dev, dtype=dtype),
            "table_scatter": torch.empty(n, f, device=dev),
        })
    return sets


def kernel_calls(lib, s, k):
    """{kernel: fn} launching ``lib``'s entry points on set ``s`` into its
    own outputs (no allocation, no launch count); the bf16 instantiations
    for a bf16 set."""
    n, f = s["values"].shape
    e = s["idx"].shape[0]
    p = {name: t.data_ptr() for name, t in s.items()}
    sfx = "_bf16" if s["values"].dtype == torch.bfloat16 else ""
    entry = {name: getattr(lib, f"mdg_{name}{sfx}") for name in KERNELS}

    def stream():   # the current one: a graph captures on its own
        return _build.stream_of(s["values"])

    def k1():
        _build.check(entry["gather_mul_reduce"](
            p["values"], p["w"], p["idx"], p["gather_mul_reduce"], n, e // k,
            k, f, stream()), "gather_mul_reduce")

    def k2a():
        _build.check(entry["table_gather"](
            p["values"], p["idx"], p["table_gather"], n, e, f, stream()),
            "table_gather")

    def k2b():
        _build.check(entry["table_scatter"](
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


def csr_scratch(lib, e, n):
    """The scratch ``lib``'s CSR build takes, in ints: its own
    ``mdg_table_index_csr_scratch``, or n + 1 for a library from before
    the radix grid build."""
    if hasattr(lib, "mdg_table_index_csr_scratch"):
        return lib.mdg_table_index_csr_scratch(e, n)
    return n + 1


def csr_outputs(e, n, dev, libs):
    """(order (e,), rowptr (n + 1,), scratch) int32 for :func:`csr_call`,
    the scratch as large as any of ``libs`` takes."""
    scratch = max(csr_scratch(lib, e, n) for lib in libs)
    return tuple(torch.empty(size, dtype=torch.int32, device=dev)
                 for size in (e, n + 1, scratch))


def csr_call(lib, idx, n, out, cluster=True):
    """fn launching ``lib``'s CSR build of ``idx`` over ``n`` rows into
    ``out`` (:func:`csr_outputs`; no allocation, no launch count): the
    build the library picks, or the grid build where ``cluster`` is
    False."""
    order, rowptr, scratch = (t.data_ptr() for t in out)
    shared = gather._CSR_ANY_SHARED if cluster else gather._CSR_GRID

    def fn():
        _build.check(lib.mdg_table_index_csr(
            idx.data_ptr(), idx.shape[0], n, order, rowptr, scratch, shared,
            _build.stream_of(idx)), "table_index_csr")

    return fn


def csr_launch_times(lib, idx, n, out, cluster=True, calls=10):
    """{launch: device ms a build} of ``lib``'s CSR build of ``idx`` over
    ``n`` rows into ``out`` (:func:`csr_call`), each kernel and memset
    apart, from the card's events in ``torch.profiler`` over ``calls``
    eager builds."""
    from torch.profiler import ProfilerActivity, profile
    fn = csr_call(lib, idx, n, out, cluster)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::|\(.*", "",
                          ev.name).strip()
            span = ev.time_range.end - ev.time_range.start
            times[name] = times.get(name, 0.0) + span / calls / 1e3
    return times


def csr_times(lib, csr_inputs, s, k, libs):
    """{label: warm ms} of ``lib``'s CSR build: at each ``{e: (idx, n)}``
    of ``csr_inputs`` on the path the library picks ("csr@e") and on the
    grid build forced ("csr_grid@e"); and, at set ``s``'s index, the build
    followed by K2b on ``s`` reading it ("csr+k2b").  The scratch is sized
    for every library of ``libs``, so each is timed on the same buffers'
    sizes."""
    out = {}
    for e, (idx, n) in csr_inputs.items():
        bufs = csr_outputs(e, n, idx.device, libs)
        out[f"csr@{e}"] = timing.time_graph(csr_call(lib, idx, n, bufs),
                                            reps=20)
        out[f"csr_grid@{e}"] = timing.time_graph(
            csr_call(lib, idx, n, bufs, cluster=False), reps=20)
    n = s["values"].shape[0]
    bufs = csr_outputs(s["idx"].shape[0], n, s["idx"].device, libs)
    build = csr_call(lib, s["idx"], n, bufs)
    scatter = kernel_calls(lib, dict(s, order=bufs[0], rowptr=bufs[1]),
                           k)["table_scatter"]
    out["csr+k2b"] = timing.time_graph(lambda: (build(), scatter()),
                                       reps=20)
    return out

