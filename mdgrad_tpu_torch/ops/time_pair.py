"""Inputs and calls of the LJ pair kernels K5, K6, K6b and K7, for
``chip_smoke.py`` (the kernel checks and the A/B against another
``pair.cu``) and ``tests/test_torch_cuda.py`` (the card tests).

* :func:`lj_edge_cases` -- pairs at the minimum image's edges.
* :func:`cutoff_edge_case` -- pairs whose r^2 lies within an ulp of
  cutoff^2, where the stepwise sum the plain versions take and a fused
  one fall on opposite sides of it.
* :func:`unwrapped` -- positions shifted by whole cell lengths, so that
  the kernels' blocks take the IEEE image (``kFar``).
* :func:`pair_image_w` -- a cotangent for inputs of isolated pairs;
  :func:`split` -- a kernel's result as (vector, scalars).
* :func:`calls` -- launchers of one library's four LJ kernels on fixed
  buffers, for this build's C interface and for the one before
  ``mdg_lj_scratch``, so that another version of ``csrc/pair.cu`` built
  into its own library runs on the same inputs.
"""

import numpy as np
import torch

from . import _build, pair

# K5, K6, K6b and K7: the A/B times all four modes of the i < j walk
AB_KERNELS = ("lj_energy_forces", "lj_force", "lj_force_vjp",
              "lj_force_param")


def _ulps(x, k):
    return (np.float32(x).view(np.int32) + np.int32(k)).view(np.float32)


def lj_edge_cases():
    """[(L, axis, xyz (36, 3) float32, cell (3,), cutoff, sigma)]: 18
    pairs whose displacement along ``axis`` is +-L/2 exactly, one ulp on
    each side of it, at the image thresholds t1 and t2 and one ulp below
    each, 1.5 L and 1.6 L (positions not wrapped); the pairs sit L apart
    along the next axis, in a cell of 40 L there, so each pair sees only
    itself inside the cutoff 0.6 L.  A wrong image decision flips the sign
    of the pair's force."""
    out = []
    for L in (1.0, 11.75, 16.79, 21.827):
        L32 = np.float32(L)
        h = np.float32(L32 / 2)
        t1, t2 = (np.float32(t) for t in pair.image_thresholds(L))
        down = [np.nextafter(t, np.float32(0)) for t in (h, t1, t2)]
        ds = [h, np.nextafter(h, np.float32(np.inf)), t1, t2, *down,
              np.float32(1.5) * L32, np.float32(1.6) * L32]
        ds = np.array(ds + [-d for d in ds], dtype=np.float32)
        for axis in range(3):
            other = (axis + 1) % 3
            xyz = np.zeros((2 * len(ds), 3), np.float32)
            xyz[0::2, axis] = ds
            xyz[0::2, other] = xyz[1::2, other] = L32 * np.arange(len(ds))
            cell = np.full(3, 40 * L)
            cell[axis] = L
            out.append((L, axis, xyz, tuple(float(c) for c in cell),
                        0.6 * L, 0.25 * L))
    return out


def cutoff_edge_case(cutoff=2.5, n_pairs=8, seed=0):
    """(xyz (2 n_pairs + 2, 3) float32, cell (3,), n_out): ``n_pairs``
    pairs with d = (dx, dy, 0) where the plain versions' stepwise
    fl(fl(dx^2) + fl(dy^2)) is not below fl(cutoff^2), so the pair stays
    out, but both fused sums fma(dx, dx, fl(dy^2)) and fma(dy, dy,
    fl(dx^2)) are (a kernel that let nvcc contract r^2 would take it);
    half of them with the atoms in the other order; then one pair at 0.9
    cutoff that counts.  The pairs sit 2 cutoffs apart along z, each alone
    inside the cutoff; z - z is exact, so d is exactly (dx, dy, 0)."""
    c = np.float32(cutoff)
    cut_sq = np.float32(c * c)
    rng = np.random.default_rng(seed)
    found = []
    while len(found) < n_pairs:
        dx = np.float32(c * np.cos(rng.uniform(0.1, 1.4)))
        y0 = np.float32(np.sqrt(np.float64(cut_sq) - np.float64(dx) ** 2))
        for dy in (_ulps(y0, k) for k in range(-3, 4)):
            sx, sy = np.float32(dx * dx), np.float32(dy * dy)
            # dx^2 (48 bits) plus a float32 is exact in float64: one
            # rounding to float32, as an fma takes
            fused = (np.float32(np.float64(dx) ** 2 + np.float64(sy)),
                     np.float32(np.float64(dy) ** 2 + np.float64(sx)))
            if np.float32(sx + sy) >= cut_sq and max(fused) < cut_sq:
                found.append((dx, dy))
                break
    ds = [(dx, dy) if k % 2 else (-dx, -dy)
          for k, (dx, dy) in enumerate(found)]
    ds.append((np.float32(0.9) * c, np.float32(0)))
    xyz = np.zeros((2 * len(ds), 3), np.float32)
    for k, (dx, dy) in enumerate(ds):
        z = np.float32(2 * k) * c
        first, second = (2 * k, 2 * k + 1) if k % 4 < 2 else (2 * k + 1,
                                                              2 * k)
        xyz[first] = (dx, dy, z)
        xyz[second] = (0, 0, z)
    cell = (8.0 * float(c), 8.0 * float(c), 2.0 * float(c) * len(ds))
    return xyz, cell, len(found)


def unwrapped(xyz, cell, seed=0):
    """``xyz`` (N, 3) float32 numpy with each atom moved by -2 to 2 whole
    cell lengths per axis, from ``seed``: the blocks span more than 1.5 L,
    so the kernels take the IEEE image there (``kFar``)."""
    rng = np.random.default_rng(seed)
    shift = rng.integers(-2, 3, size=xyz.shape) * np.asarray(cell)
    return (xyz + shift).astype(np.float32)


def pair_image_w(xyz, cell):
    """A cotangent for ``xyz`` (N, 3) made of isolated pairs (2k, 2k + 1):
    W_2k+1 is the pair's minimum-image d (as the plain versions take it),
    W_2k 0, so each pair's W_ij . d_ij is r^2 > 0 and K6b's scalar sums
    over a few pairs have no cancellation that would blur their relative
    error."""
    w = torch.zeros_like(xyz)
    L = torch.tensor(cell, dtype=xyz.dtype, device=xyz.device)
    d = xyz[0::2] - xyz[1::2]
    w[1::2] = d - torch.round(d / L) * L
    return w


def split(name, res):
    """(forces or vjp (N, 3), tuple of scalars) of a K5-K7 result: K5
    returns (E, F), K6 F, K6b and K7 (vector, scalar, scalar)."""
    if name == "lj_force":
        return res, ()
    if name == "lj_energy_forces":
        return res[1], res[:1]
    return res[0], tuple(res[1:])


def _sizes(lib, name, n):
    """(partial, block_partial) float counts for ``lib``: its own
    ``mdg_lj_scratch`` or, for a ``pair.cu`` from before it, that file's
    rule (K6 on 64-atom tiles, the others on ordered-pair 128 tiles, whose
    edge ``mdg_pair_tile`` gives: ``int f(void)``, ctypes' default)."""
    if hasattr(lib, "mdg_lj_scratch"):
        mode = pair._MODES.index(name)
        return tuple(lib.mdg_lj_scratch(mode, n, which) for which in (0, 1))
    tile = lib.mdg_force_tile() if name == "lj_force" else lib.mdg_pair_tile()
    tiles = -(-n // tile)
    return tiles * n * 3, pair.SCALARS[name] * tiles * tiles


def calls(lib, xyz, w, cell, cutoff, sigma, eps):
    """{name: (launch, (out_vec, out_scalars))} for the four kernels of
    ``lib`` on ``xyz`` (N, 3) and the cotangent ``w`` (K6b), each writing
    its own fixed buffers (out_scalars None for K6); ``launch()`` reads
    the current stream at each call (a CUDA graph captures on its own).
    No launch counter moves."""
    n = xyz.shape[0]
    dev = xyz.device
    cell = tuple(float(c) for c in cell)
    t1, t2 = zip(*map(pair.image_thresholds, cell))
    out = {}
    for name in AB_KERNELS:
        mode = pair._MODES.index(name)
        part, block = (torch.empty(max(size, 1), device=dev)
                       for size in _sizes(lib, name, n))
        vec = torch.empty(n, 3, device=dev)
        scalars = (torch.empty(pair.SCALARS[name], device=dev)
                   if pair.SCALARS[name] else None)
        args = (mode, xyz.data_ptr(),
                w.data_ptr() if name == "lj_force_vjp" else None, n, *cell,
                *t1, *t2, float(cutoff), sigma.data_ptr(), eps.data_ptr(),
                12, 6, part.data_ptr(), block.data_ptr(), vec.data_ptr(),
                None if scalars is None else scalars.data_ptr())

        def launch(args=args, name=name):
            _build.check(lib.mdg_lj_pair(*args, _build.stream_of(xyz)),
                         name)

        out[name] = (launch, (vec, scalars))
    return out
