"""Inputs, work counts and calls of the RDF kernels K3/K4 and K3b/K4b,
for ``chip_smoke.py`` (times, bounds and the A/B against another
``rdf.cu``) and ``tests/test_torch_cuda.py`` (the edge cases).

* :func:`edge_cases` -- seeded inputs the kernels special-case: N = 2, 33,
  100 and 1372; F = 1, 3 and 10; more than 1024 bins; unsorted centres
  with uneven widths; an unbounded bin; pairs at the cutoff, at +-L/2 and
  one ulp around it, and more than a box apart.
* :func:`live_terms` and :func:`work` -- the bytes, operations and
  exponentials one call needs on its data, for the bound.
* :func:`calls` -- launchers of one library's two kernels on fixed
  buffers, for this build's C interface and for the one before it
  (``mdg_rdf_tile``, no image thresholds), so that another version of
  ``csrc/rdf.cu`` built into its own library runs on the same inputs.
"""

import numpy as np
import torch

from . import _build, rdf

# the C interface of csrc/rdf.cu before the division-free image (it had
# mdg_rdf_tile and no mdg_rdf_scratch): no thresholds, a 64-site tile
_P, _I, _F = _build._P, _build._I, _build._F
PARENT_SIGNATURES = {
    "mdg_rdf_tile": (),
    "mdg_rdf_counts": (_P, _I, _I, _F, _F, _F, _F, _P, _P, _I, _P, _P, _P),
    "mdg_rdf_counts_bwd": (_P, _I, _I, _F, _F, _F, _F, _P, _P, _P, _I, _P,
                           _P, _P),
}


def exp_beyond_reach(coeff, n=2048):
    """float32 ``exp(coeff d^2)`` on ``coeff``'s device for each bin at
    |d| from 1e-4 below its :func:`rdf.reach` up, the first 64 steps one
    float32 ulp of 1 each, then on to 4 reaches, both signs: (G, 2 (64 +
    n)).  Every value is +0 where the kernels may skip the term."""
    coeff = coeff.to(torch.float32)
    reach = rdf.reach(coeff.cpu()).to(coeff.device)
    ulps = torch.arange(64, dtype=torch.float32) * 2.0 ** -23
    steps = torch.cat([ulps, torch.linspace(0.0, 3.0, n)]) + (1 - 1e-4)
    d = reach[:, None] * steps.to(coeff.device)
    d = torch.cat([d, -d], 1)
    return torch.exp(coeff[:, None] * (d * d))


def _box(rng, f, n, L):
    return rng.uniform(0.0, L, size=(f, n, 3)).astype(np.float32)


def _fcc(n_cells, a, f, rng, noise=0.05):
    """F perturbed frames of an FCC box of 4 n_cells^3 sites."""
    basis = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    cells = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                     -1).reshape(-1, 1, 3)
    base = ((cells + basis) * a).reshape(-1, 3)
    return (base + noise * rng.standard_normal((f, *base.shape))).astype(
        np.float32)


def _edge_frames(L, cutoff):
    """One frame of 22 pairs along x, each pair alone inside the cutoff
    (the pairs sit 2 cutoffs apart along y in a long cell): separations
    exactly the cutoff and one ulp below it (r^2 rounds the same way in
    the kernels and the plain versions: dy = dz = 0), exactly L/2 and one
    ulp either side, the image thresholds t1 and t2 and one ulp below
    each, 1.5 L and 1.6 L (not wrapped), each with both signs."""
    from .pair import image_thresholds
    L32 = np.float32(L)
    h = np.float32(L32 / 2)
    t1, t2 = (np.float32(t) for t in image_thresholds(L))
    c = np.float32(cutoff)
    ds = [c, np.nextafter(c, np.float32(0)), h, np.nextafter(h, np.inf),
          np.nextafter(h, np.float32(0)), t1, t2,
          *(np.nextafter(t, np.float32(0)) for t in (t1, t2)),
          np.float32(1.5) * L32, np.float32(1.6) * L32]
    ds = np.array(ds + [-d for d in ds], np.float32)
    xyz = np.zeros((1, 2 * len(ds), 3), np.float32)
    xyz[0, 0::2, 0] = ds
    xyz[0, 0::2, 1] = xyz[0, 1::2, 1] = 2 * c * np.arange(len(ds))
    return xyz, (L, 2 * float(c) * (len(ds) + 1), 4 * float(c))


def edge_cases():
    """[(name, xyz (F, N, 3) float32, cell (3,), mu (G,), widths (G,),
    cutoff, ct (G,))], all from a numpy seed."""
    rng = np.random.default_rng(11)
    out = []

    def case(name, xyz, cell, mu, widths, cutoff):
        mu = np.asarray(mu, np.float32)
        widths = np.broadcast_to(np.asarray(widths, np.float32), mu.shape)
        ct = rng.standard_normal(mu.shape[0]).astype(np.float32)
        out.append((name, xyz, tuple(float(c) for c in cell), mu,
                    np.ascontiguousarray(widths), float(cutoff), ct))

    water_mu = np.linspace(1.8, 7.5, 109)
    lj_mu = np.linspace(0.75, 2.5, 100)
    case("n2_f1", _box(rng, 1, 2, 12.0), (12.0,) * 3, water_mu,
         water_mu[1] - water_mu[0], 8.0)
    case("n33_f3", _box(rng, 3, 33, 7.0), (7.0, 7.5, 8.0), lj_mu,
         lj_mu[1] - lj_mu[0], 3.0)
    case("n100_f10", _box(rng, 10, 100, 8.0), (8.0,) * 3, lj_mu,
         lj_mu[1] - lj_mu[0], 3.0)
    case("n1372_f3", _fcc(7, 1.679, 3, rng), (7 * 1.679,) * 3, lj_mu,
         lj_mu[1] - lj_mu[0], 3.0)
    many = np.linspace(0.5, 4.0, 1500)
    case("bins1500_n100_f3", _box(rng, 3, 100, 9.0), (9.0,) * 3, many,
         many[1] - many[0], 4.5)
    case("unsorted_mu", _box(rng, 3, 100, 8.0), (8.0,) * 3,
         rng.permutation(np.linspace(0.75, 3.0, 60)),
         rng.uniform(0.02, 0.2, 60), 3.2)
    flat = np.full(40, 0.05)
    flat[17] = np.inf                      # coeff -0: exp is 1 for any r
    case("unbounded_bin", _box(rng, 2, 100, 8.0), (8.0,) * 3,
         np.linspace(0.75, 2.5, 40), flat, 3.0)
    for L in (5.0, 11.753):
        xyz, cell = _edge_frames(L, 3.0)
        case(f"edges_L{L}", xyz, cell, np.linspace(0.5, 3.0, 60), 0.05, 3.0)
    return out


def live_terms(xyz, cell_len, mu, coeff, cutoff):
    """(i < j pairs inside the cutoff, (pair, bin) terms inside the
    reach), summed over the frames of ``xyz`` ((N, 3) or (F, N, 3)): the
    exponentials the function needs on this data, one frame at a time."""
    frames = xyz if xyz.dim() == 3 else xyz[None]
    n = frames.shape[1]
    dev = frames.device
    L = torch.as_tensor(cell_len, dtype=frames.dtype, device=dev)
    cut_sq = float(torch.tensor(cutoff, dtype=torch.float32) ** 2)
    iu = torch.triu_indices(n, n, 1, device=dev)
    span = rdf.reach(coeff.cpu()).to(dev)
    pairs = terms = 0
    for x in frames:
        d = x[iu[1]] - x[iu[0]]
        d = d - torch.round(d / L) * L
        r_sq = (d * d).sum(-1)
        r = torch.sqrt(r_sq[r_sq < cut_sq])
        pairs += r.shape[0]
        terms += int(((r[:, None] - mu).abs() < span).sum())
    return pairs, terms


def work(xyz, op, backward):
    """{bytes, ops, exps, pairs_inside} of one call on ``xyz`` (F, N, 3):
    each input read once and each output written once; per i < j pair 15
    operations (3 subtractions, 3 x 3 for the minimum image, 3 for r^2);
    per (i < j pair, bin) term inside the reach (:func:`live_terms`,
    the only ones not exactly 0) one exponential and, forward, a
    subtraction, 2 multiplications and an addition, backward 2 more
    multiplications and a fused add; backward per pair inside the cutoff
    w / r and +-(w / r) d to both sites (10)."""
    f, n, _ = xyz.shape
    g = op.mu.shape[0]
    pairs_in, terms = live_terms(xyz, op.cell_len, op.mu, op.coeff,
                                 op.cutoff)
    pairs_all = f * n * (n - 1) // 2
    if backward:
        n_bytes = 4 * (2 * f * n * 3 + 3 * g)
        ops = 15 * pairs_all + 6 * terms + 10 * pairs_in
    else:
        n_bytes = 4 * (f * n * 3 + 3 * g)
        ops = 15 * pairs_all + 5 * terms
    return {"bytes": n_bytes, "ops": ops, "exps": terms,
            "pairs_inside": pairs_in}


def calls(lib, xyz, op, ct):
    """{"rdf_counts": (launch, out), "rdf_counts_bwd": (launch, out)}:
    ``lib``'s two kernels on ``xyz`` (F, N, 3), the bins of ``op`` (an
    RDFCounts) and the cotangent ``ct``, each writing its own fixed
    buffers; ``launch()`` reads the current stream at each call (a CUDA
    graph captures on its own).  No launch counter moves."""
    f, n, _ = xyz.shape
    g = op.mu.shape[0]
    dev = xyz.device
    out = torch.empty(g, device=dev, dtype=torch.float32)
    dxyz = torch.empty_like(xyz)
    ptrs = (op.mu.data_ptr(), op.coeff.data_ptr())
    if hasattr(lib, "mdg_rdf_scratch"):
        cell = rdf._cell_args(op.cell_len)
        part = [torch.empty(lib.mdg_rdf_scratch(f, n, g, b), device=dev)
                for b in (0, 1)]
    else:
        for name, argtypes in PARENT_SIGNATURES.items():
            getattr(lib, name).argtypes = list(argtypes)
        cell = tuple(float(c) for c in op.cell_len)
        tiles = -(-n // lib.mdg_rdf_tile())
        part = [torch.empty(g * f * tiles * tiles, device=dev),
                torch.empty(f * tiles * n * 3, device=dev)]
    head = (xyz.data_ptr(), f, n, *cell, float(op.cutoff), *ptrs)

    def fwd():
        _build.check(lib.mdg_rdf_counts(
            *head, g, part[0].data_ptr(), out.data_ptr(),
            _build.stream_of(xyz)), "rdf_counts")

    def bwd():
        _build.check(lib.mdg_rdf_counts_bwd(
            *head, ct.data_ptr(), g, part[1].data_ptr(), dxyz.data_ptr(),
            _build.stream_of(xyz)), "rdf_counts_bwd")

    return {"rdf_counts": (fwd, out), "rdf_counts_bwd": (bwd, dxyz)}
