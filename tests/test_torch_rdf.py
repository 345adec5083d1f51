"""Soft-histogram RDF of the port (mdgrad_tpu_torch/ops/rdf.py and
observables.rdf), forward and backward, against the JAX package's Pallas
RDF kernels and their vjps (mdgrad_tpu/ops/pallas_rdf.py, interpret mode
on the CPU) and its dense XLA path.  The CUDA kernels themselves are held
to the plain versions on the card by tests/test_torch_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu.observables import generate_vol_bins as generate_vol_bins_j
from mdgrad_tpu.observables import rdf as rdf_j
from mdgrad_tpu.ops.pallas_rdf import make_pallas_rdf
from mdgrad_tpu.system import System as SystemJ
from mdgrad_tpu_torch import observables, ops
from mdgrad_tpu_torch.ops import rdf as trdf
from mdgrad_tpu_torch.ops import time_rdf
from mdgrad_tpu_torch.system import System

NBINS, R_RANGE = 48, (0.75, 2.0)
# the edge cases small enough for the Pallas kernels in interpret mode
_JAX_EDGE_CASES = ("n2_f1", "n33_f3", "unsorted_mu", "unbounded_bin",
                   "edges_L5.0", "edges_L11.753")


@pytest.fixture(scope="module")
def frames():
    """Three perturbed 108-atom FCC frames (box 5.04, cutoff 2.5 < L/2)."""
    base = SystemJ.from_lattice("fcc", 3, 1.679).get_positions()
    rng = np.random.default_rng(1)
    return np.stack([base + rng.normal(0, 0.05, base.shape)
                     for _ in range(3)]).astype(np.float32)


def _systems():
    return (System.from_lattice("fcc", 3, 1.679),
            SystemJ.from_lattice("fcc", 3, 1.679))


def _ops(frames):
    obs = rdf_j(_systems()[1], NBINS, R_RANGE)
    cell_len = np.diag(_systems()[0].get_cell())
    mu, widths = np.asarray(obs.smear.offsets), np.asarray(obs.smear.widths)
    jax_counts = make_pallas_rdf(cell_len, mu, widths, obs.cutoff_boundary,
                                 interpret=True)
    port = trdf.RDFCounts(cell_len, mu, widths, obs.cutoff_boundary, "cpu")
    return jax_counts, port


# f32 sums of a few thousand exponentials per bin, taken in another order
# (i < j here, 1/2 * i != j in the TPU kernel): ~1e-6 relative.  The
# bounds are test_pallas.py's for the same counts.
RTOL, ATOL = 1e-5, 1e-3


def test_counts_single_frame_matches_jax(frames):
    jax_counts, port = _ops(frames)
    ref = np.asarray(jax_counts(jnp.asarray(frames[0])))
    got = port(torch.tensor(frames[0]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    plain = trdf.rdf_counts_plain(torch.tensor(frames[0]), port.cell_len,
                                  port.mu, port.coeff, port.cutoff)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_counts_frames_matches_jax(frames):
    jax_counts, port = _ops(frames)
    ref = np.asarray(jax_counts.frames(jnp.asarray(frames)))
    got = port.frames(torch.tensor(frames))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=3 * ATOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_rdf_observable_matches_jax(frames, backend):
    sys_t, sys_j = _systems()
    ref = rdf_j(sys_j, NBINS, R_RANGE, backend=backend)(jnp.asarray(frames))
    got = observables.rdf(sys_t, NBINS, R_RANGE, backend=backend,
                          device="cpu")(torch.tensor(frames))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(
        observables.rdf(sys_t, NBINS, R_RANGE, device="cpu").r_axis,
        rdf_j(sys_j, NBINS, R_RANGE).r_axis)


def test_generate_vol_bins_matches_jax():
    for dim in (2, 3):
        V, vol, bins = observables.generate_vol_bins(1.8, 7.5, 109, dim)
        Vj, volj, binsj = generate_vol_bins_j(1.8, 7.5, 109, dim)
        assert V == Vj
        np.testing.assert_allclose(vol, np.asarray(volj), rtol=1e-6)
        np.testing.assert_allclose(bins, np.asarray(binsj), rtol=1e-6)


def test_counts_backward_names_the_training_slice(frames):
    """The RDF backward of the training slice runs on the CPU through its
    plain version, once per backward, and is first-order only (as the JAX
    ``custom_vjp``)."""
    _, port = _ops(frames)
    x = torch.tensor(frames[0], requires_grad=True)
    ops.reset_counts()
    (g,) = torch.autograd.grad(port(x).sum(), x)
    assert g.shape == x.shape and bool(torch.isfinite(g).all())
    assert ops.counts()["plain_calls"]["rdf_counts_bwd"] == 1
    ct = torch.ones(port.mu.shape[0], requires_grad=True)
    (g2,) = torch.autograd.grad(port(x), x, ct, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g2.sum().backward()


def _ct(n_bins):
    return np.random.default_rng(4).normal(size=n_bins).astype(np.float32)


@pytest.mark.parametrize("batched", [False, True])
def test_counts_backward_matches_jax_vjp(frames, batched):
    """K3b (one frame) and K4b (F = 3): the port's backward against the
    Pallas vjp.  f32 sums of ~1e3-1e4 terms per site in another order:
    ~1e-6 of the largest entry; the bound is 1e-4 of it."""
    jax_counts, port = _ops(frames)
    xs = frames if batched else frames[0]
    ct = _ct(port.mu.shape[0])
    fn = jax_counts.frames if batched else jax_counts
    _, vjp = jax.vjp(fn, jnp.asarray(xs))
    (ref,) = vjp(jnp.asarray(ct))
    ref = np.asarray(ref)
    x = torch.tensor(xs, requires_grad=True)
    out = port.frames(x) if batched else port(x)
    (got,) = torch.autograd.grad(out, x, torch.tensor(ct))
    assert got.shape == xs.shape
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_counts_backward_plain_matches_autograd_f64(frames):
    """The plain backward against autograd through the plain forward, in
    float64 over F = 3 frames: the same formula, so roundoff only."""
    _, port = _ops(frames)
    x = torch.tensor(frames, dtype=torch.float64, requires_grad=True)
    ct = torch.tensor(_ct(port.mu.shape[0]), dtype=torch.float64)
    counts = trdf.rdf_counts_plain(x, port.cell_len, port.mu, port.coeff,
                                   port.cutoff)
    (ref,) = torch.autograd.grad(counts, x, ct)
    got = trdf.rdf_counts_bwd_plain(x.detach(), port.cell_len, port.mu,
                                    port.coeff, port.cutoff, ct)
    scale = ref.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, ref, atol=1e-10 * scale, rtol=0)


def _path_rdf_op(name):
    """The RDFCounts a path builds: the water fit's observable over its
    target's range (109 bins), the LJ fit's as the README quickstart sets
    it (100 bins over 0.75-2.5)."""
    system = System.from_lattice("fcc", 3, 1.679)
    if name == "water":
        from mdgrad_tpu_torch.train import fit_rdf
        obs = fit_rdf.get_observer(system, "H20_0.997_298K", 109,
                                   backend="pallas", device="cpu")[2]
    else:
        obs = observables.rdf(system, 100, (0.75, 2.5), backend="pallas",
                              device="cpu")
    return obs._counts


@pytest.mark.parametrize("name", ["water", "lj_fit"])
def test_reach_leaves_out_only_exact_zeros(name):
    """The kernels skip a (pair, bin) term where |r - mu| >= reach: at the
    bins of the water fit's and the LJ fit's RDF ops, float32 exp(coeff
    d^2) is exactly 0 for every |d| from 1e-4 below the reach on (ulp
    steps, then out to 4 reaches), and the reach stays within 3% of where
    exp first reaches 0."""
    op = _path_rdf_op(name)
    assert torch.count_nonzero(time_rdf.exp_beyond_reach(op.coeff)) == 0
    reach = trdf.reach(op.coeff)
    assert bool((torch.exp(op.coeff * (0.97 * reach) ** 2) > 0).all())
    assert bool((reach < op.cutoff).all())


def test_reach_arg_is_the_kernels():
    """ops/rdf.py's REACH_ARG (the reach the tests and chip_smoke.py
    check) is the kReachArg that csrc/rdf.cu's kernels skip terms by."""
    import pathlib
    import re
    src = (pathlib.Path(trdf.__file__).parent.parent / "csrc"
           / "rdf.cu").read_text()
    (arg,) = re.findall(r"constexpr float kReachArg = ([0-9.]+)f;", src)
    assert float(arg) == trdf.REACH_ARG


def test_live_terms_count_every_nonzero_term(frames):
    """chip_smoke.py's exponential count (time_rdf.live_terms): every
    non-zero exp term of the plain sum lies inside the reach, and the terms
    inside it are within 10% of the non-zero ones (the reach's margin)."""
    _, port = _ops(frames)
    x = torch.tensor(frames)
    pairs, terms = time_rdf.live_terms(x, port.cell_len, port.mu,
                                       port.coeff, port.cutoff)
    n = x.shape[1]
    iu = torch.triu_indices(n, n, 1)
    L = torch.tensor(port.cell_len)
    nonzero = inside = 0
    for xf in x:
        d = xf[iu[1]] - xf[iu[0]]
        d = d - torch.round(d / L) * L
        r_sq = (d * d).sum(-1)
        r = torch.sqrt(r_sq[r_sq < port.cutoff ** 2])
        inside += r.shape[0]
        nonzero += int(torch.count_nonzero(
            torch.exp(port.coeff * (r[:, None] - port.mu) ** 2)))
    assert pairs == inside > 0
    assert nonzero <= terms <= 1.1 * nonzero


@pytest.mark.parametrize("case", [c for c in time_rdf.edge_cases()
                                  if c[0] in _JAX_EDGE_CASES],
                         ids=lambda c: c[0])
def test_edge_cases_match_jax(case):
    """The port on the kernels' edge cases (ops/time_rdf.py: non-uniform
    widths with unsorted centres, an unbounded bin, pairs at the cutoff
    and at the image's edges, N = 2 and 33) against make_pallas_rdf in
    interpret mode, forward and vjp, at this file's bounds."""
    _, xyz, cell, mu, widths, cutoff, ct = case
    jax_counts = make_pallas_rdf(np.asarray(cell), mu, widths, cutoff,
                                 interpret=True)
    port = trdf.RDFCounts(cell, mu, widths, cutoff, "cpu")
    ref, vjp = jax.vjp(jax_counts.frames, jnp.asarray(xyz))
    x = torch.tensor(xyz, requires_grad=True)
    got = port.frames(x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=3 * ATOL)
    (ref_g,) = vjp(jnp.asarray(ct))
    ref_g = np.asarray(ref_g)
    (got_g,) = torch.autograd.grad(got, x, torch.tensor(ct))
    np.testing.assert_allclose(got_g.numpy(), ref_g,
                               atol=1e-4 * np.abs(ref_g).max(), rtol=0)
