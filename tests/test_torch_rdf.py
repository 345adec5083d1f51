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
from mdgrad_tpu_torch.system import System

NBINS, R_RANGE = 48, (0.75, 2.0)


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
