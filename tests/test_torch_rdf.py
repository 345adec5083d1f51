"""Soft-histogram RDF of the port (mdgrad_tpu_torch/ops/rdf.py and
observables.rdf) against the JAX package's Pallas RDF kernels
(mdgrad_tpu/ops/pallas_rdf.py, interpret mode on the CPU) and its dense
XLA path.  The CUDA kernel itself is held to the plain version on the card
by tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu.observables import generate_vol_bins as generate_vol_bins_j
from mdgrad_tpu.observables import rdf as rdf_j
from mdgrad_tpu.ops.pallas_rdf import make_pallas_rdf
from mdgrad_tpu.system import System as SystemJ
from mdgrad_tpu_torch import observables
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
    _, port = _ops(frames)
    x = torch.tensor(frames[0], requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        port(x).sum().backward()
