"""The training slice of the port end to end against the JAX package: the
water SchNet RDF fit's epoch loss and its SchNet-parameter gradient
(mdgrad_tpu_torch/train/fit_rdf.py against mdgrad_tpu/train/fit_rdf.py's
``_make_epoch_loss``), the water RDF target (data/registry.py), and one
clipped-Adam update against optax.
"""

import importlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.data import registry as registry_j
from mdgrad_tpu.interface import GNNPotentials as GNNPotentialsJ
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.interface import Stack as StackJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import ops, units
from mdgrad_tpu_torch.data import registry
from mdgrad_tpu_torch.nn.convert import (schnet_params_from_numpy,
                                         stack_params_from_numpy)
from mdgrad_tpu_torch.train import fit_rdf

# the module, not the function the train package exports under its name
fit_rdf_j = importlib.import_module("mdgrad_tpu.train.fit_rdf")
L_WATER = registry.get_unit_len(0.99749, 18.01528, 8)
WIDTHS = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 2, "cutoff": 6.0}
TAG, NBINS = "H20_0.997_298K", 109
# 10 steps and the RDF of frames 0, 5 and 10: the fit's shape (tau 52,
# frame_skip 20) cut in depth to keep the Pallas interpret mode quick
TAU, FRAME_SKIP = 11, 5


def _water(cls):
    s = cls.from_lattice("diamond", 2, L_WATER, symbol="O")
    s.masses = np.full(64, 18.01528)
    s.set_temperature(298.0, rng=np.random.default_rng(0))
    return s


def _jax_epoch_loss():
    s = _water(SystemJ)
    stack = StackJ({
        "nn": GNNPotentialsJ(s, SchNetJ({**WIDTHS, "gather_mode": "pallas"}),
                             cutoff=6.0, capacity_slack=1.25),
        "prior": PairPotentialsJ(s, potentials_j.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense")})
    integ = NoseHooverChainJ(stack, s, T=298.0, Q=50.0, num_chains=5,
                             adjoint=True)
    sim = SimulationJ(s, integ)
    _, g_target, obs = fit_rdf_j.get_observer(s, TAG, NBINS,
                                              backend="pallas")
    vg, _ = fit_rdf_j._make_epoch_loss(sim, obs, g_target, s, TAU,
                                       0.5 * units_j.fs, FRAME_SKIP)
    state, aux = sim.initial_state()
    (loss, (g, _, _)), grads = vg(sim.params, state, aux,
                                  integ.default_ctrl())
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return as_np(sim.params), float(loss), np.asarray(g), as_np(grads)


def test_epoch_loss_and_gradients_match_jax():
    """The fit's epoch loss and its gradient in the SchNet parameters
    (replay adjoint, the force's grad-of-grad through K1/K2a/K2b's plain
    versions, the RDF backward) against the JAX package's
    ``_make_epoch_loss`` with ``gather_mode='pallas'`` and
    ``backend='pallas'`` in interpret mode, float32 on both sides with the
    same weights.  The JAX aggregation runs through the bf16 hi/lo split
    (~1.5e-5 relative per feature) and each side sums in its own order:
    the loss agrees to rtol 1e-4 and the gradients to 2e-3 of their
    largest entry, the bounds tests/test_pallas.py holds gather against
    pallas to."""
    params_j, loss_j, g_j, grads_j = _jax_epoch_loss()
    s = _water(mt.System)
    stack = mt.Stack({
        "nn": mt.GNNPotentials(s, mt.SchNet(WIDTHS), cutoff=6.0,
                               capacity_slack=1.25, device="cpu"),
        "prior": mt.PairPotentials(s, mt.potentials.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense",
            device="cpu")})
    stack.load_state_dict(stack_params_from_numpy(params_j, stack))
    train = fit_rdf.fit_parameters(stack)
    integ = mt.NoseHooverChain(stack, s, T=298.0, Q=50.0, num_chains=5,
                               device="cpu")
    sim = mt.Simulation(s, integ)
    _, g_target, obs = fit_rdf.get_observer(s, TAG, NBINS, backend="pallas",
                                            device="cpu")
    loss_fn = fit_rdf.make_epoch_loss(sim, obs, g_target, s, TAU,
                                      0.5 * units.fs, FRAME_SKIP)
    state, aux = sim.initial_state()
    ops.reset_counts()
    loss, (g, last, _) = loss_fn(state, aux, integ.default_ctrl())
    calls = ops.counts()["plain_calls"]
    assert calls["rdf_counts"] == 1 and calls["rdf_counts_bwd"] == 1
    assert last.q.shape == (64, 3) and not sim.overflowed
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), g_j, atol=1e-4 * np.abs(g_j).max())
    assert all(p.requires_grad for p in train)
    assert not any(p.requires_grad
                   for p in stack.models["prior"].parameters())
    ref = schnet_params_from_numpy(grads_j["nn"])
    # the readout's output bias, a constant energy offset, moves no force:
    # autograd leaves its .grad None where JAX returns zeros
    got = {name: torch.zeros_like(p) if p.grad is None else p.grad
           for name, p in stack.models["nn"].gnn.named_parameters()}
    assert [n for n, p in stack.models["nn"].gnn.named_parameters()
            if p.grad is None] == ["readouts.energy.d1.bias"]
    assert got.keys() == ref.keys()
    flat_ref = np.concatenate([ref[k].numpy().ravel() for k in sorted(ref)])
    flat_got = np.concatenate([got[k].numpy().ravel() for k in sorted(ref)])
    scale = np.abs(flat_ref).max()
    assert scale > 0 and np.isfinite(flat_got).all()
    np.testing.assert_allclose(flat_got, flat_ref, atol=2e-3 * scale,
                               rtol=0)


def test_exp_rdf_target_matches_jax_registry():
    """The water entries and the H20_0.997_298K target on the fit's grid
    equal the JAX registry's: the same files, read in place.  The JAX
    package normalises with float32 shell volumes (its generate_vol_bins
    returns float32 arrays), the port with float64 ones: 3.4e-9 relative
    (measured), held to 1e-8; the float32 targets then agree to 1 ulp."""
    for tag, entry in registry.exp_rdf_data_dict.items():
        ref = registry_j.exp_rdf_data_dict[tag]
        assert entry.keys() == ref.keys()
        for key, value in entry.items():
            if key == "fn":
                assert os.path.realpath(value) == os.path.realpath(ref[key])
            else:
                assert value == ref[key], (tag, key)
    entry = registry.exp_rdf_data_dict[TAG]
    data = np.loadtxt(entry["fn"], delimiter=",")
    for nbins in (NBINS, 40):
        x, g = registry.get_exp_rdf(data, nbins, (1.8, 7.5))
        xj, gj = registry_j.get_exp_rdf(data, nbins, (1.8, 7.5))
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_allclose(g, gj, rtol=1e-8)
        # the transposed (2, M) layout reads the same
        np.testing.assert_allclose(
            registry.get_exp_rdf(data.T, nbins, (1.8, 7.5))[1], g, rtol=0)
    s = _water(mt.System)
    _, g_obs, _ = fit_rdf.get_observer(s, TAG, NBINS, device="cpu")
    _, g_obs_j, _ = fit_rdf_j.get_observer(_water(SystemJ), TAG, NBINS)
    assert g_obs.dtype == torch.float32
    np.testing.assert_allclose(g_obs.numpy(), np.asarray(g_obs_j),
                               rtol=1.2e-7)


@pytest.mark.parametrize("grad_norm", [3.0, 30.0], ids=["below", "above"])
def test_update_matches_optax_clip_and_adam(grad_norm):
    """Two fit updates against optax's clip_by_global_norm(10) + adam(lr)
    on the same float32 gradients, with their global norm below and above
    the clip.  Both compute the same formulas in float32 in another order:
    the parameters agree to ~1 ulp; the bound is 2.5e-7 (|p| < ~4)."""
    rng = np.random.default_rng(7)
    shapes = [(5, 3), (3,), (4, 4, 2)]
    p0 = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    steps = []
    for _ in range(2):
        g = [rng.normal(size=sh) for sh in shapes]
        norm = np.sqrt(sum((x ** 2).sum() for x in g))
        steps.append([(x * grad_norm / norm).astype(np.float32) for x in g])
    lr = 1.839e-4

    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(lr))
    params_j = [jnp.asarray(x) for x in p0]
    state = opt.init(params_j)
    for g in steps:
        updates, state = opt.update([jnp.asarray(x) for x in g], state,
                                    params_j)
        params_j = optax.apply_updates(params_j, updates)

    params = [torch.nn.Parameter(torch.tensor(x)) for x in p0]
    update = fit_rdf.FitUpdate(params, lr, grad_clip=10.0)
    for g in steps:
        for p, x in zip(params, g):
            p.grad = torch.tensor(x)
        norm = update()
        np.testing.assert_allclose(norm.item(), grad_norm, rtol=1e-5)
        assert all(p.grad is None for p in params)
    for p, ref in zip(params, params_j):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=2.5e-7)
    moved = max(np.abs(p.detach().numpy() - x).max()
                for p, x in zip(params, p0))
    assert moved > 1e-4
