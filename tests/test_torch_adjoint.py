"""The port's replay adjoint (mdgrad_tpu_torch/md/adjoint.py and
Simulation.epoch_fn) against direct autograd through the step loop, and
against ``jax.grad`` through the JAX package's ``epoch_fn``.

The systems are the water shapes of tests/test_torch_slice.py: 64 O sites
on the diamond lattice at the water density, Nose-Hoover chain at 298 K
(Q=50, 5 chains), dt 0.5 fs, tables refreshed every step.  Gradients are
compared in float64 (the JAX side inside ``jax.enable_x64(True)``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.observables import rdf as rdf_j
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import units
from mdgrad_tpu_torch.data.registry import get_unit_len

L_WATER = get_unit_len(0.99749, 18.01528, 8)
WIDTHS = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 2, "cutoff": 6.0}
DT = 0.5 * units.fs
TAU = 11                      # 10 steps, frames 0, 5 and 10 to the RDF


def _water(cls, seed=0):
    s = cls.from_lattice("diamond", 2, L_WATER, symbol="O")
    s.masses = np.full(64, 18.01528)
    s.set_temperature(298.0, rng=np.random.default_rng(seed))
    return s


def _prior():
    return mt.potentials.ExcludedVolume(sigma=2.6, epsilon=0.01, power=12)


def _schnet_sim(adjoint):
    """64-site water Stack{SchNet 16/16/8, ExcludedVolume} in float64."""
    s = _water(mt.System)
    stack = mt.Stack({
        "nn": mt.GNNPotentials(s, mt.SchNet(WIDTHS, seed=0), cutoff=6.0,
                               capacity_slack=1.25, device="cpu"),
        "prior": mt.PairPotentials(s, _prior(), cutoff=6.0, mode="dense",
                                   device="cpu")}).double()
    integ = mt.NoseHooverChain(stack, s, T=298.0, Q=50.0, num_chains=5,
                               adjoint=adjoint, device="cpu",
                               dtype=torch.float64)
    return s, stack, mt.Simulation(s, integ)


def _rdf_loss(s, traj):
    obs = mt.observables.rdf(s, 109, (1.8, 7.5), backend="pallas",
                             device="cpu")
    g = obs(traj.q[::5])[2]
    return ((g - 1.0) ** 2).sum()


def _final_state_loss(s, traj):
    return (traj.q[-1] ** 2).sum() + (traj.v[-1] ** 2).sum()


def _grads(adjoint, loss_fn):
    s, stack, sim = _schnet_sim(adjoint)
    state, aux = sim.initial_state()
    ode = sim.epoch_fn(DT, TAU)
    traj, _ = ode(state, aux, sim.integrator.default_ctrl())
    params = dict(stack.named_parameters())
    grads = torch.autograd.grad(loss_fn(s, traj), list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return dict(zip(params, grads))


@pytest.mark.parametrize("loss_fn", [_rdf_loss, _final_state_loss],
                         ids=["rdf", "final_state"])
def test_replay_equals_direct_f64(loss_fn):
    """The replay re-runs each step at the stored state it consumed, so
    its gradient equals direct backprop through the loop to roundoff (the
    bound, 1e-9 of each gradient's largest entry, is ~1e5 x f64 eps)."""
    g_adj = _grads(True, loss_fn)
    g_dir = _grads(False, loss_fn)
    assert g_adj.keys() == g_dir.keys()
    for name in g_adj:
        a, d = g_adj[name], g_dir[name]
        scale = d.abs().max().item()
        torch.testing.assert_close(a, d, atol=1e-9 * scale, rtol=1e-9,
                                   msg=name)
    # every parameter moves the dynamics except the energy readout's
    # output bias, a constant energy offset with no force
    zero = {name for name, g in g_adj.items() if not g.abs().max() > 0}
    assert zero == {"models.nn.gnn.readouts.energy.d1.bias"}


def _pair_loss_jax(frames_every=5):
    s = _water(SystemJ)
    pair = PairPotentialsJ(s, potentials_j.ExcludedVolume(
        sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense")
    integ = NoseHooverChainJ(pair, s, T=298.0, Q=50.0, num_chains=5,
                             adjoint=True)
    sim = SimulationJ(s, integ)
    ode = sim.epoch_fn(0.5 * units_j.fs, TAU)
    state, aux = sim.initial_state()
    obs = rdf_j(s, 109, (1.8, 7.5))
    ctrl = integ.default_ctrl()

    def loss(params):
        traj, _ = ode(params, state, aux, ctrl)
        return ((obs(traj.q[::frames_every])[2] - 1.0) ** 2).sum()

    return loss, sim.params


def test_pair_gradients_match_jax_epoch_fn_f64():
    """d(RDF loss)/d(sigma, epsilon) of a dense ExcludedVolume-only NHC
    epoch: the port's replay against jax.grad through the JAX package's
    epoch_fn (its replay custom_vjp), float64 on both sides.  The JAX
    observable keeps its Gaussian basis in float32, as the port's does;
    the rest is f64, so the two agree to ~1e-12; the bound is 1e-6."""
    with jax.enable_x64(True):
        loss_j, params_j = _pair_loss_jax()
        value_j, grads_j = jax.value_and_grad(loss_j)(params_j)
        value_j = float(value_j)
        grads_j = {k: float(v) for k, v in grads_j.items()}
    s = _water(mt.System)
    pair = mt.PairPotentials(s, _prior(), cutoff=6.0, mode="dense",
                             device="cpu").double()
    integ = mt.NoseHooverChain(pair, s, T=298.0, Q=50.0, num_chains=5,
                               device="cpu", dtype=torch.float64)
    sim = mt.Simulation(s, integ)
    state, aux = sim.initial_state()
    traj, _ = sim.epoch_fn(DT, TAU)(state, aux, integ.default_ctrl())
    obs = mt.observables.rdf(s, 109, (1.8, 7.5), device="cpu")
    loss = ((obs(traj.q[::5])[2] - 1.0) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), value_j, rtol=1e-6)
    for name in ("sigma", "epsilon"):
        got = getattr(pair.model, name).grad.item()
        assert got != 0.0
        np.testing.assert_allclose(got, grads_j[name], rtol=1e-6)


def test_grad_wrt_initial_state():
    """The gradient reaches state0 -- through the wrap, the primed entry
    force and the replay -- finite, nonzero and equal to direct backprop
    (mirrors tests/test_adjoint.py::test_grad_wrt_initial_state)."""
    grads = {}
    for adjoint in (True, False):
        s, stack, sim = _schnet_sim(adjoint)
        for p in stack.parameters():
            p.requires_grad_(False)
        state, aux = sim.initial_state()
        q0 = state.q.clone().requires_grad_(True)
        traj, _ = sim.epoch_fn(DT, 8)(state._replace(q=q0), aux,
                                      sim.integrator.default_ctrl())
        (grads[adjoint],) = torch.autograd.grad(
            (traj.q[-1] ** 2).sum(), q0)
    g = grads[True]
    assert bool(torch.isfinite(g).all()) and g.abs().max() > 0
    torch.testing.assert_close(g, grads[False], rtol=1e-9,
                               atol=1e-9 * g.abs().max().item())


def test_single_epoch_matches_chunked_epochs():
    """simulate(steps=k, frequency=k) equals k / m epochs of m frames --
    the epoch structure (entry wrap, force prime, restart) must not change
    the physics (mirrors tests/test_wrap.py::
    test_single_epoch_matches_chunked_epochs).  64-site water under the
    ExcludedVolume prior, float64, 40 steps: sites cross the cell faces,
    so the in-epoch wrap runs.  Only roundoff separates the two (the
    wrapped representative differs by lattice vectors); 1e-9 A bounds it."""
    runs = {}
    for steps, frequency, repeats in ((41, 41, 1), (11, 11, 4)):
        s = _water(mt.System, seed=3)
        pair = mt.PairPotentials(s, _prior(), cutoff=6.0, mode="dense",
                                 device="cpu").double()
        sim = mt.Simulation(s, mt.NoseHooverChain(
            pair, s, T=298.0, Q=50.0, num_chains=5, device="cpu",
            dtype=torch.float64))
        for _ in range(repeats):
            traj = sim.simulate(steps=steps, dt=DT, frequency=frequency)
        runs[frequency] = traj
    a, b = runs[41], runs[11]
    np.testing.assert_allclose(a.q[-1].numpy(), b.q[-1].numpy(), atol=1e-9)
    np.testing.assert_allclose(a.v[-1].numpy(), b.v[-1].numpy(), atol=1e-9)
    np.testing.assert_allclose(a.pv[-1].numpy(), b.pv[-1].numpy(),
                               atol=1e-9)
