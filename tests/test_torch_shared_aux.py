"""``Stack(share_aux=...)`` in the port: the five tests of
tests/test_shared_aux.py (one neighbor table feeds the SchNet and the
table-mode prior) on the port, the first also against the JAX package's
shared stack with the same weights."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import system as system_j
from mdgrad_tpu.interface import GNNPotentials as GNNPotentialsJ
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.interface import Stack as StackJ
from mdgrad_tpu.nn import SchNet as SchNetJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import units
from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(lib=mt, n_cell=3, a=1.679):
    s = lib.System.from_lattice("fcc", n_cell, a)
    s.set_temperature(1.0 / units.kB, rng=np.random.default_rng(0))
    return s


def _schnet_cfg(cutoff):
    return {"n_atom_basis": 32, "n_filters": 32, "n_gaussians": 16,
            "n_convolutions": 1, "cutoff": cutoff}


def _ev():
    return mt.potentials.ExcludedVolume(sigma=0.9, epsilon=1.0, power=12)


def _prior(s, cutoff, mode):
    return mt.PairPotentials(s, _ev(), cutoff=cutoff, mode=mode,
                             device="cpu")


def _stacks(s, cutoff=2.2):
    nn = mt.GNNPotentials(s, mt.SchNet(_schnet_cfg(cutoff), seed=0),
                          cutoff=cutoff, nbr_mode="table", device="cpu")
    shared = mt.Stack({"nn": nn, "prior": _prior(s, cutoff, "table")},
                      share_aux={"prior": "nn"})
    plain = mt.Stack({"nn": nn, "prior": _prior(s, cutoff, "table")})
    return shared, plain


def test_shared_table_energy_matches_unshared():
    """The shared stack's energy equals the unshared one's (1e-6), its
    prior term equals the dense prior's (1e-6), and it equals the JAX
    shared stack's with the same weights (1e-5, float32 sums in another
    order)."""
    s = _system()
    shared, plain = _stacks(s)
    xyz = torch.tensor(s.get_positions(), dtype=torch.float32)
    aux_s, aux_p = shared.aux_init(xyz), plain.aux_init(xyz)
    assert aux_s["prior"] == ()
    e_s = shared.energy(xyz, aux_s).item()
    np.testing.assert_allclose(e_s, plain.energy(xyz, aux_p).item(),
                               rtol=1e-6)
    prior = shared.models["prior"]
    np.testing.assert_allclose(
        prior.energy(xyz, aux_s["nn"]).item(),
        _prior(s, 2.2, "dense").energy(xyz, ()).item(), rtol=1e-6)

    s_j = _system(system_j)
    stack_j = StackJ({
        "nn": GNNPotentialsJ(s_j, SchNetJ({**_schnet_cfg(2.2),
                                           "gather_mode": "gather"}),
                             cutoff=2.2, nbr_mode="table"),
        "prior": PairPotentialsJ(s_j, potentials_j.ExcludedVolume(
            sigma=0.9, epsilon=1.0, power=12), cutoff=2.2, mode="table")},
        share_aux={"prior": "nn"})
    params = jax.tree_util.tree_map(np.asarray, stack_j.init_params())
    shared.load_state_dict(stack_params_from_numpy(params, shared))
    x_j = jnp.asarray(s_j.get_positions(), dtype=jnp.float32)
    e_j = float(stack_j.energy(params, x_j, stack_j.aux_init(x_j)))
    np.testing.assert_allclose(shared.energy(xyz, aux_s).item(), e_j,
                               rtol=1e-5)


def test_shared_table_larger_donor_cutoff_remasked():
    """The donor builds its table at cutoff + skin (2.4 + 0.4); the
    table-mode prior re-masks it to its own 1.9, equal to the dense prior
    (1e-5: the table and dense paths sum in different orders)."""
    s = _system()
    nn = mt.GNNPotentials(s, mt.SchNet(_schnet_cfg(2.4), seed=0), cutoff=2.4,
                          nbr_mode="table", skin=0.4, device="cpu")
    prior = _prior(s, 1.9, "table")
    stack = mt.Stack({"nn": nn, "prior": prior}, share_aux={"prior": "nn"})
    xyz = torch.tensor(s.get_positions(), dtype=torch.float32)
    aux = stack.aux_init(xyz)
    assert nn.build_cutoff == pytest.approx(2.8)
    np.testing.assert_allclose(
        prior.energy(xyz, aux["nn"]).item(),
        _prior(s, 1.9, "dense").energy(xyz, ()).item(), rtol=1e-5)


def test_shared_aux_gradients_match():
    s = _system()
    shared, plain = _stacks(s)
    xyz = torch.tensor(s.get_positions(), dtype=torch.float32)
    forces = []
    for stack in (shared, plain):
        x = xyz.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(stack.energy(x, stack.aux_init(xyz)), x)
        forces.append(g.numpy())
    np.testing.assert_allclose(forces[0], forces[1], rtol=1e-5, atol=1e-7)


def test_share_aux_validation():
    s = _system()
    p1, p2 = _prior(s, 2.0, "table"), _prior(s, 2.0, "table")
    with pytest.raises(ValueError):
        mt.Stack({"a": p1}, share_aux={"a": "missing"})
    with pytest.raises(ValueError):
        mt.Stack({"a": p1, "b": p2}, share_aux={"a": "b", "b": "a"})
    # capacity grows on the donor only; the sharer's slot stays ()
    stack = mt.Stack({"a": p1, "b": p2}, share_aux={"b": "a"})
    k_a, k_b = p1.k_max, p2.k_max
    assert stack.grow_capacity(2.0)
    assert p1.k_max > k_a and p2.k_max == k_b


def test_shared_aux_through_simulation():
    """30 NVE steps with the shared stack stay finite and track the
    unshared stack's trajectory (1e-6)."""
    finals = []
    for share in (True, False):
        s = _system()
        shared, plain = _stacks(s)
        stack = shared if share else plain
        integ = mt.NVE(stack, s, device="cpu")
        traj = mt.Simulation(s, integ).simulate(steps=30, dt=0.002,
                                                frequency=30)
        finals.append(traj.q[-1].numpy())
    assert np.isfinite(finals[0]).all()
    np.testing.assert_allclose(finals[0], finals[1], atol=1e-6)
