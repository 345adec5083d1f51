"""SchNet, GNNPotentials, the neighbor table and the parameter conversion of
the port against the JAX package, on a narrow water-shaped system: 64 O
sites on the diamond lattice at the water density (box 12.4 A), cutoff
6.0, 16/16/8 widths, 2 convolutions.  The JAX side runs
``gather_mode='pallas'`` in interpret mode (its Pallas aggregation) and
``'gather'`` (exact f32); the port runs its K1 wrapper, whose plain version
serves CPU tensors.  Weights come from the JAX init, converted with
``nn/convert.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import topology as topology_j
from mdgrad_tpu.data.registry import get_unit_len as get_unit_len_j
from mdgrad_tpu.interface import GNNPotentials as GNNPotentialsJ
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.interface import Stack as StackJ
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import ops, topology
from mdgrad_tpu_torch.data.registry import get_unit_len
from mdgrad_tpu_torch.nn.convert import (schnet_params_from_numpy,
                                         stack_params_from_numpy)

WIDTHS = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 2, "cutoff": 6.0}


def _water(cls, size=2):
    L = get_unit_len(0.99749, 18.01528, 8)
    return cls.from_lattice("diamond", size, L, symbol="O")


@pytest.fixture(scope="module")
def xyz():
    base = _water(SystemJ).get_positions()
    rng = np.random.default_rng(5)
    return (base + 0.1 * rng.standard_normal(base.shape)).astype(np.float32)


def _jax_gnn(mode):
    inter = GNNPotentialsJ(_water(SystemJ), SchNetJ(
        {**WIDTHS, "gather_mode": mode}), cutoff=6.0, capacity_slack=1.25)
    return inter, inter.init_params()


def _port_gnn(params, mode="auto"):
    inter = mt.GNNPotentials(_water(mt.System), mt.SchNet(
        {**WIDTHS, "gather_mode": mode}), cutoff=6.0, capacity_slack=1.25,
        device="cpu")
    inter.gnn.load_state_dict(schnet_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return inter


def _energy_force(inter, x):
    x = torch.tensor(x, requires_grad=True)
    u = inter.energy(x, inter.aux_init(x))
    (g,) = torch.autograd.grad(u, x)
    return u.item(), -g.numpy()


def test_get_unit_len_matches_jax():
    assert get_unit_len(0.99749, 18.01528, 8) == get_unit_len_j(
        0.99749, 18.01528, 8)


def test_k_max_matches_jax():
    inter_j, params = _jax_gnn("gather")
    assert _port_gnn(params).k_max == inter_j.k_max == 40


def test_neighbor_table_matches_jax_as_sets(xyz):
    cell_len = np.diag(_water(SystemJ).get_cell())
    for k_max in (40, 16):     # 16 < 28 neighbors: overflow on both sides
        tj = topology_j.generate_neighbor_table(
            jnp.asarray(xyz), 6.0, jnp.asarray(cell_len), k_max,
            store_offsets=False)
        tt = topology.generate_neighbor_table(
            torch.tensor(xyz), 6.0, torch.tensor(cell_len), k_max)
        assert tt.table.dtype == torch.int32
        assert bool(tt.overflow) == bool(tj.overflow) == (k_max == 16)
        assert bool(tt.drift) == bool(tj.drift) is False
        np.testing.assert_array_equal(tt.mask.numpy().sum(1),
                                      np.asarray(tj.mask).sum(1))
        n = len(xyz)
        for row_t, row_j in zip(tt.table.numpy(), np.asarray(tj.table)):
            assert set(row_t) == set(row_j)
            assert (row_t == n).sum() == (row_j == n).sum()


@pytest.mark.parametrize("mode", ["gather", "pallas"])
def test_schnet_energy_forces_match_jax(xyz, mode):
    """Port (K1 plain version) vs JAX in the same ``gather_mode``.
    'gather' is exact f32 on both sides: f32 rounding through two
    convolutions, 1e-5 relative.  'pallas' on the JAX side gathers through
    the bf16 hi/lo split (~1.5e-5 relative per feature), so the forces get
    test_pallas.py's 5e-3 of the largest force."""
    inter_j, params = _jax_gnn(mode)
    x = jnp.asarray(xyz)
    aux = inter_j.aux_init(x)
    u_j = float(inter_j.energy(params, x, aux))
    f_j = -np.asarray(jax.grad(inter_j.energy, argnums=1)(params, x, aux))
    u_t, f_t = _energy_force(_port_gnn(params, mode), xyz)
    scale = np.abs(f_j).max()
    rtol, ftol = (1e-5, 1e-4) if mode == "gather" else (1e-4, 5e-3)
    np.testing.assert_allclose(u_t, u_j, rtol=rtol)
    np.testing.assert_allclose(f_t, f_j, atol=ftol * scale)


def test_gather_modes_map_to_the_kernel_or_plain_gather(xyz):
    _, params = _jax_gnn("gather")
    results = {}
    for mode in ("auto", "onehot", "pallas", "gather"):
        ops.reset_counts()
        results[mode] = _energy_force(_port_gnn(params, mode), xyz)
        calls = ops.counts()
        # on CPU tensors every mode runs K1's plain version, once per
        # convolution: 'gather' calls it directly, the others through the
        # kernel's wrapper
        assert calls["plain_calls"]["gather_mul_reduce"] == 2
        assert sum(calls["launches"].values()) == 0
    for mode in ("auto", "onehot", "pallas"):
        np.testing.assert_allclose(results[mode][0], results["gather"][0],
                                   rtol=1e-6)
        np.testing.assert_allclose(results[mode][1], results["gather"][1],
                                   atol=1e-5 * np.abs(results["gather"][1])
                                   .max())


def test_stack_conversion_matches_jax(xyz):
    """Stack{SchNet, ExcludedVolume dense} energy and forces, the water
    stack's shape, with every parameter carried over."""
    sys_j = _water(SystemJ)
    stack_j = StackJ({
        "nn": GNNPotentialsJ(sys_j, SchNetJ({**WIDTHS, "gather_mode":
                                              "gather"}), cutoff=6.0,
                             capacity_slack=1.25),
        "prior": PairPotentialsJ(sys_j, potentials_j.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense")})
    params = stack_j.init_params()
    params["prior"] = {"sigma": jnp.asarray(2.4), "epsilon": jnp.asarray(0.02)}
    sys_t = _water(mt.System)
    stack_t = mt.Stack({
        "nn": mt.GNNPotentials(sys_t, mt.SchNet({**WIDTHS, "gather_mode":
                                                 "pallas"}), cutoff=6.0,
                               capacity_slack=1.25, device="cpu"),
        "prior": mt.PairPotentials(sys_t, mt.potentials.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense",
            device="cpu")})
    stack_t.load_state_dict(stack_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), stack_t))
    assert stack_t.models["prior"].model.sigma.item() == pytest.approx(2.4)
    x = jnp.asarray(xyz)
    aux = stack_j.aux_init(x)
    u_j = float(stack_j.energy(params, x, aux))
    f_j = -np.asarray(jax.grad(stack_j.energy, argnums=1)(params, x, aux))
    u_t, f_t = _energy_force(stack_t, xyz)
    np.testing.assert_allclose(u_t, u_j, rtol=1e-5)
    np.testing.assert_allclose(f_t, f_j, atol=1e-4 * np.abs(f_j).max())


def test_seeded_init_is_deterministic():
    a = mt.SchNet(WIDTHS, seed=3).state_dict()
    b = mt.SchNet(WIDTHS, seed=3).state_dict()
    c = mt.SchNet(WIDTHS, seed=4).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embedding.weight"], c["embedding.weight"])
    assert a["embedding.weight"].shape == (100, 16)
    # bf16 keeps the parameters (f32) and their seeded values; a dtype the
    # JAX package does not name raises
    d = mt.SchNet({**WIDTHS, "compute_dtype": "bf16"}, seed=3).state_dict()
    assert all(torch.equal(a[k], d[k]) for k in a) and a.keys() == d.keys()
    with pytest.raises(ValueError, match="compute_dtype"):
        mt.SchNet({**WIDTHS, "compute_dtype": "float16"})
