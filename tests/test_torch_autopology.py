"""The port's AuTopology and SchNetAuTopology (``nn/autopology.py``,
``nn/schnet_autopology.py``) against the JAX package's, mirroring
tests/test_autopology.py.

Weights come from the JAX modules' initialisation through
``nn/convert.py``; energies and forces compare in float32 (energy rtol
2e-6, forces 1e-5 of the largest entry).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import topology as topology_j
from mdgrad_tpu.data.topology import generate_topologies as gen_top_j
from mdgrad_tpu.nn.autopology import AuTopology as AuTopologyJ
from mdgrad_tpu.nn.schnet_autopology import SchNetAuTopology as SAJ
from mdgrad_tpu_torch.data.topology import generate_topologies
from mdgrad_tpu_torch.lattice import straight_chain
from mdgrad_tpu_torch.nn.autopology import AuTopology
from mdgrad_tpu_torch.nn.convert import (
    autopology_params_from_numpy, schnet_autopology_params_from_numpy)
from mdgrad_tpu_torch.nn.schnet_autopology import SchNetAuTopology

CHAIN = {"Fr": 16, "Lh": [16], "bond_terms": ["harmonic"],
         "angle_terms": ["harmonic"], "dihedral_terms": ["OPLS"],
         "pair_terms": ["LJ"], "n_convolutions": 2,
         "trainable_prior": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chain_bonds(n):
    return np.stack([np.arange(n - 1), np.arange(1, n)], -1)


def _chain(n=8, seed=0):
    xyz, _ = straight_chain(n, 1.2, origin=(0, 0, 0))
    return xyz + np.random.default_rng(seed).normal(0, 0.08, xyz.shape)


def _tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _models(mp, bonds, n):
    """(JAX model, params, tops, masks; the port's model, tops, masks)."""
    model_j = AuTopologyJ(mp)
    tops_j, masks_j = model_j.prepare_topologies(gen_top_j(bonds, n))
    params = model_j.init_params(jnp.ones(n, dtype=jnp.int32), tops_j,
                                 masks_j)
    model = AuTopology(mp)
    model.load_state_dict(autopology_params_from_numpy(_tree(params)))
    tops, masks = model.prepare_topologies(generate_topologies(bonds, n),
                                           device="cpu")
    return (model_j, params, tops_j, masks_j), (model, tops, masks)


def _compare(mp, bonds, xyz, key="energy"):
    n = len(xyz)
    (model_j, params, tops_j, masks_j), (model, tops, masks) = _models(
        mp, bonds, n)
    z = jnp.ones(n, dtype=jnp.int32)
    u_ref, f_ref = jax.jit(model_j.energy_and_forces, static_argnums=5)(
        params, z, jnp.asarray(xyz, jnp.float32), tops_j, masks_j, key)
    u, f = model.energy_and_forces(torch.ones(n, dtype=torch.long),
                                   torch.tensor(xyz, dtype=torch.float32),
                                   tops, masks, key)
    np.testing.assert_allclose(u.item(), float(u_ref), rtol=2e-6)
    f_ref = np.asarray(f_ref)
    np.testing.assert_allclose(f.detach().numpy(), f_ref, rtol=0,
                               atol=1e-5 * np.abs(f_ref).max())
    return model, tops, masks, u.item()


def test_autopology_energy_and_forces_match_jax():
    model, tops, masks, u = _compare(CHAIN, chain_bonds(8), _chain())
    assert np.isfinite(u)


BRANCHED = np.array([[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6], [1, 7],
                     [4, 8]])


@pytest.mark.parametrize("mp", [
    {"Fr": 8, "Lh": [8, 8], "bond_terms": ["morse", "cubic", "quartic"],
     "angle_terms": ["cubic", "quartic"], "n_convolutions": 1},
    {"Fr": 8, "Lh": [8], "dihedral_terms": ["multiharmonic", "OPLS"],
     "improper_terms": ["harmonic"], "bond_terms": ["harmonic"],
     "n_convolutions": 2, "conv_type": "double_node",
     "output_keys": ["energy", "energy_1"]},
    {"Fr": 8, "Lh": [8], "bond_terms": ["harmonic"],
     "angle_terms": ["harmonic"], "improper_terms": ["harmonic"],
     "trainable_prior": False, "n_convolutions": 1},
], ids=["bond-angle-terms", "torsions-double-node", "not-trainable"])
def test_autopology_terms_match_jax(mp):
    """Every term of every net, both node convolutions, two output keys
    and the constant predictors, on a branched 9-atom molecule (impropers
    at atoms 1 and 4)."""
    xyz = np.random.default_rng(3).uniform(0, 4.0, (9, 3))
    assert len(generate_topologies(BRANCHED, 9)["impropers"]) > 0
    for key in mp.get("output_keys", ["energy"]):
        _compare(mp, BRANCHED, xyz, key)


def test_autopology_forces_match_fd():
    _, (model, tops, masks) = _models(CHAIN, chain_bonds(8), 8)
    z = torch.ones(8, dtype=torch.long)
    xyz = torch.tensor(_chain(), dtype=torch.float64)
    model = model.double()
    _, f = model.energy_and_forces(z, xyz, tops, masks)
    eps = 1e-4
    dx = torch.zeros_like(xyz)
    dx[3, 1] = eps
    with torch.no_grad():
        fd = (model.energy(z, xyz + dx, tops, masks)
              - model.energy(z, xyz - dx, tops, masks)) / (2 * eps)
    np.testing.assert_allclose(-float(f[3, 1]), float(fd), rtol=1e-6)


def test_autopology_trains():
    """One gradient step on an energy-matching loss reduces it."""
    _, (model, tops, masks) = _models(CHAIN, chain_bonds(8), 8)
    z = torch.ones(8, dtype=torch.long)
    xyz = torch.tensor(_chain(), dtype=torch.float32)
    loss = (model.energy(z, xyz, tops, masks) - 1.0) ** 2
    loss.backward()
    l0 = float(loss)
    with torch.no_grad():
        for lr in (1e-6, 1e-7, 1e-8, 1e-9):
            for p in model.parameters():
                p -= lr * p.grad
            if float((model.energy(z, xyz, tops, masks) - 1.0) ** 2) < l0:
                return
            for p in model.parameters():
                p += lr * p.grad
    raise AssertionError(f"no descent from l0={l0}")


def test_nontrainable_prior_returns_constant_params():
    """Zero predictors: the harmonic bond energy is the prior's alone
    (r0 = 1.5, k = 100), up to the trainable offset."""
    mp = {"Fr": 8, "Lh": [8], "bond_terms": ["harmonic"],
          "trainable_prior": False, "n_convolutions": 1}
    n = 6
    model = AuTopology(mp)
    assert not any(n.startswith("nets.") for n, _ in
                   model.named_parameters())
    tops, masks = model.prepare_topologies(generate_topologies(
        chain_bonds(n), n), device="cpu")
    z = torch.ones(n, dtype=torch.long)
    with torch.no_grad():
        u = float(model.energy(z, torch.tensor(straight_chain(n, 1.2)[0],
                                               dtype=torch.float32),
                               tops, masks))
        u0 = float(model.energy(z, torch.tensor(straight_chain(n, 1.5)[0],
                                                dtype=torch.float32),
                                tops, masks))
    np.testing.assert_allclose(u - u0, (n - 1) * 50.0 * (1.2 - 1.5) ** 2,
                               rtol=1e-4)


def test_prepare_topologies_defaults_to_the_card():
    """Without ``device`` the topologies go to the card; with no card the
    call raises rather than fall back to the CPU."""
    top = generate_topologies(chain_bonds(4), 4)
    if torch.cuda.is_available():
        tops, masks = AuTopology.prepare_topologies(top)
        assert all(t.is_cuda for t in (*tops.values(), *masks.values()))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AuTopology.prepare_topologies(top)


SA = {"schnet_params": {"n_atom_basis": 16, "n_filters": 16,
                        "n_gaussians": 8, "n_convolutions": 1,
                        "cutoff": 3.0},
      "autopology_params": {"Fr": 16, "Lh": [16], "bond_terms": ["harmonic"],
                            "n_convolutions": 1, "trainable_prior": True},
      "sorted_result_keys": ["energy_0", "energy_1"], "sort_results": True}


def test_schnet_autopology_staged_matches_jax():
    """AuTopology alone, then the transfer to SchNet: per-state energies
    (sorted) and per-state forces equal JAX's at both stages; the
    transfer freezes the AuTopology's parameters."""
    n = 8
    xyz = _chain()
    bonds = chain_bonds(n)
    model_j = SAJ(SA)
    tops_j, masks_j = AuTopologyJ.prepare_topologies(gen_top_j(bonds, n))
    z = jnp.ones(n, dtype=jnp.int32)
    params = model_j.init_params(z, tops_j, masks_j)
    cell = np.diag([100.0] * 3)
    xj = jnp.asarray(xyz, jnp.float32)
    nbrs = topology_j.generate_nbr_list(xj, 3.0, cell, 64)
    off = nbrs.offsets @ jnp.asarray(cell)
    model = SchNetAuTopology(SA)
    model.load_state_dict(schnet_autopology_params_from_numpy(
        _tree(params)))
    tops, masks = AuTopology.prepare_topologies(
        generate_topologies(bonds, n), device="cpu")
    args = (torch.ones(n, dtype=torch.long),
            torch.tensor(xyz, dtype=torch.float32),
            torch.tensor(np.asarray(nbrs.idx)),
            torch.tensor(np.asarray(off)), torch.tensor(np.asarray(
                nbrs.mask)), tops, masks)
    assert model.trainable_labels() == model_j.trainable_labels() == {
        "schnet": "frozen", "autopology": "train"}
    results = []
    for stage in range(2):
        if stage == 1:
            labels = model.transfer_to_schnet()
            assert labels == model_j.transfer_to_schnet() == {
                "schnet": "train", "autopology": "frozen"}
            assert not any(p.requires_grad
                           for p in model.autopology.parameters())
            assert all(p.requires_grad for p in model.schnet.parameters())
        e_ref, f_ref = jax.jit(model_j.energies_and_forces)(
            params, z, xj, nbrs.idx, off, nbrs.mask, tops_j, masks_j)
        e, f = model.energies_and_forces(*args)
        assert e.shape == (2,) and f.shape == (2, n, 3)
        assert float(e[0]) <= float(e[1])
        np.testing.assert_allclose(e.detach().numpy(), np.asarray(e_ref),
                                   rtol=2e-6)
        f_ref = np.asarray(f_ref)
        np.testing.assert_allclose(f.detach().numpy(), f_ref, rtol=0,
                                   atol=1e-5 * np.abs(f_ref).max())
        results.append(e.detach().numpy())
    assert not np.allclose(results[0], results[1])   # SchNet added
