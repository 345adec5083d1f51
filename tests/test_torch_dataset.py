"""The port's supervised data modules (mdgrad_tpu_torch/data/dataset.py,
loader.py, topology.py, sparse.py, crystals.py) against the JAX
package's, mirroring tests/test_supervised.py's data tests and
tests/test_autopology.py's topology tests.

The numpy modules are copies, so the comparisons are exact: the same
datasets, splits, batches (``_idx`` and ``batch_weight`` included, for one
seed) and topologies, and an ``.npz`` written by either package read by
the other.
"""

import os

import numpy as np
import pytest
import torch

from mdgrad_tpu.data import crystals as crystals_j
from mdgrad_tpu.data import dataset as dataset_j
from mdgrad_tpu.data import loader as loader_j
from mdgrad_tpu.data import sparse as sparse_j
from mdgrad_tpu.data import topology as topology_j
from mdgrad_tpu.lattice import face_centered_cubic as fcc_j
from mdgrad_tpu_torch.data import crystals, dataset, loader, sparse, topology
from mdgrad_tpu_torch.lattice import cubic_lattice, straight_chain


def make_lj_dataset(cls, n_geoms=24, n_atoms=8, seed=0):
    """tests/test_supervised.py's toy dataset: LJ cluster energies and
    forces, 8-10 atoms a geometry."""
    rng = np.random.default_rng(seed)
    props = {"nxyz": [], "energy": [], "energy_grad": []}
    for _ in range(n_geoms):
        n = n_atoms + int(rng.integers(0, 3))
        xyz = rng.uniform(0, 3.5, (n, 3))
        for _ in range(20):
            d = xyz[:, None] - xyz[None, :]
            r = np.linalg.norm(d, axis=-1) + np.eye(n)
            if r.min() > 0.8:
                break
            i, j = np.unravel_index(np.argmin(r + np.eye(n) * 10), r.shape)
            xyz[i] += 0.3 * (xyz[i] - xyz[j])
        d = xyz[:, None] - xyz[None, :]
        r = np.linalg.norm(d, axis=-1) + np.eye(n) * 1e9
        u = (4 * ((1 / r) ** 12 - (1 / r) ** 6)).sum() / 2
        du = 4 * (-12 * r ** -13 + 6 * r ** -7)
        f = (du[..., None] * d / r[..., None]).sum(1)
        z = np.ones(n)
        props["nxyz"].append(
            np.concatenate([z[:, None], xyz], axis=1).astype(np.float32))
        props["energy"].append(np.float32(u))
        props["energy_grad"].append(f.astype(np.float32))
    return cls(props, units_name="kcal/mol")


def _same_props(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _same_batches(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_dataset_roundtrip_and_npz_across_packages(tmp_path):
    """The same neighbor lists as JAX, and the .npz of either package read
    by the other (exact)."""
    ds = make_lj_dataset(dataset.Dataset, 6)
    ds_j = make_lj_dataset(dataset_j.Dataset, 6)
    nb, nb_j = ds.generate_neighbor_list(3.0), ds_j.generate_neighbor_list(
        3.0)
    for a, b in zip(nb, nb_j):
        np.testing.assert_array_equal(a, b)
    _same_props(ds.props, ds_j.props)
    port_file = os.path.join(str(tmp_path), "port.npz")
    jax_file = os.path.join(str(tmp_path), "jax.npz")
    ds.save(port_file)
    ds_j.save(jax_file)
    back_j = dataset_j.Dataset.load(port_file)
    back = dataset.Dataset.load(jax_file)
    assert len(back) == len(back_j) == 6
    assert back.units == back_j.units == "kcal/mol"
    _same_props(back.props, back_j.props)
    _same_props(back.props, ds.props)


def test_unit_conversion_matches_jax():
    ds = make_lj_dataset(dataset.Dataset, 3)
    ds_j = make_lj_dataset(dataset_j.Dataset, 3)
    e0 = float(np.asarray(ds.props["energy"][0]))
    ds.to_units("atomic")
    ds_j.to_units("atomic")
    _same_props(ds.props, ds_j.props)
    assert abs(float(np.asarray(ds.props["energy"][0])) - e0 / 627.509) \
        < 1e-6
    ds.to_units("kcal/mol")
    assert abs(float(np.asarray(ds.props["energy"][0])) - e0) < 1e-4
    with pytest.raises(ValueError):
        ds.to_units("eV")


def test_split_outliers_and_concatenate_match_jax():
    ds = make_lj_dataset(dataset.Dataset, 20)
    ds_j = make_lj_dataset(dataset_j.Dataset, 20)
    for d in (ds, ds_j):
        d.props["energy"][0] = np.float32(1e9)
    clean, ids = dataset.remove_outliers(ds, "energy", std_away=2.0)
    clean_j, ids_j = dataset_j.remove_outliers(ds_j, "energy", std_away=2.0)
    np.testing.assert_array_equal(ids, ids_j)
    assert len(clean) < 20 and 0 not in ids
    parts = dataset.split_train_validation_test(clean, 0.25, 0.25)
    parts_j = dataset_j.split_train_validation_test(clean_j, 0.25, 0.25)
    assert sum(map(len, parts)) == len(clean)
    for a, b in zip(parts, parts_j):
        _same_props(a.props, b.props)
    merged = dataset.concatenate_dict(ds.props, {"nxyz": [ds[0]["nxyz"]],
                                                 "energy": 1.0})
    merged_j = dataset_j.concatenate_dict(ds_j.props,
                                          {"nxyz": [ds_j[0]["nxyz"]],
                                           "energy": 1.0})
    assert merged.keys() == merged_j.keys() and len(merged["nxyz"]) == 21
    with pytest.raises(ValueError):
        dataset.Dataset({"energy": [1.0]})


def test_pad_batch_and_loader_equal_jax():
    """Padded shapes, sentinel rows at N_max, the weight-masked last
    batch, and the same batches as JAX for a seed (shuffled and not)."""
    ds = make_lj_dataset(dataset.Dataset, 11)
    ds.generate_neighbor_list(3.0)
    ds_j = make_lj_dataset(dataset_j.Dataset, 11)
    ds_j.generate_neighbor_list(3.0)
    for kw in ({"shuffle": False}, {"seed": 3}):
        batches = list(loader.DataLoader(ds, batch_size=3, **kw))
        _same_batches(batches, list(loader_j.DataLoader(ds_j, batch_size=3,
                                                        **kw)))
    b = batches[0]
    assert b["z"].shape == b["atom_mask"].shape
    n_max = b["z"].shape[1]
    assert (b["nbr_idx"][~b["nbr_mask"]] == n_max).all()
    assert batches[-1]["batch_weight"].sum() == 2
    items = [ds[i] for i in (0, 4, 7)]
    _same_batches([loader.pad_batch(items)],
                  [loader_j.pad_batch([ds_j[i] for i in (0, 4, 7)])])
    with pytest.raises(ValueError):
        loader.pad_batch(items, p_max=1)


def test_prioritized_sampler_and_loader_carry_idx():
    """The sampler's draws equal JAX's, and priority examples dominate."""
    props = {"nxyz": [np.hstack([np.full((4, 1), 3.0),
                                 np.random.default_rng(i).uniform(0, 5,
                                                                  (4, 3))])
                      for i in range(6)],
             "energy": [float(i) for i in range(6)]}
    smp, smp_j = (loader.PrioritizedSampler(6, seed=1),
                  loader_j.PrioritizedSampler(6, seed=1))
    for s in (smp, smp_j):
        s.update_weights([5], [1e6])
    batches = list(loader.DataLoader(dataset.Dataset(props), batch_size=4,
                                     sampler=smp))
    batches_j = list(loader_j.DataLoader(dataset_j.Dataset(props),
                                         batch_size=4, sampler=smp_j))
    _same_batches(batches, batches_j)
    idx = np.concatenate([b["_idx"] for b in batches])
    assert (idx == 5).mean() > 0.9


def chain_bonds(n):
    return np.stack([np.arange(n - 1), np.arange(1, n)], -1)


@pytest.mark.parametrize("bonds,n", [
    (chain_bonds(8), 8), (np.array([[0, 1], [0, 2], [0, 3]]), 4),
    (np.array([[0, 1], [1, 2], [2, 3], [3, 0], [1, 4], [4, 5], [1, 6]]),
     7)], ids=["chain", "star", "ring"])
def test_topologies_equal_jax(bonds, n):
    got = topology.generate_topologies(bonds, n)
    ref = topology_j.generate_topologies(bonds, n)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(
        topology.generate_pairs(bonds, n, exclude_14=False),
        topology_j.generate_pairs(bonds, n, exclude_14=False))


def test_chain_topology_counts():
    n = 8
    bonds = chain_bonds(n)
    assert len(topology.generate_angles(bonds, n)) == n - 2
    assert len(topology.generate_dihedrals(bonds, n)) == n - 3
    assert len(topology.generate_impropers(bonds, n)) == 0
    expected = n * (n - 1) // 2 - (n - 1) - (n - 2) - (n - 3)
    assert len(topology.generate_pairs(bonds, n, exclude_14=True)) == \
        expected


def test_branched_impropers():
    bonds = np.array([[0, 1], [0, 2], [0, 3]])
    imp = topology.generate_impropers(bonds, 4)
    assert len(imp) == 1 and imp[0, 0] == 0
    assert len(topology.generate_angles(bonds, 4)) == 3


def test_bonds_subgraphs_and_unwrap_match_jax():
    xyz1, _ = straight_chain(4, 1.0, origin=(0, 0, 0))
    xyz2, _ = straight_chain(3, 1.0, origin=(10, 10, 10))
    xyz = np.concatenate([xyz1, xyz2])
    bonds = topology.bonds_from_distances(xyz, cutoff=1.2)
    np.testing.assert_array_equal(
        bonds, topology_j.bonds_from_distances(xyz, cutoff=1.2))
    assert len(bonds) == 5
    comps = topology.molecular_subgraphs(bonds, 7)
    assert comps == topology_j.molecular_subgraphs(bonds, 7)
    assert sorted(map(len, comps)) == [3, 4]
    wrapped = np.array([[9.8, 0, 0], [0.2, 0, 0]])
    out = topology.reconstruct_atoms(wrapped, [[0, 1]],
                                     np.array([10.0, 10, 10]))
    np.testing.assert_array_equal(out, topology_j.reconstruct_atoms(
        wrapped, [[0, 1]], np.array([10.0, 10, 10])))
    assert abs(np.linalg.norm(out[0] - out[1]) - 0.4) < 1e-9


def test_covalent_pair_cutoffs():
    xyz = np.array([[0.0, 0, 0], [1.1, 0, 0]])
    assert len(topology.bonds_from_distances(xyz, species=[8, 1])) == 1
    assert len(topology.bonds_from_distances(xyz, species=[1, 1])) == 0
    xyz2 = np.array([[0.0, 0, 0], [0.5, 0, 0]])
    assert len(topology.bonds_from_distances(xyz2, species=[3, 6])) == 0
    assert len(topology.bonds_from_distances(xyz, cutoff=1.8,
                                             species=[26, 26])) == 1
    np.testing.assert_array_equal(
        topology.pair_cutoff_matrix([1, 6, 8, 26]),
        topology_j.pair_cutoff_matrix([1, 6, 8, 26]))


def test_sparse_roundtrip_matches_bcoo():
    a = np.zeros((6, 6), dtype=np.float32)
    a[1, 2] = 3.0
    a[4, 0] = -1.0
    a[5, 5] = 0.01
    for threshold in (0.0, 0.1):
        sp = sparse.sparsify_tensor(a, threshold)
        sp_j = sparse_j.sparsify_tensor(a, threshold)
        dense = sparse.densify(sp)
        assert isinstance(dense, torch.Tensor)
        np.testing.assert_array_equal(dense.numpy(),
                                      np.asarray(sparse_j.densify(sp_j)))
        assert sp._nnz() == (3 if threshold == 0 else 2)
    assert sparse.sparsify_array(a)._nnz() == 3


def test_crystal_graph_matches_jax():
    """The fcc crystal's periodic graph: the same pair count as JAX, each
    pair's minimum-image distance below the cutoff."""
    xyz, cell = cubic_lattice("fcc", 2, 1.679)
    xyz_j, cell_j = fcc_j(2, 1.679)
    np.testing.assert_allclose(xyz, xyz_j)
    nxyz = crystals.dict_to_nxyz({"numbers": np.full(len(xyz), 18),
                                  "positions": xyz})
    np.testing.assert_array_equal(nxyz, crystals_j.dict_to_nxyz(
        {"numbers": np.full(len(xyz), 18), "positions": xyz}))
    assert nxyz.shape == (32, 4)
    nbrs = crystals.get_crystal_graph(nxyz, cell, 1.6, device="cpu")
    nbrs_j = crystals_j.get_crystal_graph(nxyz, cell_j, 1.6)
    assert int(nbrs.count) == int(nbrs_j.count) > 0
    got = {tuple(p) for p in nbrs.idx[nbrs.mask].tolist()}
    ref = {tuple(p) for p in np.asarray(nbrs_j.idx)[np.asarray(
        nbrs_j.mask)].tolist()}
    assert got == ref
    with pytest.raises(ImportError):
        crystals.structure_to_nxyz(None)


def test_crystal_graph_defaults_to_the_card():
    """Without ``device`` the crystal's graph is built on the card; with no
    card the call raises rather than fall back to the CPU."""
    xyz, cell = cubic_lattice("fcc", 2, 1.679)
    nxyz = crystals.dict_to_nxyz({"numbers": np.full(len(xyz), 18),
                                  "positions": xyz})
    if torch.cuda.is_available():
        assert crystals.get_crystal_graph(nxyz, cell, 1.6).idx.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            crystals.get_crystal_graph(nxyz, cell, 1.6)
