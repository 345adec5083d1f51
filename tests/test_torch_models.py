"""The port's models of ``nn/models.py``, ``nn/glue.py`` and
``nn/tensorgrad.py`` against the JAX package's (the model tests of
tests/test_md_extras.py, tests/test_supervised.py's edge update and
Hessian tests, and tests/test_autopology.py's glue test, mirrored).

Weights come from the JAX modules' own initialisation, carried across by
``nn/convert.py``.  Single evaluations compare in float32; the Hessians
in float64, the JAX SchNet built with ``compute_dtype=jnp.float64`` and
its Gaussian constants widened (see tests/test_torch_supervised.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdgrad_tpu.nn.schnet as schnet_j
from mdgrad_tpu import topology as topology_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.nn import glue as glue_j
from mdgrad_tpu.nn import models as models_j
from mdgrad_tpu.nn import tensorgrad as tensorgrad_j
from mdgrad_tpu.system import System as SystemJ
from mdgrad_tpu_torch.nn import SchNet, convert, glue, models, tensorgrad

SMALL = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
         "n_convolutions": 2, "cutoff": 2.4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sys108():
    s = SystemJ.from_lattice("fcc", 3, 1.679)
    s.set_temperature(0.8 / units_j.kB, rng=np.random.default_rng(11))
    return s


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _nbrs(sys108, n, cutoff, capacity):
    """Positions of the first ``n`` atoms moved by 0.05 A noise, their JAX
    pair list and real-space offsets, as numpy and as tensors."""
    xyz = np.asarray(sys108.get_positions()[:n]) + 0.05 * \
        np.random.default_rng(1).standard_normal((n, 3))
    nb = topology_j.generate_nbr_list(jnp.asarray(xyz), cutoff,
                                      sys108.get_cell(), capacity)
    off = np.asarray(nb.offsets @ jnp.asarray(sys108.get_cell()))
    assert not np.asarray(nb.mask).all()   # padded rows present
    j = dict(xyz=jnp.asarray(xyz, jnp.float32), idx=nb.idx, mask=nb.mask,
             off=jnp.asarray(off, jnp.float32))
    t = dict(xyz=torch.tensor(xyz, dtype=torch.float32),
             idx=torch.tensor(np.asarray(nb.idx)),
             mask=torch.tensor(np.asarray(nb.mask)),
             off=torch.tensor(off, dtype=torch.float32))
    return j, t


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got.detach()), ref, rtol=0,
                               atol=rel * scale, err_msg=what)


def test_graph_attention_matches_jax(sys108):
    """Output (n, 8) equals JAX's to 1e-6 of its largest entry (f32)."""
    n = 16
    j, t = _nbrs(sys108, n, 2.0, 256)
    r = np.random.default_rng(2).normal(size=(n, 8)).astype(np.float32)
    mod_j = models_j.GraphAttention(n_atom_basis=8)
    p = mod_j.init(jax.random.PRNGKey(0), jnp.ones((n, 8)), j["idx"],
                   j["mask"], n)
    ref = jax.jit(mod_j.apply, static_argnums=4)(p, jnp.asarray(r),
                                                 j["idx"], j["mask"], n)
    mod = models.GraphAttention(8)
    mod.load_state_dict(convert.graph_attention_params_from_numpy(
        _tree(p["params"])))
    out = mod(torch.from_numpy(r), t["idx"], t["mask"], n)
    assert out.shape == (n, 8) and torch.isfinite(out).all()
    _close(out, ref, 1e-6)


def test_edge_update_module_matches_jax():
    mod_j = models_j.SchNetEdgeUpdate(n_atom_basis=8)
    r = np.random.default_rng(3).normal(size=(5, 8)).astype(np.float32)
    idx = np.asarray([[0, 1], [2, 3], [4, 0], [5, 5]], dtype=np.int32)
    mask = np.asarray([True, True, True, False])
    p = mod_j.init(jax.random.PRNGKey(0), jnp.ones((5, 8)), idx, mask)
    ref = mod_j.apply(p, jnp.asarray(r), idx, mask)
    mod = models.SchNetEdgeUpdate(8)
    mod.load_state_dict(convert.edge_update_params_from_numpy(
        _tree(p["params"])))
    e = mod(torch.from_numpy(r), torch.from_numpy(idx),
            torch.from_numpy(mask))
    assert e.shape == (4, 1) and e[3, 0].item() == 0.0
    _close(e, ref, 1e-6)


HYBRID = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "mol_n_convolutions": 1, "mol_cutoff": 3.0,
          "sys_n_convolutions": 2, "sys_cutoff": 2.4, "use_v_ex": True}


def test_hybrid_graph_conv_with_v_ex_matches_jax(sys108):
    """Energy (f32, 2e-6 relative) and forces (1e-5 of the largest) equal
    JAX's; the V_ex sigma gradient is finite (JAX's is NaN when the
    system list holds padded rows: class docstring)."""
    n = 32
    j, t = _nbrs(sys108, n, 2.4, 512)
    mol_idx = np.stack([np.arange(n - 1), np.arange(1, n)], -1).astype(
        np.int32)
    mol_mask = np.ones(n - 1, dtype=bool)
    model_j = models_j.HybridGraphConv(HYBRID)
    z = jnp.ones(n, dtype=jnp.int32)
    p = model_j.init_params(z)
    args_j = (z, j["xyz"], j["idx"], j["off"], j["mask"], jnp.asarray(
        mol_idx), jnp.asarray(mol_mask))
    u_ref, g_ref = jax.jit(jax.value_and_grad(model_j.energy,
                                              argnums=(0, 2)))(p, *args_j)
    assert np.isnan(float(g_ref[0]["v_ex_sigma"]))
    model = models.HybridGraphConv(HYBRID)
    model.load_state_dict(convert.hybrid_params_from_numpy(_tree(p), 2))
    x = t["xyz"].clone().requires_grad_(True)
    u = model.energy(torch.ones(n, dtype=torch.long), x, t["idx"], t["off"],
                     t["mask"], torch.from_numpy(mol_idx),
                     torch.from_numpy(mol_mask))
    np.testing.assert_allclose(float(u), float(u_ref), rtol=2e-6)
    u.backward()
    _close(x.grad, g_ref[1], 1e-5, "forces")
    assert torch.isfinite(model.v_ex_sigma.grad) and \
        float(model.v_ex_sigma.grad) != 0.0


def _table_jax(xyz, sys108, cutoff, k_max=None):
    cell = jnp.asarray(sys108.get_cell())
    k_max = k_max or 12
    return topology_j.generate_neighbor_table(jnp.asarray(xyz), cutoff,
                                              cell, k_max)


@pytest.mark.parametrize("edge_format", ["pairs", "table"])
def test_graph_conv_integration_aggr_weights_match_jax(sys108, edge_format):
    """``aggr_wgt`` scales each atom's node filter before the aggregation
    (the table through the K1 path's plain version): energies at all-ones,
    all-zeros and random weights, the forces and dU/d(aggr_wgt) at the
    random weights equal JAX's (f32: 2e-6 relative, 1e-5 of the largest
    entry); zero weights differ from ones."""
    n = 16
    j, t = _nbrs(sys108, n, 2.4, 256)
    gnn_j = models_j.GraphConvIntegration(SMALL)
    z = jnp.ones(n, dtype=jnp.int32)
    p = gnn_j.init_params(z)
    gnn = models.GraphConvIntegration(SMALL)
    gnn.load_state_dict(convert.schnet_params_from_numpy(
        _tree(p)))
    zt = torch.ones(n, dtype=torch.long)
    cell_len = np.diag(np.asarray(sys108.get_cell())).astype(np.float32)
    if edge_format == "pairs":
        args_j = (j["idx"], j["off"], j["mask"])
        kw_j = {}
        args = (t["idx"], t["mask"])
        kw = {"offsets_real": t["off"], "edge_format": "pairs"}
    else:
        tab = _table_jax(j["xyz"], sys108, 2.4)
        args_j = (tab.table, None, tab.mask)
        kw_j = {"edge_format": "table", "cell_len": jnp.asarray(cell_len)}
        args = (torch.tensor(np.asarray(tab.table)),
                torch.tensor(np.asarray(tab.mask)))
        kw = {"cell_len": torch.from_numpy(cell_len)}
    w_rand = np.random.default_rng(4).uniform(0, 1, n).astype(np.float32)
    us = []
    for w in (np.ones(n, np.float32), np.zeros(n, np.float32), w_rand):
        def e_j(x, a):
            return gnn_j.energy(p, z, x, *args_j, aggr_wgt=a, **kw_j)
        u_ref, (gx_ref, ga_ref) = jax.jit(jax.value_and_grad(
            e_j, argnums=(0, 1)))(j["xyz"], jnp.asarray(w))
        x = t["xyz"].clone().requires_grad_(True)
        a = torch.from_numpy(w).requires_grad_(True)
        u = gnn.energy(zt, x, *args, aggr_wgt=a, **kw)
        np.testing.assert_allclose(float(u), float(u_ref), rtol=2e-6)
        u.backward()
        _close(x.grad, gx_ref, 1e-5, "forces")
        _close(a.grad, ga_ref, 1e-5, "dU/d(aggr_wgt)")
        us.append(float(u))
    assert abs(us[0] - us[1]) > 1e-6
    # no weights at all is the plain SchNet, equal to all-ones
    u_plain = SchNet.energy(gnn, zt, t["xyz"], *args, **kw)
    np.testing.assert_allclose(float(u_plain), us[0], rtol=1e-6)


def _harmonic(x):
    return 0.5 * 4.0 * (x[1, 0] - x[0, 0] - 1.0) ** 2


def test_hessian_utilities():
    """tests/test_supervised.py's 1-D harmonic dimer: one mode at
    sqrt(2k/m); the gradient, Jacobian and Hessian of a test function
    equal jax.grad / jacrev / hessian (f64, 1e-12)."""
    x0 = torch.tensor([[0.0, 0, 0], [1.0, 0, 0]], dtype=torch.float64)
    h = tensorgrad.compute_hess(_harmonic, x0)
    freqs = tensorgrad.vibrational_frequencies(h, np.ones(2))
    np.testing.assert_allclose(float(freqs.max()), np.sqrt(8.0), rtol=1e-5)
    x = np.random.default_rng(5).normal(size=(3, 3))

    def f(v, lib):
        return ((lib.sin(v) * lib.roll(v, 1, 0)).sum()
                + ((v ** 2).sum() + 1) ** 1.5)

    def vec(v, lib):
        return lib.tanh(v @ v.T)

    xt = torch.from_numpy(x)
    with jax.enable_x64(True):
        xj = jnp.asarray(x)
        ref = (tensorgrad_j.compute_grad(lambda v: f(v, jnp), xj),
               tensorgrad_j.compute_jacobian(lambda v: vec(v, jnp), xj),
               tensorgrad_j.compute_hess(lambda v: f(v, jnp), xj))
        freqs_j = tensorgrad_j.vibrational_frequencies(
            ref[2].reshape(3, 3, 3, 3), np.arange(1.0, 4.0))
    got = (tensorgrad.compute_grad(lambda v: f(v, torch), xt),
           tensorgrad.compute_jacobian(lambda v: vec(v, torch), xt),
           tensorgrad.compute_hess(lambda v: f(v, torch), xt))
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(tensorgrad.vibrational_frequencies(
        got[2].reshape(3, 3, 3, 3), np.arange(1.0, 4.0)).numpy(),
        np.asarray(freqs_j), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("edge_format", ["pairs", "table"])
def test_schnet_hessian_matches_jax_hessian_f64(sys108, edge_format,
                                                monkeypatch):
    """``get_schnet_hessians`` (reverse over reverse through the edge
    list's index_add, or the table's K1 / K2a / K2b plain versions)
    equals ``jax.hessian`` of the JAX SchNet in float64 to 1e-7 of its
    largest entry (the JAX model's float32 convolution outputs); it is
    symmetric."""
    orig = schnet_j.gaussian_smearing
    monkeypatch.setattr(
        schnet_j, "gaussian_smearing",
        lambda d, o, w, centered=False: orig(d, o.astype(d.dtype),
                                             w.astype(d.dtype), centered))
    n = 8
    j, t = _nbrs(sys108, n, 2.4, 64)
    cell_len = np.diag(np.asarray(sys108.get_cell()))
    gnn_j = SchNetJ({**SMALL, "compute_dtype": jnp.float64})
    p32 = SchNetJ(SMALL).init_params(jnp.ones(n, dtype=jnp.int32))
    gnn = SchNet(SMALL)
    gnn.load_state_dict(convert.schnet_params_from_numpy(_tree(p32)))
    gnn = gnn.double()
    with jax.enable_x64(True):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   p32)
        z = jnp.ones(n, dtype=jnp.int32)
        xyz = jnp.asarray(np.asarray(j["xyz"]), jnp.float64)
        if edge_format == "pairs":
            args_j = (j["idx"], jnp.asarray(j["off"], jnp.float64),
                      j["mask"])
            kw_j = {}
        else:
            tab = topology_j.generate_neighbor_table(
                xyz, 2.4, jnp.asarray(sys108.get_cell()), 7)
            args_j = (tab.table, None, tab.mask)
            kw_j = {"edge_format": "table",
                    "cell_len": jnp.asarray(cell_len)}
        ref = np.asarray(jax.jit(lambda x: tensorgrad_j.get_schnet_hessians(
            gnn_j, p, z, x, *args_j, **kw_j))(xyz))
    if edge_format == "pairs":
        args = (t["idx"], t["mask"])
        kw = {"offsets_real": t["off"].double(), "edge_format": "pairs"}
    else:
        args = (torch.tensor(np.asarray(tab.table)),
                torch.tensor(np.asarray(tab.mask)))
        kw = {"cell_len": torch.from_numpy(cell_len)}
    h = tensorgrad.get_schnet_hessians(gnn, torch.ones(n, dtype=torch.long),
                                       torch.tensor(np.asarray(xyz)),
                                       *args, **kw)
    assert h.shape == (n, 3, n, 3)
    _close(h, ref, 1e-7)
    hm = h.reshape(3 * n, 3 * n)
    torch.testing.assert_close(hm, hm.T, rtol=0,
                               atol=1e-10 * float(hm.abs().max()))


def test_glue_stack_combines_models():
    """``glue.Stack`` over two SchNets from one JAX Stack's params: sum
    and mean of the members' energies and forces equal JAX's (f32,
    1e-6 relative)."""
    mp = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 1, "cutoff": 3.0}
    stack_j = glue_j.Stack({"a": SchNetJ(mp), "b": SchNetJ(mp)})
    z = np.array([6, 6, 8])
    params = stack_j.init_params(jnp.asarray(z))
    batch = {"z": z[None], "xyz": np.random.default_rng(0).uniform(
        0, 2, (1, 3, 3)).astype(np.float32),
        "nbr_idx": np.array([[[0, 1], [0, 2], [1, 2]]]),
        "offsets": np.zeros((1, 3, 3), np.float32),
        "nbr_mask": np.ones((1, 3), dtype=bool),
        "atom_mask": np.ones((1, 3), dtype=bool)}
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.as_tensor(v) for k, v in batch.items()}
    stack = glue.Stack({"a": SchNet(mp), "b": SchNet(mp)})
    stack.load_state_dict(convert.glue_stack_params_from_numpy(
        _tree(params), stack))
    mean = glue.Stack(dict(stack.models), mode="mean")
    with torch.no_grad():
        got, got_mean = stack.batched_predict(bt), mean.batched_predict(bt)
    ref = jax.jit(stack_j.batched_predict)(params, bj)
    ref_mean = jax.jit(glue_j.Stack(stack_j.models, mode="mean"
                                    ).batched_predict)(params, bj)
    for key in ("energy", "energy_grad"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got_mean[key].numpy(),
                                   np.asarray(ref_mean[key]), rtol=1e-6,
                                   atol=1e-7)
    ea = stack.models["a"].batched_predict(bt)["energy"]
    eb = stack.models["b"].batched_predict(bt)["energy"]
    np.testing.assert_allclose(got["energy"].numpy(),
                               (ea + eb).detach().numpy(), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        glue.Stack({"a": SchNet(mp)}, mode="max")
