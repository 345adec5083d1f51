"""The rest of the GNN's edge handling in the port against the JAX package:
``trainable_gauss``, triclinic cells with stored offsets, the ``'topk'``
(directed) and ``'sparse'`` (i < j) edge lists, ``count_pairs`` and the
edge list's capacity, ``grow_capacity`` on the edge list, the port's
mirrors of tests/test_schnet.py's finite-difference and padding tests,
and gradcheck through the aggregation's ``split`` flag in f64.

The systems: tests/test_schnet.py's 32-atom FCC box at a = 2.9 (cutoff
2.5 under half the box), displaced by 0.08 from a numpy seed, and the
same lattice in a triclinic cell (rows (5.8, 0, 0), (0.9, 5.8, 0),
(0.5, 0.4, 5.8)); SchNet 32/32/16, 2 convolutions, cutoff 2.5, weights
from the JAX init through ``nn/convert.py``.  The JAX side runs
``gather_mode='gather'`` (exact f32) on the table; the edge lists take
``segment_sum`` there and ``index_add`` here.  Single evaluations are
compared in f32: energies to rtol 1e-5, forces to 1e-4 of the largest.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import topology as topology_j
from mdgrad_tpu.interface import GNNPotentials as GNNPotentialsJ
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import topology
from mdgrad_tpu_torch.nn.convert import schnet_params_from_numpy
from mdgrad_tpu_torch.ops import gather as tg

PARAMS = {"n_atom_basis": 32, "n_filters": 32, "n_gaussians": 16,
          "n_convolutions": 2, "cutoff": 2.5}
CUTOFF = 2.5
TRICLINIC = np.array([[5.8, 0.0, 0.0], [0.9, 5.8, 0.0], [0.5, 0.4, 5.8]])
CELLS = ("diagonal", "triclinic")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(cls, cell="diagonal"):
    """(system, displaced f32 positions) on the FCC lattice at a = 2.9,
    in a diagonal or a triclinic cell."""
    s = SystemJ.from_lattice("fcc", 2, 2.9)
    frac = s.get_positions() @ np.linalg.inv(s.get_cell())
    box = s.get_cell() if cell == "diagonal" else TRICLINIC
    rng = np.random.default_rng(7)
    xyz = (frac @ box + 0.08 * rng.standard_normal((32, 3))).astype(
        np.float32)
    return cls(frac @ box, box), xyz


def _pair(cell="diagonal", nbr_mode="table", trainable_gauss=False,
          **kw):
    """(JAX interaction, its params, port interaction with those weights,
    positions)."""
    params = {**PARAMS, "trainable_gauss": trainable_gauss}
    sj, xyz = _system(SystemJ, cell)
    inter_j = GNNPotentialsJ(sj, SchNetJ({**params, "gather_mode": "gather"}),
                             cutoff=CUTOFF, nbr_mode=nbr_mode, **kw)
    p = inter_j.init_params()
    s, _ = _system(mt.System, cell)
    inter = mt.GNNPotentials(s, mt.SchNet(params), cutoff=CUTOFF,
                             nbr_mode=nbr_mode, device="cpu", **kw)
    inter.gnn.load_state_dict(schnet_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p)))
    return inter_j, p, inter, xyz


def _energy_forces_j(inter_j, p, xyz):
    x = jnp.asarray(xyz)
    u, g = jax.value_and_grad(inter_j.energy, argnums=1)(p, x,
                                                         inter_j.aux_init(x))
    return float(u), -np.asarray(g)


def _energy_forces(inter, xyz):
    x = torch.tensor(xyz, requires_grad=True)
    u = inter.energy(x, inter.aux_init(x))
    (g,) = torch.autograd.grad(u, x)
    return u.item(), -g.numpy()


def _assert_close(port, ref):
    (u, f), (u_j, f_j) = port, ref
    np.testing.assert_allclose(u, u_j, rtol=1e-5)
    np.testing.assert_allclose(f, f_j, atol=1e-4 * np.abs(f_j).max())


def _edge_set(idx, mask, offsets):
    """{(i, j, offset)} of the real rows of an edge list."""
    idx, mask = np.asarray(idx), np.asarray(mask)
    off = np.rint(np.asarray(offsets)).astype(int)
    return {(int(i), int(j), tuple(o))
            for (i, j), o, m in zip(idx, off, mask) if m}


def _table_set(table, mask, offsets):
    """{(i, j, offset)} of the real slots of an (N, K) table."""
    table, mask = np.asarray(table), np.asarray(mask)
    off = np.rint(np.asarray(offsets)).astype(int)
    return {(i, int(table[i, s]), tuple(off[i, s]))
            for i in range(table.shape[0]) for s in range(table.shape[1])
            if mask[i, s]}


def test_trainable_gauss_gradients_match_jax():
    """``trainable_gauss``: the centres and widths are parameters that
    ``convert.py`` carries across; the energy, the forces, and the
    gradient of a force loss (sum of F^2, the fit's grad-of-grad) in every
    parameter, ``gauss_offsets`` and ``gauss_widths`` included, against
    JAX (each to 1e-4 of its largest entry; measured ~1e-6)."""
    inter_j, p, inter, xyz = _pair(trainable_gauss=True)
    conv = inter.gnn.convs[0]
    assert isinstance(conv.offsets, torch.nn.Parameter)
    assert isinstance(conv.widths, torch.nn.Parameter)
    np.testing.assert_array_equal(
        conv.offsets.detach().numpy(),
        np.asarray(p["SchNetConv_0"]["gauss_offsets"]))
    _assert_close(_energy_forces(inter, xyz),
                  _energy_forces_j(inter_j, p, xyz))
    x = jnp.asarray(xyz)
    aux_j = inter_j.aux_init(x)

    def loss_j(params):
        f = jax.grad(inter_j.energy, argnums=1)(params, x, aux_j)
        return (f ** 2).sum()

    grads_j = schnet_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss_j)(p)))
    xt = torch.tensor(xyz, requires_grad=True)
    u = inter.energy(xt, inter.aux_init(xt))
    (g,) = torch.autograd.grad(u, xt, create_graph=True)
    params = dict(inter.gnn.named_parameters())
    grads = torch.autograd.grad((g ** 2).sum(), list(params.values()),
                                allow_unused=True, materialize_grads=True)
    assert {"convs.0.offsets", "convs.1.widths"} <= params.keys()
    assert params.keys() == grads_j.keys()
    for (name, _), got in zip(params.items(), grads):
        ref = grads_j[name]
        scale = ref.abs().max().item()
        # the readout's last bias does not move the forces: 0 on both sides
        assert scale > 0 or name == "readouts.energy.d1.bias", name
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * max(scale, 1e-30), msg=name)


def test_triclinic_table_matches_jax():
    """A triclinic cell: the table stores each edge's fractional offsets
    (``store_offsets``); its (i, j, offset) sets equal JAX's, and energy
    and forces through the offsets in real space (full f32) match."""
    inter_j, p, inter, xyz = _pair("triclinic")
    assert inter.store_offsets and inter_j.store_offsets
    assert inter.k_max == inter_j.k_max
    aux_j = inter_j.aux_init(jnp.asarray(xyz))
    aux = inter.aux_init(torch.tensor(xyz))
    assert aux.offsets.shape == (32, inter.k_max, 3)
    got = _table_set(aux.table, aux.mask, aux.offsets)
    assert len(got) > 0 and any(o != (0, 0, 0) for _, _, o in got)
    assert got == _table_set(aux_j.table, aux_j.mask, aux_j.offsets)
    assert not bool(aux.overflow) and not bool(aux.drift)
    _assert_close(_energy_forces(inter, xyz),
                  _energy_forces_j(inter_j, p, xyz))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("nbr_mode", ["topk", "sparse"])
def test_edge_lists_match_jax(nbr_mode, cell):
    """The directed top-k list (``'topk'``) and the (i < j) list
    (``'sparse'``): the same k_max or capacity, the same edges with the
    same offsets (as sets), the same count and flags, and the same energy
    and forces."""
    inter_j, p, inter, xyz = _pair(cell, nbr_mode)
    if nbr_mode == "topk":
        assert inter.k_max == inter_j.k_max
    else:
        assert inter.capacity == inter_j.capacity
    aux_j = inter_j.aux_init(jnp.asarray(xyz))
    aux = inter.aux_init(torch.tensor(xyz))
    assert aux.idx.shape == tuple(aux_j.idx.shape)
    assert aux.idx.dtype == torch.int32
    got = _edge_set(aux.idx, aux.mask, aux.offsets)
    assert got == _edge_set(aux_j.idx, aux_j.mask, aux_j.offsets)
    assert int(aux.count) == int(aux_j.count) == len(got) > 0
    assert bool(aux.overflow) == bool(aux_j.overflow) is False
    assert bool(aux.drift) == bool(aux_j.drift) is False
    if nbr_mode == "topk":   # each edge in both directions
        assert got == {(j, i, tuple(-np.asarray(o))) for i, j, o in got}
    else:
        assert all(i < j for i, j, _ in got)
    _assert_close(_energy_forces(inter, xyz),
                  _energy_forces_j(inter_j, p, xyz))


@pytest.mark.parametrize("cell", CELLS)
def test_count_pairs_and_capacity_match_jax(cell):
    """``count_pairs``, ``max_neighbors`` and ``estimate_capacity`` (the
    edge list's default capacity, rounded up to 128) against JAX."""
    _, xyz = _system(mt.System, cell)
    box = TRICLINIC if cell == "triclinic" else np.diag([5.8] * 3)
    cell_t = torch.tensor(box if cell == "triclinic" else np.diag(box),
                          dtype=torch.float32)
    for cutoff in (2.0, 2.5):
        n_j = topology_j.count_pairs(jnp.asarray(xyz), cutoff, box)
        assert topology.count_pairs(torch.tensor(xyz), cutoff,
                                    cell_t) == n_j > 0
        for slack in (1.0, 1.35, 2.0):
            assert topology.estimate_capacity(
                torch.tensor(xyz), cutoff, cell_t, slack=slack) == \
                topology_j.estimate_capacity(jnp.asarray(xyz), cutoff, box,
                                             slack=slack)


def test_edge_list_grow_capacity_matches_jax():
    """``grow_capacity`` on the (i < j) list: a capacity below the pair
    count overflows; each growth multiplies it by the factor (capped at
    N (N - 1) / 2) as in JAX, until the rebuilt list holds every pair and
    gives the energy of a list built wide enough at once."""
    inter_j, p, inter, xyz = _pair(nbr_mode="sparse", capacity=40)
    x = torch.tensor(xyz)
    assert bool(inter.aux_init(x).overflow)
    caps = []
    while bool(inter.aux_init(x).overflow):
        assert inter.grow_capacity(1.5) and inter_j.grow_capacity(1.5)
        caps.append(inter.capacity)
        assert inter.capacity == inter_j.capacity
    assert caps[0] == 60 and len(caps) > 1
    aux = inter.aux_init(x)
    assert int(aux.count) <= inter.capacity and not bool(aux.overflow)
    _, _, wide, _ = _pair(nbr_mode="sparse", capacity=4096)
    wide.gnn.load_state_dict(inter.gnn.state_dict())
    np.testing.assert_allclose(inter.energy(x, aux).item(),
                               wide.energy(x, wide.aux_init(x)).item(),
                               rtol=1e-6)
    # the cap: N (N - 1) / 2 pairs, then no more growth
    inter.capacity = 32 * 31 // 2 - 1
    assert inter.grow_capacity(1.5) and inter.capacity == 32 * 31 // 2
    assert not inter.grow_capacity(1.5)


@pytest.mark.parametrize("nbr_mode", ["table", "topk", "sparse"])
def test_schnet_forces_match_finite_difference(nbr_mode):
    """Mirror of tests/test_schnet.py's test on the port: autograd forces
    against central differences of the energy (eps 1e-3) at two
    coordinates, in each neighbor mode.  In float64 (the model after
    ``.double()``), to rtol 1e-3 (measured 1.4e-4, the difference's own
    truncation): in f32 the energy's rounding (|U| ~ 17, an ulp ~ 2e-6)
    puts ~1e-3 of noise on each difference quotient, more than 5% of the
    smaller force component here."""
    s, xyz = _system(mt.System)
    inter = mt.GNNPotentials(s, mt.SchNet(PARAMS), cutoff=CUTOFF,
                             nbr_mode=nbr_mode, device="cpu").double()
    x = torch.tensor(xyz, dtype=torch.float64, requires_grad=True)
    aux = inter.aux_init(x)
    (g,) = torch.autograd.grad(inter.energy(x, aux), x)
    eps = 1e-3
    for i, d in [(0, 0), (5, 2)]:
        dx = torch.zeros_like(x)
        dx[i, d] = eps
        with torch.no_grad():
            fd = (inter.energy(x + dx, aux).item()
                  - inter.energy(x - dx, aux).item()) / (2 * eps)
        np.testing.assert_allclose(g[i, d].item(), fd, rtol=1e-3)


@pytest.mark.parametrize("nbr_mode,small,large", [
    ("table", {"k_max": 24}, {"k_max": 32}),
    ("topk", {"k_max": 24}, {"k_max": 32}),
    ("sparse", {"capacity": 512}, {"capacity": 1024})])
def test_schnet_padding_invariance(nbr_mode, small, large):
    """Mirror of tests/test_schnet.py's test on the port: the energy does
    not depend on the padding (k_max or capacity) to rtol 1e-6."""
    s, xyz = _system(mt.System)
    gnn = mt.SchNet(PARAMS)
    a = mt.GNNPotentials(s, gnn, cutoff=CUTOFF, nbr_mode=nbr_mode,
                         device="cpu", **small)
    b = mt.GNNPotentials(s, gnn, cutoff=CUTOFF, nbr_mode=nbr_mode,
                         device="cpu", **large)
    x = torch.tensor(xyz)
    aux_a, aux_b = a.aux_init(x), b.aux_init(x)
    assert not bool(aux_a.overflow)
    np.testing.assert_allclose(a.energy(x, aux_a).item(),
                               b.energy(x, aux_b).item(), rtol=1e-6)


def test_gradcheck_through_the_split_flag_f64():
    """gradcheck and gradgradcheck in f64 through the plain versions and
    the autograd Functions with ``split=True`` passed explicitly; with
    ``split=False`` (which rounds to bf16, so finite differences do not
    apply) each vjp is checked as the exact transpose on bf16-exact
    inputs: <gather(v), g> = <v, scatter(g)> and the K1 vjp's two
    products, in f64 to 1e-6 (the f32 sums)."""
    rng = np.random.default_rng(1)
    n, f, k, no = 7, 3, 4, 5
    idx = torch.tensor(rng.integers(0, n + 2, size=no * k), dtype=torch.int32)
    index = tg.TableIndex(idx, n)
    v = torch.tensor(rng.normal(size=(n, f)), requires_grad=True)
    w = torch.tensor(rng.normal(size=(no * k, f)), requires_grad=True)
    g = torch.tensor(rng.normal(size=(no * k, f)), requires_grad=True)
    cases = [
        (lambda a, b: tg.gather_mul_reduce_plain(a, b, idx, k, True), (v, w)),
        (lambda a: tg.table_gather_plain(a, idx, True), (v,)),
        (lambda a: tg.table_scatter_plain(a, idx, n, True), (g,)),
        (lambda a, b: tg.gather_mul_reduce(a, b, index, k, True), (v, w)),
        (lambda a: tg.table_gather(a, index, True), (v,)),
        (lambda a: tg.table_scatter(a, index, True), (g,)),
    ]
    for fn, args in cases:
        assert torch.autograd.gradcheck(fn, args)
        assert torch.autograd.gradgradcheck(fn, args)

    def bf16_exact(shape):
        t = torch.tensor(rng.normal(size=shape)).to(torch.bfloat16)
        return t.double().requires_grad_()

    vb, wb, gb = bf16_exact((n, f)), bf16_exact((no * k, f)), \
        bf16_exact((no * k, f))
    ct = bf16_exact((no, f)).detach()
    gathered = tg.table_gather(vb, index, False)
    assert gathered.dtype == torch.float64
    (dv,) = torch.autograd.grad(gathered, vb, gb)
    lhs = (gathered * gb).sum()
    torch.testing.assert_close(lhs, (vb * tg.table_scatter(
        gb, index, False)).sum(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dv, tg.table_scatter(gb.detach(), index,
                                                    False))
    out = tg.gather_mul_reduce(vb, wb, index, k, False)
    dvk, dwk = torch.autograd.grad(out, (vb, wb), ct)
    ct_e = ct.repeat_interleave(k, dim=0)
    torch.testing.assert_close(dwk, tg.table_gather_plain(
        vb.detach(), idx, False) * ct_e, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dvk, tg.table_scatter_plain(
        wb.detach() * ct_e, idx, n, False), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close((out * ct).sum(), (dwk * wb).sum(),
                               rtol=1e-6, atol=1e-6)
