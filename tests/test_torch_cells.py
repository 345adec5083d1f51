"""The port's cell list (mdgrad_tpu_torch/ops/cells.py) and
``GNNPotentials(nbr_mode='cells')`` against the JAX package's
(tests/test_cells.py mirrored) and against the port's own dense paths.

The system is tests/test_cells.py's: 5^3 FCC cells at a = 1.679 (500
atoms, a box of 8.395, 3 cells of width >= 2.5 an axis), displaced by
0.05 from a numpy seed.  Single evaluations are compared in float32
(energies to rtol 2e-5, forces to 1e-4 of the largest); the NVE
trajectory and the adjoint gradient in float64, the JAX side inside
``jax.enable_x64(True)``.  Neighbor tables compare as per-row sets: the
top-k of either package may order equal distances its own way.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.interface import GNNPotentials as GNNPotentialsJ
from mdgrad_tpu.md import NVE as NVEJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.ops import cells as cells_j
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import topology, units
from mdgrad_tpu_torch.nn.convert import schnet_params_from_numpy
from mdgrad_tpu_torch.ops import cells

CUT = 2.5
SCHNET = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 2, "cutoff": CUT}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(cls):
    s = cls.from_lattice("fcc", 5, 1.679)
    s.set_temperature(1.0 / units.kB, rng=np.random.default_rng(2))
    rng = np.random.default_rng(4)
    s.positions = s.positions + 0.05 * rng.standard_normal(
        s.positions.shape)
    return s


@pytest.fixture(scope="module")
def systems():
    return _system(SystemJ), _system(mt.System)


def _rows(table, mask, n):
    """Each row's neighbor set, sorted, padded with n."""
    return np.sort(np.where(np.asarray(mask), np.asarray(table), n), axis=1)


def test_grid_and_cell_list_match_jax(systems):
    """The grid (dims, widths, M, the periodic 27-neighborhood) and the
    binning (slots, slot mask, each atom's slot) equal the JAX package's;
    the stable sort keeps each cell's slots in atom order.  A capacity of
    one density-0.01 cell flags overflow in both."""
    sj, s = systems
    xyz = np.asarray(s.get_positions(), dtype=np.float32)
    cell_len = np.diag(s.get_cell())
    density = 500 / float(np.prod(cell_len))
    gj = cells_j.make_cell_grid(cell_len, CUT, density)
    g = cells.make_cell_grid(cell_len, CUT, density, device="cpu")
    assert (g.dims, g.widths, g.M) == (gj.dims, gj.widths, gj.M)
    np.testing.assert_array_equal(g.nbr_cells.numpy(), np.asarray(
        gj.nbr_cells))
    lj = cells_j.build_cell_list(jnp.asarray(xyz),
                                 jnp.asarray(cell_len, jnp.float32), gj)
    lt = cells.build_cell_list(torch.tensor(xyz),
                               torch.tensor(cell_len, dtype=torch.float32), g)
    for field in ("slots", "slot_mask", "slot_of_atom", "overflow"):
        np.testing.assert_array_equal(getattr(lt, field).numpy(),
                                      np.asarray(getattr(lj, field)))
    assert not bool(lt.overflow)
    slots = lt.slots.reshape(-1, g.M).numpy()
    real = np.where(slots < 500, slots, 10 ** 6)
    assert (np.diff(real, axis=1) >= 0).all()     # atom order in a cell
    tiny_j = cells_j.make_cell_grid(cell_len, CUT, density=0.01, slack=1.0)
    tiny = cells.make_cell_grid(cell_len, CUT, density=0.01, slack=1.0,
                                 device="cpu")
    assert bool(cells_j.build_cell_list(jnp.asarray(xyz), cell_len,
                                        tiny_j).overflow)
    assert bool(cells.build_cell_list(torch.tensor(xyz), torch.tensor(
        cell_len, dtype=torch.float32), tiny).overflow)


def test_cell_lj_energy_forces_match_dense_and_jax(systems):
    """``CellLJPair`` energy and analytic forces against the port's dense
    LennardJones path (autograd force) and the JAX ``CellLJPair``."""
    sj, s = systems
    xyz = np.asarray(s.get_positions(), dtype=np.float32)
    inter_j = cells_j.CellLJPair(sj, CUT, sigma=0.9, epsilon=1.0)
    xj = jnp.asarray(xyz)
    aux_j = inter_j.aux_init(xj)
    u_j = float(inter_j.energy(inter_j.init_params(), xj, aux_j))
    f_j = np.asarray(inter_j.force(inter_j.init_params(), xj, aux_j))

    inter = cells.CellLJPair(s, CUT, sigma=0.9, epsilon=1.0, device="cpu")
    x = torch.tensor(xyz)
    aux = inter.aux_init(x)
    u, f = inter.energy_forces(x, aux)
    dense = mt.PairPotentials(s, mt.potentials.LennardJones(0.9, 1.0),
                              cutoff=CUT, mode="dense", device="cpu")
    xr = x.clone().requires_grad_(True)
    u_d = dense.energy(xr, ())
    (g_d,) = torch.autograd.grad(u_d, xr)
    for ref_u, ref_f in ((u_j, f_j), (u_d.item(), -g_d.numpy())):
        np.testing.assert_allclose(u.item(), ref_u, rtol=2e-5)
        np.testing.assert_allclose(f.detach().numpy(), ref_f,
                                   atol=1e-4 * np.abs(ref_f).max())
    # the energy is differentiable too: autograd of it is the force
    xr = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(inter.energy(xr, aux), xr)
    np.testing.assert_allclose(-g.numpy(), f.detach().numpy(),
                               atol=1e-4 * np.abs(f_j).max())


def test_cell_neighbor_table_matches_dense_and_jax(systems):
    """``neighbor_table_from_cells`` gives the dense table's and the JAX
    package's neighbor set in every row, no overflow; a K above the 27 M
    candidates raises in both packages, and an atom with more than K
    neighbors sets the overflow flag."""
    sj, s = systems
    xyz = np.asarray(s.get_positions(), dtype=np.float32)
    n, k_max = 500, 64
    inter_j = cells_j.CellLJPair(sj, CUT)
    xj = jnp.asarray(xyz)
    clist_j = inter_j.aux_init(xj)
    tab_j = cells_j.neighbor_table_from_cells(
        xj, clist_j, inter_j.grid, np.diag(sj.get_cell()), CUT, k_max)
    inter = cells.CellLJPair(s, CUT, device="cpu")
    x = torch.tensor(xyz)
    clist = inter.aux_init(x)
    cell_len = inter.cell_len
    tab = cells.neighbor_table_from_cells(x, clist, inter.grid, cell_len,
                                          CUT, k_max)
    ref = topology.generate_neighbor_table(x, CUT, cell_len, k_max)
    assert not bool(tab.overflow) and not bool(tab.drift)
    got = _rows(tab.table, tab.mask, n)
    np.testing.assert_array_equal(got, _rows(ref.table, ref.mask, n))
    np.testing.assert_array_equal(got, _rows(tab_j.table, tab_j.mask, n))
    assert tab.table.dtype == torch.int32 and tab.offsets == ()
    width = 27 * inter.M
    with pytest.raises(ValueError):
        cells_j.neighbor_table_from_cells(
            xj, clist_j, inter_j.grid, np.diag(sj.get_cell()), CUT,
            width + 1)
    with pytest.raises(ValueError):
        cells.neighbor_table_from_cells(x, clist, inter.grid, cell_len, CUT,
                                        width + 1)
    small = cells.neighbor_table_from_cells(x, clist, inter.grid, cell_len,
                                            CUT, 8)
    small_j = cells_j.neighbor_table_from_cells(
        xj, clist_j, inter_j.grid, np.diag(sj.get_cell()), CUT, 8)
    assert bool(small.overflow) and bool(small_j.overflow)


def test_cell_nve_trajectory_matches_dense_and_jax(systems):
    """Ten NVE steps of ``CellLJPair`` (dt 0.002) against the port's dense
    LennardJones path and the JAX cells path, float64."""
    sj, s = systems
    q0, v0 = s.get_positions().copy(), s.get_velocities().copy()
    with jax.enable_x64(True):
        sj.set_positions(q0)
        sj.set_velocities(v0)
        # the port's parameters are float32: round JAX's alike
        inter_j = cells_j.CellLJPair(sj, CUT, sigma=float(np.float32(0.9)),
                                     epsilon=1.0)
        sim_j = SimulationJ(sj, NVEJ(inter_j, sj, adjoint=False))
        q_j = np.asarray(sim_j.simulate(steps=10, dt=0.002,
                                        frequency=10).q)
        sj.set_positions(q0)
        sj.set_velocities(v0)
    trajs = {}
    for name in ("cells", "dense"):
        s.set_positions(q0)
        s.set_velocities(v0)
        if name == "cells":
            pot = cells.CellLJPair(s, CUT, sigma=0.9, epsilon=1.0,
                                   device="cpu")
        else:
            pot = mt.PairPotentials(s, mt.potentials.LennardJones(0.9, 1.0),
                                    cutoff=CUT, mode="dense", device="cpu")
        integ = mt.NVE(pot.double(), s, adjoint=False, device="cpu",
                       dtype=torch.float64)
        trajs[name] = mt.Simulation(s, integ).simulate(
            steps=10, dt=0.002, frequency=10).q.numpy()
    s.set_positions(q0)
    s.set_velocities(v0)
    assert q_j.dtype == np.float64
    np.testing.assert_allclose(trajs["cells"], q_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(trajs["cells"], trajs["dense"], rtol=0,
                               atol=1e-10)


def _gnn_pair(sj, s, nbr_mode, k_max=64, dtype=torch.float32, **kw):
    """(JAX GNNPotentials, its params, port GNNPotentials with those
    weights); ``gather_mode='gather'`` on the JAX side (exact f32)."""
    inter_j = GNNPotentialsJ(sj, SchNetJ({**SCHNET, "gather_mode": "gather"}),
                             cutoff=CUT, nbr_mode=nbr_mode, k_max=k_max, **kw)
    p = inter_j.init_params()
    inter = mt.GNNPotentials(s, mt.SchNet(SCHNET), cutoff=CUT,
                             nbr_mode=nbr_mode, k_max=k_max, device="cpu",
                             **kw)
    inter.gnn.load_state_dict(schnet_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p)))
    return inter_j, p, inter.to(dtype)


def test_gnn_cells_mode_matches_table_mode_and_jax(systems):
    """``GNNPotentials(nbr_mode='cells')``: the energy and forces equal the
    port's table mode's and JAX's cells mode's; the table's rows equal the
    JAX table's as sets.  'cells' refuses a triclinic cell, ``ex_pairs``
    and the ``cell=`` override, as JAX does."""
    sj, s = systems
    xyz = np.asarray(s.get_positions(), dtype=np.float32)
    inter_j, p, b = _gnn_pair(sj, s, "cells")
    _, _, a = _gnn_pair(sj, s, "table")
    xj = jnp.asarray(xyz)
    aux_j = inter_j.aux_init(xj)
    u_j, g_j = jax.value_and_grad(lambda x: inter_j.energy(
        p, x, inter_j.aux_init(x)))(xj)
    res = {}
    for name, inter in (("cells", b), ("table", a)):
        x = torch.tensor(xyz, requires_grad=True)
        aux = inter.aux_init(x)
        u = inter.energy(x, aux)
        (g,) = torch.autograd.grad(u, x)
        res[name] = (u.item(), g.numpy(), aux)
    np.testing.assert_array_equal(
        _rows(res["cells"][2].table, res["cells"][2].mask, 500),
        _rows(aux_j.table, aux_j.mask, 500))
    for name in ("cells", "table"):
        np.testing.assert_allclose(res[name][0], float(u_j), rtol=2e-5)
        np.testing.assert_allclose(res[name][1], np.asarray(g_j),
                                   atol=1e-4 * np.abs(np.asarray(g_j)).max())
    assert b.k_max == 64
    with pytest.raises(ValueError, match="dynamic cell"):
        b.aux_init(torch.tensor(xyz), cell=torch.tensor(np.diag(
            s.get_cell()), dtype=torch.float32))
    with pytest.raises(ValueError, match="dynamic cell"):
        b.energy(torch.tensor(xyz), res["cells"][2], cell=b.cell)
    with pytest.raises(ValueError, match="ex_pairs"):
        mt.GNNPotentials(s, mt.SchNet(SCHNET), cutoff=CUT, nbr_mode="cells",
                         ex_pairs=np.array([[0, 1]]), device="cpu")
    tri = mt.System(s.get_positions(), np.array(
        [[8.395, 0, 0], [0.5, 8.395, 0], [0, 0, 8.395]]))
    with pytest.raises(ValueError, match="diagonal"):
        mt.GNNPotentials(tri, mt.SchNet(SCHNET), cutoff=CUT,
                         nbr_mode="cells", device="cpu")


def test_gnn_cells_k_max_from_dense_count(systems):
    """Without ``k_max``, 'cells' sizes K from the dense count at
    construction times the slack, rounded up to 8, as JAX does; with the
    Verlet skin the cells and the count take cutoff + skin."""
    sj, s = systems
    for skin in (0.0, 0.2):
        a = GNNPotentialsJ(sj, SchNetJ(SCHNET), cutoff=CUT,
                           nbr_mode="cells", skin=skin)
        b = mt.GNNPotentials(s, mt.SchNet(SCHNET), cutoff=CUT,
                             nbr_mode="cells", skin=skin, device="cpu")
        assert b.k_max == a.k_max
        g = b.cell_grid
        assert (g.dims, g.widths, g.M) == (a._cell_grid.dims,
                                           a._cell_grid.widths,
                                           a._cell_grid.M)


def test_gnn_cells_grow_capacity(systems):
    """``grow_capacity`` grows K (times the factor, rounded up to 8, at
    most N) and the cell capacity M (the slack times the factor) as JAX
    does, and always reports growth; the grown table keeps every row's
    neighbor set."""
    sj, s = systems
    a = GNNPotentialsJ(sj, SchNetJ(SCHNET), cutoff=CUT, nbr_mode="cells",
                       k_max=48)
    b = mt.GNNPotentials(s, mt.SchNet(SCHNET), cutoff=CUT, nbr_mode="cells",
                         k_max=48, device="cpu")
    x = torch.tensor(np.asarray(s.get_positions(), dtype=np.float32))
    assert bool(b.aux_init(x).overflow)           # ~55 neighbors > 48
    assert a.grow_capacity(1.5) and b.grow_capacity(1.5)
    assert b.k_max == a.k_max == 72
    assert b.cell_grid.M == a._cell_grid.M > 32
    after = b.aux_init(x)
    assert after.table.shape == (500, 72) and not bool(after.overflow)
    ref = topology.generate_neighbor_table(x, CUT, b.cell, 72)
    np.testing.assert_array_equal(_rows(after.table, after.mask, 500),
                                  _rows(ref.table, ref.mask, 500))


def test_gnn_cells_adjoint_epoch_grad_matches_jax(systems):
    """tests/test_cells.py's adjoint epoch (NHC, frequency 4, loss
    mean(q[-1]^2)) through a cells-mode GNN: the replay gradient in every
    SchNet parameter equals JAX's ``jax.grad`` through its ``epoch_fn``,
    float64 on both sides (to 2e-5 of each parameter's largest entry: the
    JAX SchNet computes in float32 inside), and equals the port's table
    mode's to 1e-9."""
    sj, s = systems
    grads = {}
    with jax.enable_x64(True):
        inter_j = GNNPotentialsJ(
            sj, SchNetJ({**SCHNET, "n_convolutions": 1,
                         "gather_mode": "gather"}),
            cutoff=CUT, nbr_mode="cells", k_max=64)
        integ_j = NoseHooverChainJ(inter_j, sj, T=1.0 / units_j.kB, Q=50.0,
                                   num_chains=3, adjoint=True)
        sim_j = SimulationJ(sj, integ_j)
        ode_j = sim_j.epoch_fn(0.002, 4)
        state_j, aux_j = sim_j.initial_state()

        def loss_j(params):
            traj, _ = ode_j(params, state_j, aux_j, integ_j.default_ctrl())
            return (traj.q[-1] ** 2).mean()

        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                     sim_j.params)
        g_j = jax.grad(loss_j)(p64)
        p_np = jax.tree_util.tree_map(np.asarray, p64)
        g_np = jax.tree_util.tree_map(np.asarray, g_j)
    ref = schnet_params_from_numpy(g_np)
    for mode in ("cells", "table"):
        inter = mt.GNNPotentials(
            s, mt.SchNet({**SCHNET, "n_convolutions": 1}), cutoff=CUT,
            nbr_mode=mode, k_max=64, device="cpu")
        inter.gnn.load_state_dict(schnet_params_from_numpy(p_np))
        inter.double()
        integ = mt.NoseHooverChain(inter, s, T=1.0 / units.kB, Q=50.0,
                                   num_chains=3, adjoint=True, device="cpu",
                                   dtype=torch.float64)
        sim = mt.Simulation(s, integ)
        state, aux = sim.initial_state()
        traj, _ = sim.epoch_fn(0.002, 4)(state, aux, integ.default_ctrl())
        (traj.q[-1] ** 2).mean().backward()
        grads[mode] = {k: (torch.zeros_like(v) if v.grad is None
                           else v.grad.clone())
                       for k, v in inter.gnn.named_parameters()}
    assert sum(ref[k].abs().max().item() > 0 for k in grads["cells"]) > 4
    for k, g in grads["cells"].items():
        scale = max(ref[k].abs().max().item(), 1e-30)
        # the JAX SchNet computes in float32 even under x64
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), rtol=0,
                                   atol=2e-5 * scale)
        np.testing.assert_allclose(g.numpy(), grads["table"][k].numpy(),
                                   rtol=0, atol=1e-9 * scale)


def test_fit_rdf_cells_one_epoch_matches_table_mode(tmp_path):
    """``fit_rdf`` with ``nbr_mode='cells'``: one epoch on a 500-atom LJ
    box (size 5, the smallest with 3 cells of width 2.5 an axis) gives the
    table mode's loss to roundoff and moves the SchNet."""
    from mdgrad_tpu_torch.train import fit_rdf
    reg = {"ljbig": {"rho": 0.845, "T": 1.2, "start": 0.75, "end": 2.5,
                     "element": "H", "mass": 1.0, "N_unitcell": 4,
                     "cell": "fcc", "reduced_units": True}}
    r = np.linspace(0.75, 2.5, 48)
    fn = tmp_path / "target.csv"
    np.savetxt(fn, np.vstack([r, 1.0 + 0.5 * np.exp(-(r - 1.1) ** 2 / 0.02)]),
               delimiter=",")
    reg["ljbig"]["fn"] = str(fn)
    assignments = {"cutoff": 2.5, "nbins": 48, "opt_freq": 6, "lr": 1e-3,
                   "epsilon": 0.4, "sigma": 0.9, "gaussian_width": 0.5,
                   "n_atom_basis": 16, "n_filters": 16,
                   "n_convolutions": 1}
    out = {}
    for mode in ("cells", "table"):
        sys_params = {"size": 5, "dt": 0.005, "n_epochs": 1, "n_sim": 0,
                      "data": ["ljbig"], "val": None,
                      "anneal_flag": "False", "frame_skip": 5,
                      "test_nbins": 48, "nbr_mode": mode}
        torch.manual_seed(0)
        out[mode] = fit_rdf.fit_rdf(assignments, sys_params, registry=reg,
                                    rng=np.random.default_rng(1),
                                    log=lambda m: None, device="cpu")
    loss_c, loss_t = out["cells"]["loss_log"], out["table"]["loss_log"]
    assert len(loss_c) == 1 and np.isfinite(loss_c[0])
    np.testing.assert_allclose(loss_c, loss_t, rtol=1e-5)
    assert np.isfinite(out["cells"]["objective"])


def test_make_cell_grid_defaults_to_the_card():
    """Without ``device`` the grid's neighbor table goes to the card; with
    no card the call raises rather than fall back to the CPU."""
    cell_len = np.full(3, 8.395)
    if torch.cuda.is_available():
        assert cells.make_cell_grid(cell_len, CUT, 0.1).nbr_cells.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cells.make_cell_grid(cell_len, CUT, 0.1)
