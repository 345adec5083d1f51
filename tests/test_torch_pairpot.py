"""The port's pair interactions and what stands on them against the JAX
package: ``PairPotentials`` in modes 'dense', 'table' and 'sparse'
(mdgrad_tpu_torch/interface.py), ``TPairPotentials``, ``grow_capacity``,
the dynamic ``cell=`` override of the interaction contract,
``topology.compute_dis``, ``thermo`` (the virial pressure),
``observables.vacf``, ``lattice.square_lattice_2d``, and the pallas RDF's
refusal of a triclinic cell.

Systems: a 108-atom FCC LJ box (a = 1.679, cutoff 2.5) on its lattice and
perturbed by numpy noise from a seed.  Single evaluations in float32 within
1e-5 of max(|ref|, 1); the pressure and its parameter gradient in float64
on both sides (``jax.enable_x64``), each bound stated.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdgrad_tpu as mj
from mdgrad_tpu import lattice as lattice_j
from mdgrad_tpu import thermo as thermo_j
from mdgrad_tpu import topology as topology_j
from mdgrad_tpu.nn import PairMLP as PairMLPJ
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.nn import TPairMLP as TPairMLPJ
from mdgrad_tpu.observables import vacf as vacf_j
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import lattice, thermo, topology
from mdgrad_tpu_torch.nn import PairMLP, SchNet, TPairMLP
from mdgrad_tpu_torch.nn.convert import (pair_mlp_params_from_numpy,
                                         schnet_params_from_numpy,
                                         stack_params_from_numpy)
from mdgrad_tpu_torch.observables import vacf

TOL = 1e-5
MODES = ("dense", "table", "sparse")


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref,
                                                             dtype=np.float64)
    scale = max(np.abs(ref).max(), 1.0)
    err = np.abs(got - ref).max()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol * scale:.3e}"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _systems(perturbed):
    s = mt.System.from_lattice("fcc", 3, 1.679)
    sj = mj.System.from_lattice("fcc", 3, 1.679)
    if perturbed:
        noise = np.random.default_rng(0).normal(0.0, 0.06, (108, 3))
        s.set_positions(s.get_positions() + noise)
        sj.set_positions(np.asarray(sj.get_positions()) + noise)
    return s, sj


def _energy_forces(inter, xyz, cell=None):
    x = torch.tensor(xyz, requires_grad=True)
    kw = {} if cell is None else {"cell": cell}
    e = inter.energy(x, inter.aux_init(x.detach(), **kw), **kw)
    (g,) = torch.autograd.grad(e, x)
    return e.item(), -g.numpy()


def _energy_forces_j(inter, params, xyz):
    x = jnp.asarray(xyz)
    aux = inter.aux_init(x)
    e, g = jax.value_and_grad(lambda q: inter.energy(params, q, aux))(x)
    return float(e), -np.asarray(g)


@pytest.mark.parametrize("perturbed", [False, True],
                         ids=["lattice", "perturbed"])
def test_pair_modes_match_each_other_and_jax(perturbed):
    """LJ energy and forces in each mode: the port's three modes agree,
    and each matches the JAX package's same mode; the table's k_max and
    the list's capacity are the JAX package's."""
    s, sj = _systems(perturbed)
    xyz = s.get_positions().astype(np.float32)
    out = {}
    for mode in MODES:
        inter = mt.PairPotentials(s, mt.potentials.LennardJones(0.9, 1.0),
                                  cutoff=2.5, mode=mode, device="cpu")
        inter_j = mj.PairPotentials(sj, mj.potentials.LennardJones(0.9, 1.0),
                                    cutoff=2.5, mode=mode)
        e, f = _energy_forces(inter, xyz)
        e_j, f_j = _energy_forces_j(inter_j, inter_j.init_params(), xyz)
        _close(e, e_j, f"{mode} energy")
        _close(f, f_j, f"{mode} forces")
        if mode == "table":
            assert inter.k_max == inter_j.k_max
        if mode == "sparse":
            assert inter.capacity == inter_j.capacity
        out[mode] = (e, f)
    for mode in MODES[1:]:
        _close(out[mode][0], out["dense"][0], f"{mode} vs dense energy")
        _close(out[mode][1], out["dense"][1], f"{mode} vs dense forces")


def test_pair_mlp_table_matches_jax():
    """A PairMLP with JAX weights under the table: energy, forces and the
    energy's gradient in the MLP's parameters."""
    s, sj = _systems(True)
    net_j = PairMLPJ(n_gauss=25, r_start=0.0, r_end=2.5, n_layers=2,
                     n_width=32, nonlinear="SELU")
    inter_j = mj.PairPotentials(sj, net_j, cutoff=2.5, mode="table")
    p = net_j.init_params(jax.random.PRNGKey(1))
    net = PairMLP(25, 0.0, 2.5, 2, 32, device="cpu")
    net.load_state_dict(pair_mlp_params_from_numpy(_np(p)))
    inter = mt.PairPotentials(s, net, cutoff=2.5, mode="table", device="cpu")
    xyz = s.get_positions().astype(np.float32)
    e, f = _energy_forces(inter, xyz)
    e_j, f_j = _energy_forces_j(inter_j, p, xyz)
    _close(e, e_j, "energy")
    _close(f, f_j, "forces")
    x = jnp.asarray(xyz)
    aux_j = inter_j.aux_init(x)
    g_j = pair_mlp_params_from_numpy(_np(jax.grad(
        lambda q: inter_j.energy(q, x, aux_j))(p)))
    xt = torch.tensor(xyz)
    inter.energy(xt, inter.aux_init(xt)).backward()
    for k, prm in net.named_parameters():
        _close(prm.grad.numpy(), g_j[k].numpy(), f"d/d{k}")


def test_grow_capacity_matches_jax():
    """grow_capacity in 'table' (k_max x 1.5 rounded to 8, capped at N)
    and 'sparse' (capacity x 1.5, capped at N (N - 1) / 2) as the JAX
    package grows them; the grown structures give the same energy; dense
    has nothing to grow."""
    s, sj = _systems(True)
    xyz = s.get_positions().astype(np.float32)
    e0 = None
    for mode in MODES:
        inter = mt.PairPotentials(s, mt.potentials.LennardJones(0.9, 1.0),
                                  cutoff=2.5, mode=mode, device="cpu")
        inter_j = mj.PairPotentials(sj, mj.potentials.LennardJones(0.9, 1.0),
                                    cutoff=2.5, mode=mode)
        for factor in (1.5, 1.5, 100.0, 2.0):
            grew = inter.grow_capacity(factor)
            assert grew == inter_j.grow_capacity(factor), (mode, factor)
            assert getattr(inter, "k_max", None) == \
                getattr(inter_j, "k_max", None)
            assert getattr(inter, "capacity", None) == \
                getattr(inter_j, "capacity", None)
        assert not inter.grow_capacity(2.0)
        e, _ = _energy_forces(inter, xyz)
        e0 = e if e0 is None else e0
        _close(e, e0, f"{mode} after growing")
    assert inter.capacity == 108 * 107 // 2


def test_tpair_potentials_match_jax_at_two_temperatures():
    """TPairPotentials: u = E - kT S with kT from T (a buffer, not a
    parameter), at 300 K and 900 K, against the JAX package's."""
    s, sj = _systems(True)
    net_j = TPairMLPJ(n_gauss=25, r_start=0.0, r_end=2.5, n_layers=1,
                      n_width=16, nonlinear="ELU")
    p = net_j.init_params(jax.random.PRNGKey(2))
    net = TPairMLP(25, 0.0, 2.5, 1, 16, nonlinear="ELU", device="cpu")
    net.load_state_dict(pair_mlp_params_from_numpy(_np(p)))
    xyz = s.get_positions().astype(np.float32)
    energies = []
    for T in (300.0, 900.0):
        inter = mt.TPairPotentials(s, net, T, cutoff=2.5, mode="table",
                                   device="cpu")
        inter_j = mj.TPairPotentials(sj, net_j, T, cutoff=2.5, mode="table")
        assert "kT" not in dict(inter.named_parameters())
        assert inter.kT.item() == pytest.approx(T * mt.units.kB, rel=1e-12)
        params_j = inter_j.init_params()
        params_j["model"] = p
        e, f = _energy_forces(inter, xyz)
        e_j, f_j = _energy_forces_j(inter_j, params_j, xyz)
        _close(e, e_j, f"energy at {T} K")
        _close(f, f_j, f"forces at {T} K")
        state = stack_params_from_numpy(
            {"nn": _np(params_j)}, mt.Stack({"nn": inter}))
        assert set(state) == {f"models.nn.{k}" for k in
                              inter.state_dict()}
        energies.append(e)
    assert energies[0] != energies[1]


def test_compute_dis_with_padded_rows_matches_jax():
    """compute_dis of an edge list padded past its pairs: the real rows'
    distances and their gradient against JAX, the padded rows at the safe
    distance 1 with a finite (zero) gradient under 1/r^12."""
    s, sj = _systems(True)
    xyz = s.get_positions().astype(np.float32)
    cell = torch.tensor(np.diag(s.get_cell()), dtype=torch.float32)
    x = torch.tensor(xyz, requires_grad=True)
    cap = topology.count_pairs(x.detach(), 1.5, cell) + 37
    nl = topology.generate_nbr_list(x.detach(), 1.5, cell, cap)
    nl_j = topology_j.generate_nbr_list(jnp.asarray(xyz), 1.5,
                                        jnp.asarray(sj.get_cell()), cap)
    np.testing.assert_array_equal(nl.idx.numpy(), np.asarray(nl_j.idx))
    r = topology.compute_dis(x, nl.idx, nl.offsets, cell)
    r_j = topology_j.compute_dis(jnp.asarray(xyz), nl_j.idx, nl_j.offsets,
                                 jnp.asarray(np.diag(sj.get_cell())))
    assert r.shape == (cap, 1)
    _close(r.detach().numpy(), r_j, "distances")
    assert (r[~nl.mask] == 1.0).all() and int((~nl.mask).sum()) == 37
    w = torch.where(nl.mask, r[:, 0] ** -12, torch.zeros_like(r[:, 0]))
    (g,) = torch.autograd.grad(w.sum(), x)
    g_j = jax.grad(lambda q: jnp.where(
        nl_j.mask, topology_j.compute_dis(
            q, nl_j.idx, nl_j.offsets,
            jnp.asarray(np.diag(sj.get_cell())))[:, 0] ** -12, 0.0).sum())(
        jnp.asarray(xyz))
    assert torch.isfinite(g).all()
    _close(g.numpy(), g_j, "gradient")
    # a 3x3 cell gives the same distances
    r3 = topology.compute_dis(x, nl.idx, nl.offsets, torch.diag(cell))
    _close(r3.detach().numpy(), r.detach().numpy(), "3x3 cell")


def _gnn(s, sj):
    mp = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 10,
          "n_convolutions": 1, "cutoff": 2.0}
    gnn_j = SchNetJ(mp)
    inter_j = mj.GNNPotentials(sj, gnn_j, cutoff=2.0)
    params = inter_j.init_params()
    gnn = SchNet(mp)
    gnn.load_state_dict(schnet_params_from_numpy(_np(params)))
    return mt.GNNPotentials(s, gnn, cutoff=2.0, device="cpu"), inter_j, params


@pytest.mark.parametrize("kind", ["dense", "table", "sparse", "gnn"])
def test_cell_override_matches_jax(kind):
    """energy(xyz, aux, cell=L') with aux built at L' equals the JAX
    package's, and its gradient in the (3,) cell lengths too; scaling
    positions and cell together equals the scaled system built afresh."""
    s, sj = _systems(True)
    if kind == "gnn":
        inter, inter_j, params = _gnn(s, sj)
    else:
        inter = mt.PairPotentials(s, mt.potentials.LennardJones(0.9, 1.0),
                                  cutoff=2.5, mode=kind, device="cpu")
        inter_j = mj.PairPotentials(sj, mj.potentials.LennardJones(0.9, 1.0),
                                    cutoff=2.5, mode=kind)
        params = inter_j.init_params()
    xyz = s.get_positions().astype(np.float32)
    lengths = np.diag(s.get_cell()).astype(np.float32) * np.float32(1.02)
    x = torch.tensor(xyz) * 1.02
    c = torch.tensor(lengths, requires_grad=True)
    e = inter.energy(x, inter.aux_init(x, cell=c.detach()), cell=c)
    (gc,) = torch.autograd.grad(e, c)
    xj = jnp.asarray(xyz) * 1.02
    aux_j = inter_j.aux_init(xj, cell=jnp.asarray(lengths))
    e_j, gc_j = jax.value_and_grad(lambda cl: inter_j.energy(
        params, xj, aux_j, cell=cl))(jnp.asarray(lengths))
    _close(e.item(), e_j, f"{kind} energy")
    _close(gc.numpy(), gc_j, f"{kind} d/dcell")
    if kind != "gnn":
        s2 = mt.System(s.get_positions() * 1.02, s.get_cell() * 1.02)
        fresh = mt.PairPotentials(s2, mt.potentials.LennardJones(0.9, 1.0),
                                  cutoff=2.5, mode=kind, device="cpu")
        _close(e.item(), _energy_forces(fresh, x.numpy())[0],
               f"{kind} against the scaled system")


def test_gnn_cell_override_needs_the_table():
    s, sj = _systems(False)
    mp = {"n_atom_basis": 8, "n_filters": 8, "n_gaussians": 8,
          "n_convolutions": 1, "cutoff": 2.0}
    inter = mt.GNNPotentials(s, SchNet(mp), cutoff=2.0, nbr_mode="sparse",
                             device="cpu")
    x = torch.tensor(s.get_positions(), dtype=torch.float32)
    cell = torch.tensor(np.diag(s.get_cell()), dtype=torch.float32)
    with pytest.raises(ValueError, match="nbr_mode='table'"):
        inter.aux_init(x, cell=cell)
    with pytest.raises(ValueError, match="nbr_mode='table'"):
        inter.energy(x, inter.aux_init(x), cell=cell)


def _pressure_stack(s, device="cpu"):
    net = PairMLP(25, 0.0, 2.5, 1, 16, device=device)
    return mt.Stack({
        "nn": mt.PairPotentials(s, net, cutoff=2.5, mode="table",
                                device=device),
        "prior": mt.PairPotentials(s, mt.potentials.LJFamily(
            0.9, 2.0, attr_pow=3, rep_pow=6), cutoff=2.5, device=device)})


def test_pressure_of_a_stack_and_its_gradient_match_jax():
    """thermo.pressure of Stack{PairMLP table, LJ-family dense} with JAX
    weights, and dP/d(MLP parameters), dP/dxyz and dP/dv, in float64 on
    both sides: measured ~1e-15 relative, held to 1e-10; the kinetic
    helpers against JAX too."""
    s, sj = _systems(True)
    rng = np.random.default_rng(4)
    vel = rng.normal(0.0, 1.0, (108, 3))
    masses = np.full(108, 1.3)
    with jax.enable_x64(True):
        net_j = PairMLPJ(n_gauss=25, r_start=0.0, r_end=2.5, n_layers=1,
                         n_width=16, nonlinear="SELU")
        stack_j = mj.Stack({
            "nn": mj.PairPotentials(sj, net_j, cutoff=2.5, mode="table"),
            "prior": mj.PairPotentials(sj, mj.potentials.LJFamily(
                0.9, 2.0, attr_pow=3, rep_pow=6), cutoff=2.5)})
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), stack_j.init_params())
        x = jnp.asarray(s.get_positions())
        v = jnp.asarray(vel)
        aux = stack_j.aux_init(x)

        def p_fn(prm, q, vv):
            return thermo_j.pressure(stack_j, prm, q, aux, vv, masses,
                                     sj.get_cell())

        p_j = float(p_fn(params, x, v))
        g_j = jax.grad(p_fn, argnums=(0, 1, 2))(params, x, v)
        ke_j = float(thermo_j.kinetic_energy(v, masses))
        t_j = float(thermo_j.temperature_kelvin(v, masses))
    stack = _pressure_stack(s).double()
    stack.load_state_dict(stack_params_from_numpy(_np(params), stack))
    xt = torch.tensor(s.get_positions(), requires_grad=True)
    vt = torch.tensor(vel, requires_grad=True)
    p = thermo.pressure(stack, xt, stack.aux_init(xt.detach()), vt, masses,
                        s.get_cell())
    # the last layer's bias drops out of du/dr: its gradient is 0
    grads = torch.autograd.grad(p, [*stack.models["nn"].parameters(), xt,
                                    vt], allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(p.item(), p_j, rtol=1e-10)
    ref = pair_mlp_params_from_numpy(_np(g_j[0]["nn"]))
    names = [k for k, _ in stack.models["nn"].model.named_parameters()]
    for k, g in zip(names, grads):
        _close(g.numpy(), ref[k].numpy(), f"dP/d{k}", 1e-10)
    _close(grads[-2].numpy(), g_j[1], "dP/dxyz", 1e-10)
    _close(grads[-1].numpy(), g_j[2], "dP/dv", 1e-10)
    np.testing.assert_allclose(
        thermo.kinetic_energy(vt, masses).item(), ke_j, rtol=1e-12)
    np.testing.assert_allclose(
        thermo.temperature_kelvin(vt, masses).item(), t_j, rtol=1e-12)
    with torch.no_grad():
        p_ng = thermo.pressure(stack, xt, stack.aux_init(xt), vt, masses,
                               s.get_cell())
    assert not p_ng.requires_grad and p_ng.item() == pytest.approx(
        p.item(), rel=1e-12)


def test_vacf_matches_jax_and_the_loop():
    """vacf against the JAX package's (float32) and against the per-lag
    loop of tests/test_observables.py::test_vacf_matches_loop_reference
    (float64), with a lag past the trajectory's length in the JAX one."""
    s = mt.System(np.zeros((8, 3)), np.diag([10.0] * 3))
    sj = mj.System(np.zeros((8, 3)), np.diag([10.0] * 3))
    v = np.random.default_rng(3).standard_normal((37, 8, 3))
    t_range = 9
    out = vacf(s, t_range)(torch.tensor(v)).numpy()
    ref = [float((v * v).mean())]
    for t in range(1, t_range):
        ref.append(float((v[t:] * v[:-t]).mean()))
    np.testing.assert_allclose(out, ref, rtol=1e-12)
    out32 = vacf(s, t_range)(torch.tensor(v, dtype=torch.float32)).numpy()
    _close(out32, vacf_j(sj, t_range)(jnp.asarray(v, jnp.float32)),
           "float32")
    # the gradient flows into the velocities
    vt = torch.tensor(v, requires_grad=True)
    vacf(s, 5)(vt).sum().backward()
    assert torch.isfinite(vt.grad).all() and vt.grad.abs().sum() > 0


def test_square_lattice_2d_matches_jax():
    for rho, size in ((0.3, 5), (0.9, 25)):
        pos, cell = lattice.square_lattice_2d(rho, size)
        pos_j, cell_j = lattice_j.square_lattice_2d(rho, size)
        np.testing.assert_array_equal(pos, pos_j)
        np.testing.assert_array_equal(cell, cell_j)


def test_pallas_rdf_refuses_a_triclinic_cell():
    """The pallas RDF backend raises on a triclinic cell (the JAX package
    silently takes the diagonal there, a deliberate deviation); the xla
    backend takes it."""
    cell = np.array([[5.0, 0.0, 0.0], [1.0, 5.0, 0.0], [0.0, 0.0, 5.0]])
    s = mt.System(np.random.default_rng(0).uniform(0, 5, (16, 3)), cell)
    with pytest.raises(ValueError, match="diagonal cell"):
        mt.observables.rdf(s, 32, (0.5, 2.0), backend="pallas",
                           device="cpu")
    mt.observables.rdf(s, 32, (0.5, 2.0), backend="xla", device="cpu")


def test_unknown_pair_mode_and_triclinic_table_raise():
    s, _ = _systems(False)
    with pytest.raises(ValueError, match="mode"):
        mt.PairPotentials(s, mt.potentials.LennardJones(), mode="cells",
                          device="cpu")
    cell = np.array([[5.1, 0.0, 0.0], [0.5, 5.1, 0.0], [0.0, 0.0, 5.1]])
    tri = mt.System(np.random.default_rng(0).uniform(0, 5, (16, 3)), cell)
    with pytest.raises(ValueError, match="diagonal"):
        mt.PairPotentials(tri, mt.potentials.LennardJones(), cutoff=2.0,
                          mode="table", device="cpu")
