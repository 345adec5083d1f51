"""The port's Ewald electrostatics (``ops/ewald.py``,
``EwaldElectrostatics``, the cutoff ``Electrostatics``) against the JAX
package's, and against independent oracles (tests/test_ewald.py and
tests/test_more_interactions.py:18-40 mirrored).

Parity runs in float64: the JAX side inside ``jax.enable_x64(True)``, the
port's modules ``.double()``.  Both packages round the interaction's
charges and cell to float32; the port then computes at the run's dtype,
while the JAX module inverts its float32 cell in float32, so the JAX
side's cell is widened before the comparison, and the energies agree to
roundoff (rtol 1e-10).  The Madelung constants of NaCl and CsCl are
literature values, independent of either package.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import EwaldElectrostatics as EwaldJ
from mdgrad_tpu.interface import Electrostatics as ElectrostaticsJ
from mdgrad_tpu.ops import ewald as ewald_j
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import topology
from mdgrad_tpu_torch.ops import ewald

M_NACL = 1.747564594633  # per ion pair, r0 = a/2
M_CSCL = 1.762674773071  # per ion pair, r0 = a*sqrt(3)/2
TRICLINIC = np.array([[6.0, 0.0, 0.0], [1.2, 5.5, 0.0], [0.7, -0.9, 6.3]])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nacl(cls, a=5.64):
    frac_na = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                        [0, 0.5, 0.5]])
    frac = np.concatenate([frac_na, frac_na + 0.5]) % 1.0
    q = np.array([1.0] * 4 + [-1.0] * 4)
    return cls(frac * a, cell=np.eye(3) * a, numbers=[11] * 4 + [17] * 4), q


def charged_box(cls, n=14, L=7.3, seed=5):
    """Random positions in a cubic box, random charges of net charge
    ~0.7 e, no pair closer than 1 A."""
    rng = np.random.default_rng(seed)
    xyz = []
    while len(xyz) < n:
        p = rng.uniform(0, L, 3)
        if all(np.linalg.norm((p - x) - L * np.round((p - x) / L)) > 1.0
               for x in xyz):
            xyz.append(p)
    q = rng.uniform(-1.0, 1.0, n)
    q[0] += 0.7 - q.sum()
    return cls(np.array(xyz), cell=np.eye(3) * L), q


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("cell", ["cubic", "triclinic"])
def test_build_kvectors_equals_jax(cell):
    """The same integer triples in the same order (integer-equal)."""
    c = np.eye(3) * 7.3 if cell == "cubic" else TRICLINIC
    for k_cut in (2.3, 3.5):
        got = ewald.build_kvectors(c, k_cut).numpy()
        ref = np.asarray(ewald_j.build_kvectors(c, k_cut))
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert got.shape[0] > 10
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cell", ["cubic", "triclinic"])
def test_each_term_matches_jax_f64(cell):
    """reciprocal, real (dense, and over a table), self, background and
    exclusion terms equal JAX's in float64 (rtol 1e-10), on a random
    charged box; the table term is held to the dense one on the cubic
    box."""
    s, q = charged_box(mt.System)
    xyz = s.get_positions()
    c = np.diag(s.get_cell()) if cell == "cubic" else TRICLINIC
    alpha, k_cut = ewald.ewald_params(3.1)
    pairs = np.array([[0, 3], [5, 9]])
    with jax.enable_x64(True):
        nv_j = ewald_j.build_kvectors(c, k_cut)
        qj, xj, cj = jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(c)
        ref = {"recip": ewald_j.reciprocal_energy(qj, xj, cj, nv_j, alpha),
               "real": ewald_j.real_energy(qj, xj, cj, alpha, 3.1),
               "self": ewald_j.self_energy(qj, alpha),
               "background": ewald_j.background_energy(qj, cj, alpha)}
        if cell == "cubic":
            ref["excl"] = ewald_j.exclusion_correction(
                qj, xj, cj, alpha, jnp.asarray(pairs))
        ref = {k: float(v) for k, v in ref.items()}
    nv = ewald.build_kvectors(c, k_cut)
    qt, xt, ct = _t(q), _t(xyz), _t(c)
    got = {"recip": ewald.reciprocal_energy(qt, xt, ct, nv, alpha),
           "real": ewald.real_energy(qt, xt, ct, alpha, 3.1),
           "self": ewald.self_energy(qt, alpha),
           "background": ewald.background_energy(qt, ct, alpha)}
    if cell == "cubic":
        got["excl"] = ewald.exclusion_correction(
            qt, xt, ct, alpha, torch.as_tensor(pairs))
        nbrs = topology.generate_neighbor_table(xt, 3.1, ct, 14)
        np.testing.assert_allclose(
            ewald.real_energy_table(qt, xt, ct, alpha, 3.1, nbrs).item(),
            ref["real"], rtol=1e-10)
    for k, v in ref.items():
        assert v != 0.0
        np.testing.assert_allclose(got[k].item(), v, rtol=1e-10, err_msg=k)


CONFIGS = {"dense": {}, "dense_ex": {"ex_pairs": [(0, 3), (5, 9)]},
           "table": {"mode": "table", "capacity_slack": 2.0},
           "table_ex": {"mode": "table", "capacity_slack": 2.0,
                        "ex_pairs": [(0, 3), (5, 9)]}}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_energy_forces_cell_and_charge_grads_match_jax(config):
    """``EwaldElectrostatics`` (learnable charges) in dense and table
    mode, with and without exclusions: the energy, the forces (autograd
    against ``jax.grad``), dU/d(cell lengths) and dU/d(charges) equal
    JAX's in float64 (rtol 1e-9, forces atol 1e-9 of the largest)."""
    kw = CONFIGS[config]
    sj, q = charged_box(SystemJ)
    xyz = sj.get_positions()
    L = float(sj.get_cell()[0, 0])
    with jax.enable_x64(True):
        inter = EwaldJ(sj, q, learn_charges=True, **kw)
        # the JAX module inverts its float32 cell in float32 (a 5e-8
        # relative error in float64 runs); the port inverts the same
        # rounded cell at the run's dtype, so the JAX side gets it widened
        inter.cell0 = jnp.asarray(inter.cell0, jnp.float64)
        p = {"charges": jnp.asarray(inter.init_params()["charges"],
                                    jnp.float64)}
        xj = jnp.asarray(xyz)
        aux_j = inter.aux_init(xj)
        u_j = float(inter.energy(p, xj, aux_j))
        f_j = -np.asarray(jax.grad(inter.energy, argnums=1)(p, xj, aux_j))
        g_q = np.asarray(jax.grad(inter.energy)(p, xj, aux_j)["charges"])
        g_c = np.asarray(jax.grad(lambda c: inter.energy(
            p, xj, aux_j, cell=c))(jnp.full(3, L)))
    s, _ = charged_box(mt.System)
    port = mt.EwaldElectrostatics(s, q, learn_charges=True, device="cpu",
                                  **kw).double()
    assert port.r_cut == inter.r_cut and port.alpha == inter.alpha
    xt = _t(xyz).requires_grad_(True)
    aux = port.aux_init(xt)
    u = port.energy(xt, aux)
    u.backward()
    np.testing.assert_allclose(u.item(), u_j, rtol=1e-10)
    f = -xt.grad.numpy()
    np.testing.assert_allclose(f, f_j, rtol=0,
                               atol=1e-9 * np.abs(f_j).max())
    np.testing.assert_allclose(port.charges.grad.numpy(), g_q, rtol=1e-9)
    cell = torch.full((3,), L, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(port.energy(_t(xyz), aux, cell=cell), cell)
    assert np.abs(g_c).min() > 1e-3
    np.testing.assert_allclose(g.numpy(), g_c, rtol=1e-9)


def test_triclinic_cell_gradient_matches_jax():
    """dU/d(cell) for a (3, 3) triclinic cell through the inverse and the
    determinant, float64 (rtol 1e-9)."""
    s, q = charged_box(mt.System, n=6, L=6.0)
    xyz = s.get_positions() @ np.linalg.inv(np.eye(3) * 6.0) @ TRICLINIC
    alpha, k_cut = ewald.ewald_params(2.6)
    with jax.enable_x64(True):
        nv_j = ewald_j.build_kvectors(TRICLINIC, k_cut)
        g_j = np.asarray(jax.grad(lambda c: ewald_j.ewald_energy(
            jnp.asarray(q), jnp.asarray(xyz), c, nv_j, alpha, 2.6))(
            jnp.asarray(TRICLINIC)))
    c = _t(TRICLINIC).requires_grad_(True)
    u = ewald.ewald_energy(_t(q), _t(xyz), c,
                           ewald.build_kvectors(TRICLINIC, k_cut), alpha, 2.6)
    (g,) = torch.autograd.grad(u, c)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-9,
                               atol=1e-9 * np.abs(g_j).max())


def test_madelung_constants():
    """Literature Madelung constants (rel 1e-4; the truncation is ~erfc(3.2)
    ~ 6e-6): NaCl's 8-ion cubic cell, CsCl's 2x2x2 supercell and NaCl's
    2-ion rhombohedral primitive cell, in float32 on the CPU."""
    a = 5.64
    s, q = nacl(mt.System, a)
    u = mt.EwaldElectrostatics(s, q, device="cpu").energy(
        torch.tensor(s.get_positions(), dtype=torch.float32), ()).item()
    exp = -4 * M_NACL * ewald.COULOMB / (a / 2)
    assert abs(u - exp) / abs(exp) < 1e-4
    ac = 4.11
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0.5]])
    reps = [(frac + [i, j, k]) / 2 for i in range(2) for j in range(2)
            for k in range(2)]
    sc = mt.System(np.concatenate(reps) * 2 * ac, cell=np.eye(3) * 2 * ac,
                   numbers=[55, 17] * 8)
    u = mt.EwaldElectrostatics(sc, np.tile([1.0, -1.0], 8),
                               device="cpu").energy(
        torch.tensor(sc.get_positions(), dtype=torch.float32), ()).item()
    exp = -8 * M_CSCL * ewald.COULOMB / (ac * np.sqrt(3) / 2)
    assert abs(u - exp) / abs(exp) < 1e-4
    cell = 0.5 * a * np.array([[0.0, 1.0, 1.0], [1.0, 0.0, 1.0],
                               [1.0, 1.0, 0.0]])
    xyz = np.array([[0.0, 0.0, 0.0], [a / 2, a / 2, a / 2]])
    sp = mt.System(xyz, cell=cell, numbers=[11, 17])
    u = mt.EwaldElectrostatics(sp, [1.0, -1.0], device="cpu").energy(
        torch.tensor(xyz, dtype=torch.float32), ()).item()
    exp = -M_NACL * ewald.COULOMB / (a / 2)
    assert abs(u - exp) / abs(exp) < 1e-4


@pytest.mark.parametrize("net", [0.0, 2.0])
def test_alpha_invariance(net):
    """The energy does not depend on the splitting (accuracy 3.0 against
    3.8, rel 1e-3 as tests/test_ewald.py), neutral and with net charge +2
    (the background term), on a perturbed NaCl cell."""
    s, q = nacl(mt.System)
    q = q.copy()
    if net:
        q[4:6] = 1.0
    rng = np.random.default_rng(0)
    xyz = torch.tensor(s.get_positions() + 0.05 * rng.standard_normal((8, 3)),
                       dtype=torch.float64)
    u = [mt.EwaldElectrostatics(s, q, accuracy=acc, device="cpu").double()
         .energy(xyz, ()).item() for acc in (3.0, 3.8)]
    assert abs(u[0] - u[1]) / max(abs(u[0]), 1.0) < 1e-3


def test_table_matches_dense_and_regrows():
    """mode='table' against dense (rel 1e-6 in float64) with exclusions;
    an undersized table (k_max 1 at r_cut 2.85, past NaCl's nearest
    shell) overflows, ``grow_capacity(8)`` clears it and the energy
    matches dense again."""
    s, q = nacl(mt.System)
    xyz = torch.tensor(s.get_positions(), dtype=torch.float64)
    dense = mt.EwaldElectrostatics(s, q, ex_pairs=[(0, 4)],
                                   device="cpu").double()
    table = mt.EwaldElectrostatics(s, q, ex_pairs=[(0, 4)], mode="table",
                                   capacity_slack=2.0, device="cpu").double()
    u_d = dense.energy(xyz, ()).item()
    np.testing.assert_allclose(table.energy(xyz, table.aux_init(xyz)).item(),
                               u_d, rtol=1e-6)
    dense4 = mt.EwaldElectrostatics(s, q, r_cut=2.85, device="cpu").double()
    table4 = mt.EwaldElectrostatics(s, q, r_cut=2.85, mode="table",
                                    capacity_slack=2.0, device="cpu").double()
    table4.k_max = 1
    assert topology.aux_overflow(table4.aux_init(xyz))
    assert table4.grow_capacity(factor=8.0)
    aux = table4.aux_init(xyz)
    assert not topology.aux_overflow(aux)
    np.testing.assert_allclose(table4.energy(xyz, aux).item(),
                               dense4.energy(xyz, ()).item(), rtol=1e-6)
    with pytest.raises(ValueError):
        mt.EwaldElectrostatics(mt.System(xyz.numpy(), cell=TRICLINIC), q,
                               ex_pairs=[(0, 4)], device="cpu")


def test_exclusion_removes_min_image_pair():
    """Excluding (0, 4) removes exactly k_e q0 q4 / r (the minimum
    image): erf and erfc recombine to the bare 1/r (rel 1e-6, f64)."""
    s, q = nacl(mt.System)
    xyz = torch.tensor(s.get_positions(), dtype=torch.float64)
    full = mt.EwaldElectrostatics(s, q, device="cpu").double()
    excl = mt.EwaldElectrostatics(s, q, ex_pairs=[(0, 4)],
                                  device="cpu").double()
    d = s.get_positions()[0] - s.get_positions()[4]
    d = d - 5.64 * np.round(d / 5.64)
    direct = ewald.COULOMB * q[0] * q[4] / np.linalg.norm(d)
    diff = full.energy(xyz, ()).item() - excl.energy(xyz, ()).item()
    np.testing.assert_allclose(diff, direct, rtol=1e-6)


def test_electrostatics_matches_jax_and_distinct_charges():
    """The cutoff Coulomb sum: k_e q1 q2 / r for a +- pair (rel 1e-3 of
    14.3996 / 2), q_i q_j and not q_j^2 (u(2, -1) = -2 u(-1, -1)), and
    JAX's energy and forces in float64 on a random box with an
    ``index_tuple`` and ``ex_pairs`` (rtol 1e-10)."""
    pos = np.array([[5.0, 5, 5], [7.0, 5, 5]])
    s2 = mt.System(pos, np.diag([20.0] * 3))
    x2 = torch.tensor(pos, dtype=torch.float32)
    u = mt.Electrostatics(s2, np.array([1.0, -1.0]), cutoff=5.0,
                          device="cpu").energy(x2, ()).item()
    np.testing.assert_allclose(u, -14.3996 / 2, rtol=1e-3)
    u_pm = mt.Electrostatics(s2, [2.0, -1.0], cutoff=5.0,
                             device="cpu").energy(x2, ()).item()
    u_mm = mt.Electrostatics(s2, [-1.0, -1.0], cutoff=5.0,
                             device="cpu").energy(x2, ()).item()
    assert u_pm < 0 < u_mm
    np.testing.assert_allclose(u_pm, -2 * u_mm, rtol=1e-5)
    sj, q = charged_box(SystemJ)
    kw = dict(cutoff=3.4, index_tuple=(np.arange(9), np.arange(4, 14)),
              ex_pairs=[(4, 5)])
    with jax.enable_x64(True):
        ej = ElectrostaticsJ(sj, q, **kw)
        xj = jnp.asarray(sj.get_positions())
        u_j = float(ej.energy({}, xj, ()))
        f_j = -np.asarray(jax.grad(ej.energy, argnums=1)({}, xj, ()))
    s, _ = charged_box(mt.System)
    xt = torch.tensor(s.get_positions(), dtype=torch.float64,
                      requires_grad=True)
    u = mt.Electrostatics(s, q, device="cpu", **kw).energy(xt, ())
    u.backward()
    np.testing.assert_allclose(u.item(), u_j, rtol=1e-10)
    np.testing.assert_allclose(-xt.grad.numpy(), f_j, rtol=0,
                               atol=1e-10 * np.abs(f_j).max())


def test_scaled_charge_ewald_under_mtk_barostat_matches_jax():
    """tests/test_ewald.py:197-238's setting: the 64-ion melt (n_cells 2,
    a 6.0, 1800 K) under ``NPTMTKNHC`` (P 1e-4, tau 40 fs, tau_p 100 fs,
    3 chains), Stack{ExcludedVolume core, ``ScaledChargeEwald``(0.6)}; the
    mean volume of the last 5 of 20 frames and its d/d(qscale) through
    the replay adjoint equal JAX's in float64 (rtol 1e-8; both start from
    JAX's state, the port's stack loaded with JAX's parameters through
    ``nn/convert.py``).  Stronger cohesion shrinks the box: d/dq < 0."""
    from mdgrad_tpu import potentials as pot_j, units as units_j
    from mdgrad_tpu.interface import PairPotentials as PairJ, Stack as StackJ
    from mdgrad_tpu.md import NPTMTKNHC as MTKJ, Simulation as SimJ
    from mdgrad_tpu.train import fit_salt as fs_j
    from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy
    from mdgrad_tpu_torch.train import fit_salt as fs

    dt = 1.0 * units_j.fs
    with jax.enable_x64(True):
        sj = fs_j.rocksalt_melt(n_cells=2, a=6.0, T_kelvin=1800.0,
                                rng=np.random.default_rng(0))
        pattern = np.where(np.asarray(sj.get_atomic_numbers()) == 11,
                           1.0, -1.0)
        stack_j = StackJ({
            "core": PairJ(sj, pot_j.ExcludedVolume(sigma=2.3, epsilon=0.1,
                                                   power=9), cutoff=5.5),
            "coul": fs_j.ScaledChargeEwald(sj, pattern, 0.6, r_cut=5.5)})
        integ_j = MTKJ(stack_j, sj, T=1800.0, P=1e-4, tau=40 * dt,
                       tau_p=100 * dt, num_chains=3, adjoint=True)
        sim_j = SimJ(sj, integ_j)
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), sim_j.params)
        ode_j = sim_j.epoch_fn(dt, 20)
        state_j, aux_j = sim_j.initial_state()
        state_j = state_j._replace(cell=jnp.asarray(state_j.cell,
                                                    jnp.float64))

        def vol_loss(p):
            traj, _ = ode_j(p, state_j, aux_j, integ_j.default_ctrl())
            return jnp.prod(traj.cell[-5:], axis=-1).mean()

        v_j = float(vol_loss(params))
        g_j = float(jax.grad(vol_loss)(params)["coul"]["qscale"])
        tree = jax.tree_util.tree_map(np.asarray, params)
    s = fs.rocksalt_melt(n_cells=2, a=6.0, T_kelvin=1800.0,
                         rng=np.random.default_rng(0))
    stack = mt.Stack({
        "core": mt.PairPotentials(s, mt.potentials.ExcludedVolume(
            sigma=2.3, epsilon=0.1, power=9), cutoff=5.5, device="cpu"),
        "coul": fs.ScaledChargeEwald(s, pattern, 0.6, r_cut=5.5,
                                     device="cpu")}).double()
    stack.load_state_dict(stack_params_from_numpy(tree, stack))
    stack.models["core"].requires_grad_(False)
    integ = mt.NPTMTKNHC(stack, s, T=1800.0, P=1e-4, tau=40 * dt,
                         tau_p=100 * dt, num_chains=3, adjoint=True,
                         device="cpu", dtype=torch.float64)
    sim = mt.Simulation(s, integ)
    state, aux = sim.initial_state()
    state = state._replace(**{k: _t(getattr(state_j, k))
                              for k in ("v", "q", "pv", "cell", "peps")})
    traj, _ = sim.epoch_fn(dt, 20)(state, aux, integ.default_ctrl())
    v = torch.prod(traj.cell[-5:], dim=-1).mean()
    v.backward()
    g = stack.models["coul"].qscale.grad.item()
    np.testing.assert_allclose(v.item(), v_j, rtol=1e-10)
    assert g < 0 and g_j < 0
    np.testing.assert_allclose(g, g_j, rtol=1e-8)
