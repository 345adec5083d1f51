"""Multi-state-point fitting in the port (parallel/multistate.py): the four
tests of tests/test_multistate.py, where the JAX package's sharded program
must equal its serial state-point loop, here with the port's serial
engine held to the port's single-system pipeline (Simulation, the replay
adjoint, observables.rdf); and both engines against the JAX package in
float64 (JAX inside ``jax.enable_x64(True)``): the dense pair engine
against ``make_multistate_fit`` on a 1 x 1 mesh, and
``make_stack_multistate_fit`` against the JAX one with ``mesh=None`` for
the SchNet stack and for the TPair stack (the port's ``set_kT`` against
the JAX ``kT_to_params`` graft), with the same weights: the summed loss,
each state's g(r) or final state, and the summed gradients."""

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
from mdgrad_tpu.interface import TPairPotentials as TPairPotentialsJ
from mdgrad_tpu.interface import WithDynamicCell as WithDynamicCellJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md.integrators import NVTState as NVTStateJ
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.nn import TPairMLP as TPairMLPJ
from mdgrad_tpu.parallel import MultiStateConfig as MultiStateConfigJ
from mdgrad_tpu.parallel import make_mesh
from mdgrad_tpu.parallel import make_multistate_fit as mf_j
from mdgrad_tpu.parallel import make_stack_multistate_fit as msf_j
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import units
from mdgrad_tpu_torch.md import NVTState
from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy
from mdgrad_tpu_torch.parallel import (MultiStateConfig, make_multistate_fit,
                                       make_multistate_train_step,
                                       make_stack_multistate_fit)

N_STEPS = 3
NBINS = 32
RDF_RANGE = (0.75, 1.9)
CUTOFF = 2.4
LATTICE_A = [1.679, 1.72, 1.76, 1.80]   # one box per state point
KTS = [1.0, 1.1, 1.2, 0.9]
SCHNET = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 2, "cutoff": 1.6}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_points():
    systems, qs, vs = [], [], []
    rng = np.random.default_rng(11)
    for a in LATTICE_A:
        s = mt.System.from_lattice("fcc", 3, a)   # 108 atoms
        systems.append(s)
        qs.append(s.get_positions())
        vs.append(rng.standard_normal((108, 3)) * 0.4)
    targets = 1.0 + 0.1 * rng.standard_normal((4, NBINS))
    return systems, np.stack(qs), np.stack(vs), targets


def _cfg(n):
    return MultiStateConfig(cutoff=CUTOFF, dt=0.005, n_steps=N_STEPS,
                            Q=torch.tensor([50.0, 50.0 / n, 50.0 / n]),
                            n_dof=3 * n, nbins=NBINS, rdf_range=RDF_RANGE)


def _stacked(q0, v0):
    f32 = torch.float32
    return NVTState(v=torch.tensor(v0, dtype=f32), q=torch.tensor(q0, dtype=f32),
                    pv=torch.zeros(len(q0), 3))


def _cells(systems):
    return np.stack([np.diag(s.get_cell()) for s in systems])


def test_multistate_grads_match_serial_loop():
    """The dense pair engine's summed loss and d/d(sigma, eps) against the
    serial loop of single-system NHC epochs (no cache, direct backprop)
    and observables.rdf: 1e-4 and 2e-3 relative, float32."""
    systems, q0, v0, targets = _state_points()
    lj = mt.potentials.LennardJones(0.9, 1.0)
    params = list(lj.parameters())
    loss_fn = make_multistate_fit(lj, _cfg(108))
    loss, finals = loss_fn(_stacked(q0, v0), _cells(systems), KTS,
                           torch.tensor(targets, dtype=torch.float32),
                           systems[0].get_masses())
    g_multi = torch.autograd.grad(loss, params)
    assert finals.q.shape == (4, 108, 3)

    total, g_total = 0.0, [torch.zeros(()) for _ in params]
    for j, s in enumerate(systems):
        pair = mt.PairPotentials(s, lj, cutoff=CUTOFF, mode="dense",
                                 device="cpu")
        integ = mt.NoseHooverChain(pair, s, T=KTS[j] / units.kB,
                                   num_chains=3, Q=50.0, adjoint=False,
                                   device="cpu")
        ode = mt.Simulation(s, integ).epoch_fn(dt=0.005,
                                               frequency=N_STEPS + 1)
        obs = mt.observables.rdf(s, nbins=NBINS, r_range=RDF_RANGE,
                                 device="cpu")
        s0 = NVTState(v=torch.tensor(v0[j], dtype=torch.float32),
                      q=torch.tensor(q0[j], dtype=torch.float32),
                      pv=torch.zeros(3))
        traj, _ = ode(s0, (), {"kT": torch.tensor(KTS[j])})
        _, _, g = obs(traj.q[-1])
        l = ((g - torch.tensor(targets[j], dtype=torch.float32)) ** 2).mean()
        total += l.item()
        g_total = [a + b for a, b in zip(g_total,
                                         torch.autograd.grad(l, params))]
    np.testing.assert_allclose(loss.item(), total, rtol=1e-4)
    for a, b in zip(g_multi, g_total):
        assert b.abs() > 0
        np.testing.assert_allclose(a.item(), b.item(), rtol=2e-3, atol=1e-7)


def test_multistate_fit_matches_jax_f64():
    """The dense pair engine against the JAX ``make_multistate_fit`` on a
    1 x 1 mesh, float64, four 108-atom boxes of 3 steps: the summed loss
    within 1e-10 relative, the final positions and velocities within
    1e-10, and d/d(sigma, eps) within 1e-8 relative.  (sigma and eps are
    float32-exact: the port's potentials hold float32 parameters.)"""
    F64 = torch.float64
    systems, q0, v0, targets = _state_points()
    cells, masses = _cells(systems), systems[0].get_masses()
    Q = np.array([50.0, 50.0 / 108, 50.0 / 108])
    sigma, eps = 0.875, 1.0
    with jax.enable_x64(True):
        cfg_j = MultiStateConfigJ(cutoff=CUTOFF, dt=0.005, n_steps=N_STEPS,
                                  Q=jnp.asarray(Q), n_dof=3 * 108,
                                  nbins=NBINS, rdf_range=RDF_RANGE)
        lj_j = potentials_j.LennardJones(sigma, eps)
        loss_j = mf_j(lj_j, cfg_j, make_mesh({"dp": 1, "sp": 1},
                                             devices=jax.devices()[:1]))
        states_j = NVTStateJ(v=jnp.asarray(v0), q=jnp.asarray(q0),
                             pv=jnp.zeros((4, 3)))
        (l_j, finals_j), g_j = jax.jit(jax.value_and_grad(
            lambda p: loss_j(p, states_j, jnp.asarray(cells),
                             jnp.asarray(KTS), jnp.asarray(targets),
                             jnp.asarray(masses)), has_aux=True))(
                lj_j.init_params())
        l_j = float(l_j)
        finals_j = [np.asarray(x) for x in finals_j]
        g_j = {k: float(v) for k, v in g_j.items()}

    lj = mt.potentials.LennardJones(sigma, eps).to(F64)
    cfg = MultiStateConfig(cutoff=CUTOFF, dt=0.005, n_steps=N_STEPS,
                           Q=torch.tensor(Q), n_dof=3 * 108, nbins=NBINS,
                           rdf_range=RDF_RANGE)
    states = NVTState(v=torch.tensor(v0), q=torch.tensor(q0),
                      pv=torch.zeros(4, 3, dtype=F64))
    loss, finals = make_multistate_fit(lj, cfg)(
        states, cells, KTS, torch.tensor(targets), masses)
    g_sigma, g_eps = torch.autograd.grad(loss, [lj.sigma, lj.epsilon])
    assert loss.dtype == F64
    np.testing.assert_allclose(loss.item(), l_j, rtol=1e-10)
    for got, want in zip(finals, finals_j):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-10)
    for got, name in ((g_sigma, "sigma"), (g_eps, "epsilon")):
        assert g_j[name] != 0
        np.testing.assert_allclose(got.item(), g_j[name], rtol=1e-8,
                                   err_msg=name)


def test_multistate_train_step_moves_params():
    systems, q0, v0, targets = _state_points()
    lj = mt.potentials.LennardJones(0.9, 1.0)
    sigma0 = lj.sigma.item()
    step = make_multistate_train_step(lj, _cfg(108), lr=1e-4)
    states = _stacked(q0, v0)
    loss, finals = step(states, _cells(systems), KTS,
                        torch.tensor(targets, dtype=torch.float32),
                        systems[0].get_masses())
    assert np.isfinite(loss.item())
    assert finals.q.shape == states.q.shape
    assert abs(lj.sigma.item() - sigma0) > 1e-9


def _gnn_state_points(lib=mt):
    rng = np.random.default_rng(3)
    systems, vs = [], []
    for a in (1.679, 1.76):
        s = lib.System.from_lattice("fcc", 2, a)   # 32 atoms
        systems.append(s)
        vs.append(rng.standard_normal((32, 3)) * 0.3)
    targets = 1.0 + 0.1 * rng.standard_normal((2, NBINS))
    return systems, np.stack(vs), np.asarray([1.0, 1.2]), targets


def _serial(systems, v0, kts, targets, make_nn, prior, set_kT=None):
    """The serial oracle: each state's epoch through the single-system
    pipeline, its loss backpropagated into the shared modules."""
    total, params = 0.0, None
    for j, s in enumerate(systems):
        stack = mt.Stack({"nn": make_nn(s, kts[j]),
                          "pair": mt.PairPotentials(s, prior, cutoff=1.6,
                                                    mode="dense",
                                                    device="cpu")})
        params = list(stack.parameters())
        integ = mt.NoseHooverChain(stack, s, T=kts[j] / units.kB,
                                   num_chains=3, Q=50.0, adjoint=True,
                                   device="cpu")
        sim = mt.Simulation(s, integ)
        obs = mt.observables.rdf(s, nbins=NBINS, r_range=RDF_RANGE,
                                 device="cpu")
        s0 = integ.initial_state()._replace(
            v=torch.tensor(v0[j], dtype=torch.float32))
        traj, _ = sim.epoch_fn(dt=0.005, frequency=3)(
            s0, integ.aux_init(s0.q), {"kT": torch.tensor(kts[j])})
        _, _, g = obs(traj.q)
        l = ((g - torch.tensor(targets[j], dtype=torch.float32)) ** 2).mean()
        l.backward()
        total += l.item()
    grads = [_grad(p) for p in params]
    for p in params:
        p.grad = None
    return total, grads


def _grad(p):
    return torch.zeros_like(p) if p.grad is None else p.grad.clone()


def _multi(systems, v0, kts, targets, nn_int, prior, set_kT=None,
           dtype=torch.float32):
    """The port's multistate engine on the first system as the
    prototype."""
    proto = systems[0]
    stack = mt.Stack({"nn": nn_int, "pair": mt.PairPotentials(
        proto, prior, cutoff=1.6, mode="dense", device="cpu")})
    if dtype != torch.float32:
        stack.to(dtype)
    dyn = mt.WithDynamicCell(stack, np.diag(proto.get_cell()))
    integ = mt.NoseHooverChain(dyn, proto, T=kts[0] / units.kB,
                               num_chains=3, Q=50.0, adjoint=True,
                               device="cpu", dtype=dtype)
    loss_fn = make_stack_multistate_fit(
        integ, dt=0.005, n_steps=2, nbins=NBINS, rdf_range=RDF_RANGE,
        frame_skip=1, loss_type="mse", set_kT=set_kT)
    s0 = integ.initial_state()
    states = [s0._replace(q=torch.tensor(s.get_positions(), dtype=dtype),
                          v=torch.tensor(v, dtype=dtype))
              for s, v in zip(systems, v0)]
    total, (losses, gs, finals, overflow) = loss_fn(
        states, _cells(systems), kts, torch.tensor(targets, dtype=dtype),
        np.ones(len(systems)))
    params = list(stack.parameters())
    return stack, total, gs, [_grad(p) for p in params], finals, overflow


def test_gnn_stack_multistate_matches_serial():
    """The SchNet stack through one dynamic-cell integrator: the summed
    loss (1e-4) and gradients (2e-3 relative, float32) equal the serial
    single-system loop's."""
    systems, v0, kts, targets = _gnn_state_points()
    gnn = mt.SchNet(SCHNET, seed=0)
    prior = mt.potentials.ExcludedVolume(epsilon=0.01, sigma=0.8, power=12)

    def make_nn(s, kT):
        return mt.GNNPotentials(s, gnn, cutoff=1.6, nbr_mode="table",
                                k_max=24, device="cpu")

    total, g_serial = _serial(systems, v0, kts, targets, make_nn, prior)
    _, loss, _, g_multi, finals, overflow = _multi(
        systems, v0, kts, targets, make_nn(systems[0], None), prior)
    assert overflow == [False, False] and len(finals) == 2
    np.testing.assert_allclose(loss.item(), total, rtol=1e-4)
    for a, b in zip(g_multi, g_serial):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=1e-6)


def test_tpair_multistate_matches_serial():
    """TPairPotentials through the engine: each state's kT is set in the
    buffer before its epoch (``set_kT``); the summed loss and gradients
    equal the serial loop with each state's own TPairPotentials."""
    systems, v0, kts, targets = _gnn_state_points()
    net = mt.TPairMLP(n_gauss=8, r_start=0.0, r_end=1.6, n_width=16,
                      n_layers=1, nonlinear="SELU", device="cpu", seed=0)
    prior = mt.potentials.ExcludedVolume(epsilon=0.01, sigma=0.8, power=12)

    def make_nn(s, kT):
        return mt.TPairPotentials(s, net, kT / units.kB, cutoff=1.6,
                                  mode="table", device="cpu")

    total, g_serial = _serial(systems, v0, kts, targets, make_nn, prior)
    nn_int = make_nn(systems[0], kts[0])
    _, loss, _, g_multi, _, _ = _multi(systems, v0, kts, targets, nn_int,
                                       prior, set_kT=lambda kT:
                                       nn_int.kT.fill_(kT))
    assert nn_int.kT.item() == pytest.approx(kts[-1])
    np.testing.assert_allclose(loss.item(), total, rtol=1e-4)
    assert len(g_multi) == len(g_serial)
    for a, b in zip(g_multi, g_serial):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=1e-6)


def test_stack_multistate_matches_jax_f64():
    """The SchNet stack (the JAX package's weights) through both engines
    in float64, two 32-atom boxes, 2 steps each: the summed loss within
    1e-6 relative, each state's g(r) within 1e-6, and the summed gradient
    of every parameter within 1e-5 of its largest entry.  (The JAX SchNet
    rounds its embedding and each convolution's output to float32 also
    under x64, so the two programs differ at ~1e-7 relative.)"""
    F64 = torch.float64
    prior_args = dict(epsilon=0.015625, sigma=0.75, power=12)  # f32-exact
    systems, v0, kts, targets = _gnn_state_points()
    nn_int = mt.GNNPotentials(systems[0], mt.SchNet(SCHNET), cutoff=1.6,
                              nbr_mode="table", k_max=24, device="cpu")
    with jax.enable_x64(True):
        sys_j = _gnn_state_points(system_j)[0]
        proto = sys_j[0]
        stack_j = StackJ({
            "nn": GNNPotentialsJ(proto, SchNetJ({
                **SCHNET, "gather_mode": "gather",
                "compute_dtype": jnp.float64}), cutoff=1.6,
                nbr_mode="table", k_max=24),
            "pair": PairPotentialsJ(proto, potentials_j.ExcludedVolume(
                **prior_args), cutoff=1.6, mode="dense")})
        integ_j = NoseHooverChainJ(
            WithDynamicCellJ(stack_j, np.diag(proto.get_cell())), proto,
            T=kts[0] / units.kB, num_chains=3, Q=50.0, adjoint=True)
        loss_j = msf_j(integ_j, dt=0.005, n_steps=2, nbins=NBINS,
                       rdf_range=RDF_RANGE, frame_skip=1, loss_type="mse")
        states_j = jax.vmap(
            lambda q, v: integ_j.initial_state()._replace(q=q, v=v))(
                jnp.asarray(np.stack([s.get_positions() for s in sys_j])),
                jnp.asarray(v0))
        params = integ_j.init_params()
        (l_j, (_, gs_j, _, _)), grads_j = jax.jit(jax.value_and_grad(
            loss_j, has_aux=True))(params, states_j, jnp.asarray(_cells(
                sys_j)), jnp.asarray(kts), jnp.asarray(targets),
                jnp.ones(2))
        params = jax.tree_util.tree_map(np.asarray, params)
        grads_j = jax.tree_util.tree_map(np.asarray, grads_j)
        l_j, gs_j = float(l_j), np.asarray(gs_j)
    nn_int.load_state_dict({k[len("models.nn."):]: v for k, v in
                            stack_params_from_numpy(params, mt.Stack({
                                "nn": nn_int})).items()})
    stack, loss, gs, grads, _, _ = _multi(
        systems, v0, kts, targets, nn_int,
        mt.potentials.ExcludedVolume(**prior_args), dtype=F64)
    assert loss.dtype == F64
    np.testing.assert_allclose(loss.item(), l_j, rtol=1e-6)
    np.testing.assert_allclose(gs.numpy(), gs_j, rtol=0, atol=1e-6)
    want = stack_params_from_numpy(grads_j, stack)
    for (name, _), g in zip(stack.named_parameters(), grads):
        w = want[name].numpy()
        # the readout's last bias shifts the energy only: no gradient
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-9),
                                   err_msg=name)


def test_tpair_multistate_matches_jax_f64():
    """TPairPotentials through both engines in float64, two 32-atom boxes
    at kT 1.0 and 1.2, 2 steps each: the port sets each state's kT in the
    buffer (``set_kT``), JAX grafts it into the parameters
    (``kT_to_params``, as its multistate driver does).  The summed loss
    within 1e-9 relative, each state's g(r) within 1e-9, and the summed
    gradient of every parameter within 1e-8 of its largest entry."""
    F64 = torch.float64
    prior_args = dict(epsilon=0.015625, sigma=0.75, power=12)  # f32-exact
    net_args = dict(n_gauss=8, r_start=0.0, r_end=1.6, n_layers=1,
                    n_width=16, nonlinear="SELU")
    systems, v0, kts, targets = _gnn_state_points()
    with jax.enable_x64(True):
        sys_j = _gnn_state_points(system_j)[0]
        proto = sys_j[0]
        stack_j = StackJ({
            "nn": TPairPotentialsJ(proto, TPairMLPJ(**net_args),
                                   kts[0] / units.kB, cutoff=1.6,
                                   mode="table"),
            "pair": PairPotentialsJ(proto, potentials_j.ExcludedVolume(
                **prior_args), cutoff=1.6, mode="dense")})
        integ_j = NoseHooverChainJ(
            WithDynamicCellJ(stack_j, np.diag(proto.get_cell())), proto,
            T=kts[0] / units.kB, num_chains=3, Q=50.0, adjoint=True)
        loss_j = msf_j(integ_j, dt=0.005, n_steps=2, nbins=NBINS,
                       rdf_range=RDF_RANGE, frame_skip=1, loss_type="mse",
                       kT_to_params=lambda p, kT: {
                           **p, "nn": {**p["nn"], "kT": kT}})
        states_j = jax.vmap(
            lambda q, v: integ_j.initial_state()._replace(q=q, v=v))(
                jnp.asarray(np.stack([s.get_positions() for s in sys_j])),
                jnp.asarray(v0))
        # flax makes float32 weights: widened, so that the gradients
        # come back unrounded
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                        integ_j.init_params())
        (l_j, (_, gs_j, _, _)), grads_j = jax.jit(jax.value_and_grad(
            loss_j, has_aux=True))(params, states_j, jnp.asarray(_cells(
                sys_j)), jnp.asarray(kts), jnp.asarray(targets),
                jnp.ones(2))
        params = jax.tree_util.tree_map(np.asarray, params)
        grads_j = jax.tree_util.tree_map(np.asarray, grads_j)
        l_j, gs_j = float(l_j), np.asarray(gs_j)
    nn_int = mt.TPairPotentials(systems[0], mt.TPairMLP(**net_args,
                                                        device="cpu"),
                                kts[0] / units.kB, cutoff=1.6, mode="table",
                                device="cpu")
    nn_int.load_state_dict({k[len("models.nn."):]: v for k, v in
                            stack_params_from_numpy(params, mt.Stack({
                                "nn": nn_int})).items()})
    stack, loss, gs, grads, _, _ = _multi(
        systems, v0, kts, targets, nn_int,
        mt.potentials.ExcludedVolume(**prior_args),
        set_kT=lambda kT: nn_int.kT.fill_(kT), dtype=F64)
    assert nn_int.kT.item() == kts[-1]
    assert loss.dtype == F64
    np.testing.assert_allclose(loss.item(), l_j, rtol=1e-9)
    np.testing.assert_allclose(gs.numpy(), gs_j, rtol=0, atol=1e-9)
    want = stack_params_from_numpy(grads_j, stack)
    assert sum(np.abs(w.numpy()).max() > 0 for w in want.values()) > 4
    for (name, _), g in zip(stack.named_parameters(), grads):
        w = want[name].numpy()
        # the last biases shift the energy only: no gradient
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-8 * max(np.abs(w).max(), 1e-9),
                                   err_msg=name)
