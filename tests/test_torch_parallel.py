"""The port's distribution (``mdgrad_tpu_torch/parallel``: ``mesh``,
``replica``, ``spatial_gnn``, ``multistate``'s train step, ``dryrun``)
against the JAX package, mirroring tests/test_parallel.py.

The port runs in one gloo world of 8 ranks on the CPU (spawned once for
the module, joined by a ``FileStore`` under the test's temporary
directory, one intra-op thread a rank), on a mesh {'dp': 2, 'sp': 4}
or {'sp': 8}; the JAX package on its virtual 8-device CPU mesh or
unsharded, in this process.  Tolerances, each against the JAX package:

* the mesh shapes and the size error: equal;
* the sharded pair energy and forces (32 atoms, sp = 8) against the JAX
  dense ``PairPotentials``: rtol 1e-5, and rtol 1e-4 / atol 1e-5 (the
  JAX test's);
* the dp x sp epoch's loss and d/d(sigma, eps) (108 atoms, 4 replicas,
  3 steps) against JAX's ``make_sharded_epoch`` on its mesh: rtol 2e-3,
  atol 1e-7 (the JAX test's), and against the port's own run on one
  rank: rtol 1e-5;
* the row-sharded SchNet epoch (32 atoms, sp = 4, the replay adjoint)
  against the JAX unsharded epoch: loss rtol 1e-5, parameter gradients
  rtol 1e-4 / atol 1e-6 (the JAX test's), and against the port's
  unsharded epoch: rtol 1e-5 / atol 1e-7;
* a 32-atom SchNet's energy with thermodynamic integration's per-atom
  weights, row-sharded over sp = 8, against the unsharded one: the
  energy rtol 1e-5, the forces and d/d(weights) within 1e-5 of each
  one's largest entry;
* the 32-atom SchNet epoch row-sharded over sp = 8 beside a trainable,
  replicated prior in a Stack, against the unsharded stack: rtol 1e-5 /
  atol 1e-7 (the prior's gradient is not summed over the ranks);
* the multistate train step (two 32-atom SchNet states, float64, Adam)
  with the states split over dp = 2, against the JAX
  ``make_stack_multistate_train_step`` with ``optax.adam``: the summed
  loss and each state's g(r) within 1e-6, the summed gradients within
  1e-5 of each tensor's largest entry (the JAX SchNet rounds its
  convolutions to float32 also under x64), the updated parameters
  within 1e-5 of the learning rate (the gradients' tolerance carried
  through Adam's first step, at an eps of 1e-3 in both packages:
  ``MS_EPS``);
* ``dryrun_multichip(4)``: finite, and its loss and updated sigma equal
  one rank's to rtol 1e-5.
"""

import os

import numpy as np
import pytest
import torch

WORLD = 8
NBINS = 32
RDF_RANGE = (0.75, 1.9)
SCHNET = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 2, "cutoff": 1.6}
MS_LR = 1e-3
# Adam's eps in both packages: at the default 1e-8, a gradient entry of
# ~1e-8 makes the first update lr g / (|g| + eps) ~4e4 times as sensitive
# to g as the gradient itself, and the JAX SchNet's float32 convolutions
# (under x64) move such an entry by ~1e-13
MS_EPS = 1e-3


# ---- the ranks' tasks (mdgrad_tpu_torch only) ------------------------------

def _grad(p):
    """``p.grad`` as numpy; zeros where nothing reached it (the readout's
    last bias shifts the energy only)."""
    return (np.zeros(tuple(p.shape)) if p.grad is None
            else p.grad.clone().numpy())


def _sys32():
    import mdgrad_tpu_torch as mt
    s = mt.System.from_lattice("fcc", 2, 1.679)
    s.set_temperature(1.0 / mt.units.kB, rng=np.random.default_rng(5))
    return s


def _sys108():
    import mdgrad_tpu_torch as mt
    s = mt.System.from_lattice("fcc", 3, 1.679)
    s.set_temperature(1.0 / mt.units.kB, rng=np.random.default_rng(5))
    return s


def _cfg108(s, n_steps):
    from mdgrad_tpu_torch.parallel import ShardedMDConfig
    n = s.get_number_of_atoms()
    return ShardedMDConfig(cell=s.get_cell(), cutoff=2.4,
                           masses=s.get_masses(), dt=0.005, n_steps=n_steps,
                           kT=1.0, Q=np.array([50.0, 50.0 / n, 50.0 / n]),
                           n_dof=3 * n)


def _states108(s, R):
    from mdgrad_tpu_torch.md import NVTState
    n = s.get_number_of_atoms()
    rng = np.random.default_rng(0)
    return NVTState(
        v=torch.tensor(rng.standard_normal((R, n, 3)) * 0.5,
                       dtype=torch.float32),
        q=torch.tensor(np.stack([s.get_positions()] * R),
                       dtype=torch.float32),
        pv=torch.zeros(R, 3))


def task_mesh(mesh_fn):
    out = {}
    for axes in ({"dp": 2, "sp": -1}, {"sp": -1}, {"dp": 4, "sp": 2}):
        m = mesh_fn(axes)
        out[str(axes)] = dict(zip(m.mesh_dim_names, m.mesh.shape))
    try:
        mesh_fn({"dp": 3, "sp": 2})
    except ValueError as e:
        out["error"] = str(e)
    return out


def task_pair(mesh_fn):
    import mdgrad_tpu_torch as mt
    from mdgrad_tpu_torch.parallel import spatial_pair_energy
    from mdgrad_tpu_torch.parallel.mesh import axis_group
    sp = axis_group(mesh_fn({"sp": WORLD}), "sp")
    s = _sys32()
    rank = torch.distributed.get_rank(sp)
    blk = s.get_number_of_atoms() // WORLD
    x = torch.tensor(s.get_positions(), dtype=torch.float32)
    x = x[rank * blk:(rank + 1) * blk].clone().requires_grad_(True)
    lj = mt.potentials.LennardJones(1.0, 1.0).to("cpu")
    e = spatial_pair_energy(lj, x, s.get_cell(), 1.6, sp)
    (g,) = torch.autograd.grad(e, x)
    return {"energy": e.item(), "grad_block": g.numpy(), "rank": rank}


def sharded_epoch_grads(mesh):
    """(loss, d/d(sigma, eps), final positions) of the dp x sp epoch on
    4 replicas of 108 atoms, 3 steps (``mesh`` None: one rank)."""
    import mdgrad_tpu_torch as mt
    from mdgrad_tpu_torch.parallel import make_sharded_epoch
    from mdgrad_tpu_torch.parallel.mesh import all_reduce_grads
    s = _sys108()
    lj = mt.potentials.LennardJones(0.9, 1.0).to("cpu")
    _, loss_fn = make_sharded_epoch(lj, _cfg108(s, 3), mesh,
                                    rdf_range=RDF_RANGE, nbins=NBINS)
    loss, finals = loss_fn(_states108(s, 4), s.get_masses(),
                           torch.ones(NBINS))
    loss.backward()
    if mesh is not None:
        all_reduce_grads(lj.parameters(), torch.distributed.group.WORLD)
    return (loss.item(), {"sigma": lj.sigma.grad.item(),
                          "epsilon": lj.epsilon.grad.item()},
            finals.q.numpy())


def task_fit(mesh_fn):
    import mdgrad_tpu_torch as mt
    from mdgrad_tpu_torch.parallel import make_sharded_fit_step
    mesh = mesh_fn({"dp": 2, "sp": 4})
    loss, grads, finals_q = sharded_epoch_grads(mesh)
    # the whole step (the JAX test's 4 steps, lr 1e-4)
    s = _sys108()
    lj = mt.potentials.LennardJones(0.9, 1.0).to("cpu")
    step = make_sharded_fit_step(lj, _cfg108(s, 4), mesh, np.ones(NBINS),
                                 rdf_range=RDF_RANGE, nbins=NBINS, lr=1e-4)
    states = _states108(s, 4)
    step_loss, finals = step(states, s.get_masses())
    return {"loss": loss, "grads": grads, "finals_q": finals_q,
            "step_loss": step_loss.item(), "step_sigma": lj.sigma.item(),
            "step_finals_shape": tuple(finals.q.shape)}


def schnet_epoch(params_np, mesh):
    """(loss, {name: grad}) of tests/test_parallel.py's 32-atom SchNet
    epoch, its SchNet row-sharded over ``mesh``'s sp (None: unsharded)."""
    import mdgrad_tpu_torch as mt
    from mdgrad_tpu_torch.nn.convert import schnet_params_from_numpy
    from mdgrad_tpu_torch.parallel import ShardedGNNPotentials
    s = mt.System.from_lattice("fcc", 2, 1.76)
    s.set_temperature(1.0 / mt.units.kB, rng=np.random.default_rng(0))
    gnn = mt.SchNet(SCHNET)
    gnn.load_state_dict(schnet_params_from_numpy(params_np))
    inter = mt.GNNPotentials(s, gnn, cutoff=1.6, nbr_mode="table",
                             k_max=16, device="cpu")
    if mesh is not None:
        inter = ShardedGNNPotentials(inter, mesh)
    integ = mt.NoseHooverChain(inter, s, T=1.0 / mt.units.kB, num_chains=3,
                               Q=50.0, adjoint=True, device="cpu")
    sim = mt.Simulation(s, integ)
    state, aux = sim.initial_state()
    traj, _ = sim.epoch_fn(dt=0.005, frequency=5)(state, aux,
                                                  integ.default_ctrl())
    loss = (traj.q[-1] ** 2).sum()
    loss.backward()
    if mesh is not None:
        inter.reduce_grads()
    return loss.item(), {k: _grad(p) for k, p in gnn.named_parameters()}


def task_schnet(mesh_fn, params_np):
    loss, grads = schnet_epoch(params_np, mesh_fn({"dp": 2, "sp": 4}))
    return {"loss": loss, "grads": grads}


def schnet_stack_epoch(mesh):
    """(loss, {name: grad}) of the 32-atom SchNet epoch in a Stack beside
    a trainable ExcludedVolume prior (replicated: its gradient is whole
    on every rank and must not be summed), the SchNet row-sharded over
    ``mesh``'s sp (None: unsharded)."""
    import mdgrad_tpu_torch as mt
    from mdgrad_tpu_torch.parallel import ShardedGNNPotentials
    s = mt.System.from_lattice("fcc", 2, 1.76)
    s.set_temperature(1.0 / mt.units.kB, rng=np.random.default_rng(1))
    nn_int = mt.GNNPotentials(s, mt.SchNet(SCHNET, seed=3), cutoff=1.6,
                              nbr_mode="table", k_max=16, device="cpu")
    if mesh is not None:
        nn_int = ShardedGNNPotentials(nn_int, mesh)
    stack = mt.Stack({"nn": nn_int, "pair": mt.PairPotentials(
        s, mt.potentials.ExcludedVolume(epsilon=0.01, sigma=0.8, power=12),
        cutoff=1.6, mode="dense", device="cpu")})
    integ = mt.NoseHooverChain(stack, s, T=1.0 / mt.units.kB, num_chains=3,
                               Q=50.0, adjoint=True, device="cpu")
    sim = mt.Simulation(s, integ)
    state, aux = sim.initial_state()
    traj, _ = sim.epoch_fn(dt=0.005, frequency=4)(state, aux,
                                                  integ.default_ctrl())
    loss = (traj.q[-1] ** 2).sum()
    loss.backward()
    if mesh is not None:
        nn_int.reduce_grads()
    names = {id(p): k for k, p in stack.named_parameters()}
    if mesh is not None:   # the unsharded stack's names
        names = {i: k.replace("models.nn.base.", "models.nn.")
                 for i, k in names.items()}
    return loss.item(), {names[id(p)]: _grad(p) for p in stack.parameters()}


def task_schnet_stack(mesh_fn):
    loss, grads = schnet_stack_epoch(mesh_fn({"sp": WORLD}))
    return {"loss": loss, "grads": grads}


def schnet_ti_energy(mesh):
    """The energy of a 32-atom SchNet with thermodynamic integration's
    per-atom ``aggr_wgt``, its forces and d/d(aggr_wgt), the SchNet
    row-sharded over ``mesh``'s sp (None: unsharded)."""
    import mdgrad_tpu_torch as mt
    from mdgrad_tpu_torch.parallel import ShardedGNNPotentials
    s = _sys32()
    inter = mt.GNNPotentials(s, mt.SchNet(SCHNET, seed=4), cutoff=1.6,
                             nbr_mode="table", k_max=16, device="cpu")
    if mesh is not None:
        inter = ShardedGNNPotentials(inter, mesh)
    rng = np.random.default_rng(7)
    x = torch.tensor(s.get_positions() + 0.05 * rng.standard_normal(
        (32, 3)), dtype=torch.float32, requires_grad=True)
    w = torch.tensor(rng.uniform(0.2, 1.0, 32), dtype=torch.float32,
                     requires_grad=True)
    e = inter.energy(x, inter.aux_init(x.detach()), aggr_wgt=w)
    g_x, g_w = torch.autograd.grad(e, [x, w])
    return {"energy": e.item(), "forces": -g_x.numpy(),
            "d_aggr": g_w.numpy()}


def task_schnet_ti(mesh_fn):
    return schnet_ti_energy(mesh_fn({"sp": WORLD}))


def multistate_step(params_np, group):
    """The multistate train step on two 32-atom SchNet states in float64,
    Adam at ``MS_LR``; the states split over ``group`` (None: one rank).
    Returns (loss, gs, {name: grad}, {name: new value}, final q)."""
    import mdgrad_tpu_torch as mt
    from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy
    from mdgrad_tpu_torch.parallel import make_stack_multistate_train_step
    F64 = torch.float64
    systems, v0, kts, targets = _ms_points(mt)
    proto = systems[0]
    nn_int = mt.GNNPotentials(proto, mt.SchNet(SCHNET), cutoff=1.6,
                              nbr_mode="table", k_max=24, device="cpu")
    stack = mt.Stack({"nn": nn_int, "pair": mt.PairPotentials(
        proto, mt.potentials.ExcludedVolume(**MS_PRIOR), cutoff=1.6,
        mode="dense", device="cpu")})
    stack.load_state_dict(stack_params_from_numpy(params_np, stack))
    stack.to(F64)
    dyn = mt.WithDynamicCell(stack, np.diag(proto.get_cell()))
    integ = mt.NoseHooverChain(dyn, proto, T=kts[0] / mt.units.kB,
                               num_chains=3, Q=50.0, adjoint=True,
                               device="cpu", dtype=F64)
    params = [p for p in stack.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=MS_LR, betas=(0.9, 0.999), eps=MS_EPS)
    step = make_stack_multistate_train_step(
        integ, dt=0.005, n_steps=2, nbins=NBINS, rdf_range=RDF_RANGE,
        opt=opt, group=group, frame_skip=1, loss_type="mse")
    s0 = integ.initial_state()
    states = [s0._replace(q=torch.tensor(s.get_positions(), dtype=F64),
                          v=torch.tensor(v, dtype=F64))
              for s, v in zip(systems, v0)]
    loss, (losses, gs, finals, overflow) = step(
        states, np.stack([np.diag(s.get_cell()) for s in systems]), kts,
        torch.tensor(targets, dtype=F64), np.ones(2))
    assert overflow == [False, False] and len(finals) == 2
    return (loss.item(), gs.numpy(),
            {k: _grad(p) for k, p in stack.named_parameters()},
            {k: p.detach().clone().numpy()
             for k, p in stack.named_parameters()},
            np.stack([f.q.numpy() for f in finals]))


def task_multistate(mesh_fn, params_np):
    from mdgrad_tpu_torch.parallel.mesh import axis_group
    dp = axis_group(mesh_fn({"dp": 2, "sp": 4}), "dp")
    return dict(zip(("loss", "gs", "grads", "params", "finals_q"),
                    multistate_step(params_np, dp)))


MS_PRIOR = dict(epsilon=0.015625, sigma=0.75, power=12)   # f32-exact


def _ms_points(lib):
    rng = np.random.default_rng(3)
    systems, vs = [], []
    for a in (1.679, 1.76):
        systems.append(lib.System.from_lattice("fcc", 2, a))   # 32 atoms
        vs.append(rng.standard_normal((32, 3)) * 0.3)
    targets = 1.0 + 0.1 * rng.standard_normal((2, NBINS))
    return systems, np.stack(vs), np.asarray([1.0, 1.2]), targets


def _rank_main(rank, store_path, out_dir, payload):
    import torch.distributed as dist
    from mdgrad_tpu_torch.parallel import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        def mesh_fn(axes):
            return make_mesh(axes, device_type="cpu")
        out = {"mesh": task_mesh(mesh_fn), "pair": task_pair(mesh_fn),
               "fit": task_fit(mesh_fn),
               "schnet": task_schnet(mesh_fn, payload["schnet"]),
               "schnet_stack": task_schnet_stack(mesh_fn),
               "schnet_ti": task_schnet_ti(mesh_fn),
               "multistate": task_multistate(mesh_fn,
                                             payload["multistate"])}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---- the JAX side and the world ---------------------------------------------

def _jax_schnet_params():
    import jax
    from mdgrad_tpu import units as units_j
    from mdgrad_tpu.interface import GNNPotentials
    from mdgrad_tpu.md import NoseHooverChain, Simulation
    from mdgrad_tpu.nn import SchNet
    from mdgrad_tpu.system import System
    sys_ = System.from_lattice("fcc", 2, 1.76)
    sys_.set_temperature(1.0 / units_j.kB, rng=np.random.default_rng(0))
    inter = GNNPotentials(sys_, SchNet(SCHNET), cutoff=1.6,
                          nbr_mode="table", k_max=16)
    integ = NoseHooverChain(inter, sys_, T=1.0 / units_j.kB, num_chains=3,
                            Q=50.0, adjoint=True)
    sim = Simulation(sys_, integ)
    ode = sim.epoch_fn(dt=0.005, frequency=5)
    state, aux = sim.initial_state()
    ctrl = integ.default_ctrl()

    def loss(p):
        traj, _ = ode(p, state, aux, ctrl)
        return (traj.q[-1] ** 2).sum()

    l_ref, g_ref = jax.jit(jax.value_and_grad(loss))(sim.params)
    tree = jax.tree_util.tree_map(np.asarray, sim.params)
    return tree, float(l_ref), jax.tree_util.tree_map(np.asarray, g_ref)


def _jax_multistate():
    """The JAX ``make_stack_multistate_train_step`` with ``optax.adam``,
    float64 (the tests/test_torch_multistate.py f64 setup): (params tree
    before, loss, gs, grads tree, params tree after)."""
    import jax
    import jax.numpy as jnp
    import optax
    from mdgrad_tpu import potentials as potentials_j
    from mdgrad_tpu import system as system_j
    from mdgrad_tpu.interface import (GNNPotentials, PairPotentials, Stack,
                                      WithDynamicCell)
    from mdgrad_tpu.md import NoseHooverChain
    from mdgrad_tpu.nn import SchNet
    from mdgrad_tpu.parallel import (make_stack_multistate_fit,
                                     make_stack_multistate_train_step)
    from mdgrad_tpu import units as units_j
    with jax.enable_x64(True):
        systems, v0, kts, targets = _ms_points(system_j)
        proto = systems[0]
        stack = Stack({
            "nn": GNNPotentials(proto, SchNet({
                **SCHNET, "gather_mode": "gather",
                "compute_dtype": jnp.float64}), cutoff=1.6,
                nbr_mode="table", k_max=24),
            "pair": PairPotentials(proto, potentials_j.ExcludedVolume(
                **MS_PRIOR), cutoff=1.6, mode="dense")})
        integ = NoseHooverChain(
            WithDynamicCell(stack, np.diag(proto.get_cell())), proto,
            T=kts[0] / units_j.kB, num_chains=3, Q=50.0, adjoint=True)
        params = integ.init_params()
        tree = jax.tree_util.tree_map(np.asarray, params)
        params = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64), params)
        states = jax.vmap(lambda q, v: integ.initial_state()._replace(
            q=q, v=v))(jnp.asarray(np.stack([s.get_positions()
                                              for s in systems])),
                       jnp.asarray(v0))
        args = (states, jnp.asarray(np.stack([np.diag(s.get_cell())
                                              for s in systems])),
                jnp.asarray(kts), jnp.asarray(targets), jnp.ones(2))
        kw = dict(dt=0.005, n_steps=2, nbins=NBINS, rdf_range=RDF_RANGE,
                  frame_skip=1, loss_type="mse")
        grads = jax.jit(jax.grad(lambda p: make_stack_multistate_fit(
            integ, **kw)(p, *args)[0]))(params)
        opt = optax.adam(MS_LR, eps=MS_EPS)
        step = make_stack_multistate_train_step(integ, opt=opt, **kw)
        loss, new, _, (losses, gs, finals, overflow) = step(
            params, opt.init(params), *args)
        to_np = jax.tree_util.tree_map
        return (tree, float(loss), np.asarray(gs), to_np(np.asarray, grads),
                to_np(np.asarray, new), np.asarray(finals.q))


@pytest.fixture(scope="module")
def jax_refs():
    return {"schnet": _jax_schnet_params(), "multistate": _jax_multistate()}


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_refs):
    """Every rank's results of one gloo world of ``WORLD`` ranks."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("gloo")
    payload = {"schnet": jax_refs["schnet"][0],
               "multistate": jax_refs["multistate"][0]}
    mp.spawn(_rank_main, args=(str(tmp / "store"), str(tmp), payload),
             nprocs=WORLD, join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the tests ---------------------------------------------------------------

def test_mesh_shapes_match_jax(world):
    import jax
    from mdgrad_tpu.parallel import make_mesh as make_mesh_j
    devices = jax.devices()[:WORLD]
    for axes in ({"dp": 2, "sp": -1}, {"sp": -1}, {"dp": 4, "sp": 2}):
        want = dict(make_mesh_j(dict(axes), devices=devices).shape)
        assert all(r["mesh"][str(axes)] == want for r in world), axes
    with pytest.raises(ValueError) as e:
        make_mesh_j({"dp": 3, "sp": 2}, devices=devices)
    assert all(r["mesh"]["error"] == str(e.value) for r in world)


def test_make_mesh_defaults_to_the_card():
    """Without ``device_type`` the mesh is a CUDA mesh: without a card it
    raises rather than fall back to the CPU."""
    from mdgrad_tpu_torch.parallel import make_mesh
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA mesh is the card tests'")
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh({"sp": 1})


def test_dryrun_multichip_defaults_to_the_card():
    """Without ``device`` the dry run's ranks are NCCL ranks on the cards:
    without a card it raises rather than run gloo ranks on the CPU."""
    from mdgrad_tpu_torch.parallel import dryrun
    if torch.cuda.is_available():
        pytest.skip("a card is present: the NCCL dry run is the card's")
    with pytest.raises(RuntimeError, match="is_available"):
        dryrun.dryrun_multichip(2)


def test_spatial_energy_and_forces_match_dense_jax(world):
    import jax
    import jax.numpy as jnp
    from mdgrad_tpu import potentials as potentials_j
    from mdgrad_tpu.interface import PairPotentials
    from mdgrad_tpu.system import System
    from mdgrad_tpu import units as units_j
    sys32 = System.from_lattice("fcc", 2, 1.679)
    sys32.set_temperature(1.0 / units_j.kB, rng=np.random.default_rng(5))
    lj = potentials_j.LennardJones(1.0, 1.0)
    dense = PairPotentials(sys32, lj, cutoff=1.6, mode="dense")
    xyz = jnp.asarray(sys32.get_positions())
    u = float(dense.energy(lj.init_params(), xyz, ()))
    g = np.asarray(jax.grad(dense.energy, argnums=1)(lj.init_params(), xyz,
                                                     ()))
    rows = sorted((r["pair"] for r in world), key=lambda p: p["rank"])
    for p in rows:
        np.testing.assert_allclose(p["energy"], u, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([p["grad_block"]
                                               for p in rows]), g,
                               rtol=1e-4, atol=1e-5)


def test_sharded_epoch_gradients_match_jax_and_one_rank(world):
    import jax
    import jax.numpy as jnp
    from mdgrad_tpu import potentials as potentials_j
    from mdgrad_tpu import units as units_j
    from mdgrad_tpu.md.integrators import NVTState
    from mdgrad_tpu.parallel import make_mesh as make_mesh_j
    from mdgrad_tpu.parallel.replica import (ShardedMDConfig,
                                             make_sharded_epoch)
    from mdgrad_tpu.system import System
    s = System.from_lattice("fcc", 3, 1.679)
    s.set_temperature(1.0 / units_j.kB, rng=np.random.default_rng(5))
    cfg = ShardedMDConfig(cell=s.get_cell(), cutoff=2.4,
                          masses=jnp.asarray(s.get_masses()), dt=0.005,
                          n_steps=3, kT=1.0,
                          Q=jnp.asarray([50.0, 50.0 / 108, 50.0 / 108]),
                          n_dof=3 * 108)
    lj = potentials_j.LennardJones(0.9, 1.0)
    _, loss_fn = make_sharded_epoch(lj, cfg, make_mesh_j(
        {"dp": 2, "sp": 4}, devices=jax.devices()[:WORLD]),
        rdf_range=RDF_RANGE, nbins=NBINS)
    rng = np.random.default_rng(0)
    states = NVTState(v=jnp.asarray(rng.standard_normal((4, 108, 3)) * 0.5),
                      q=jnp.asarray(np.stack([s.get_positions()] * 4)),
                      pv=jnp.zeros((4, 3)))
    (l_j, finals_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, states, jnp.asarray(s.get_masses()),
                          jnp.ones(NBINS)), has_aux=True))(lj.init_params())
    one = sharded_epoch_grads(None)
    for r in world:
        fit = r["fit"]
        np.testing.assert_allclose(fit["loss"], float(l_j), rtol=2e-3)
        np.testing.assert_allclose(fit["loss"], one[0], rtol=1e-5)
        np.testing.assert_allclose(fit["finals_q"], one[2], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(fit["finals_q"], np.asarray(finals_j.q),
                                   rtol=0, atol=1e-4)
        for k in ("sigma", "epsilon"):
            assert fit["grads"][k] != 0
            np.testing.assert_allclose(fit["grads"][k], float(g_j[k]),
                                       rtol=2e-3, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(fit["grads"][k], one[1][k],
                                       rtol=1e-5, err_msg=k)


def test_full_sharded_training_step(world):
    """dp = 2 x sp = 4: one step moves sigma, the same on every rank."""
    sigmas = {r["fit"]["step_sigma"] for r in world}
    assert len(sigmas) == 1 and abs(sigmas.pop() - 0.9) > 1e-9
    for r in world:
        assert np.isfinite(r["fit"]["step_loss"])
        assert r["fit"]["step_finals_shape"] == (4, 108, 3)


def test_sp_sharded_schnet_epoch_matches_jax_and_unsharded(world,
                                                          jax_refs):
    from mdgrad_tpu_torch.nn.convert import schnet_params_from_numpy
    tree, l_ref, g_ref = jax_refs["schnet"]
    g_ref = {k: v.numpy() for k, v in schnet_params_from_numpy(g_ref)
             .items()}
    loss_1, grads_1 = schnet_epoch(tree, None)
    np.testing.assert_allclose(loss_1, l_ref, rtol=1e-5)
    for r in world:
        np.testing.assert_allclose(r["schnet"]["loss"], l_ref, rtol=1e-5)
        np.testing.assert_allclose(r["schnet"]["loss"], loss_1, rtol=1e-5)
        for k, g in r["schnet"]["grads"].items():
            np.testing.assert_allclose(g, g_ref[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(g, grads_1[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_sharded_schnet_beside_a_replicated_prior(world):
    """sp = 8 over a Stack whose ExcludedVolume prior is trainable and
    replicated: the SchNet's gradients summed over the ranks, the prior's
    taken as each rank has them, all equal the unsharded stack's (rtol
    1e-5, atol 1e-7)."""
    loss_1, grads_1 = schnet_stack_epoch(None)
    assert any(k.startswith("models.pair.") for k in grads_1)
    for r in world:
        got = r["schnet_stack"]
        np.testing.assert_allclose(got["loss"], loss_1, rtol=1e-5)
        assert got["grads"].keys() == grads_1.keys()
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, grads_1[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        assert np.abs(got["grads"]["models.pair.model.epsilon"]).max() > 0


def test_sharded_schnet_energy_with_ti_weights(world):
    """sp = 8 with thermodynamic integration's per-atom ``aggr_wgt``: the
    energy (rtol 1e-5), the forces and d/d(aggr_wgt) (atol 1e-5 of each
    one's largest entry) equal the unsharded GNNPotentials' on every
    rank."""
    want = schnet_ti_energy(None)
    for r in world:
        got = r["schnet_ti"]
        np.testing.assert_allclose(got["energy"], want["energy"],
                                   rtol=1e-5)
        for k in ("forces", "d_aggr"):
            scale = np.abs(want[k]).max()
            assert scale > 0
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-5 * scale, err_msg=k)


def test_multistate_train_step_matches_jax_f64(world, jax_refs):
    from mdgrad_tpu_torch import Stack
    _, l_j, gs_j, grads_j, new_j, finals_j = jax_refs["multistate"]
    one = multistate_step(jax_refs["multistate"][0], None)
    runs = [one] + [tuple(r["multistate"][k] for k in (
        "loss", "gs", "grads", "params", "finals_q")) for r in world]
    import mdgrad_tpu_torch as mt
    from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy
    proto = _ms_points(mt)[0][0]
    stack = Stack({"nn": mt.GNNPotentials(proto, mt.SchNet(SCHNET),
                                          cutoff=1.6, nbr_mode="table",
                                          k_max=24, device="cpu"),
                   "pair": mt.PairPotentials(
                       proto, mt.potentials.ExcludedVolume(**MS_PRIOR),
                       cutoff=1.6, mode="dense", device="cpu")})
    want_g = {k: v.numpy() for k, v in
              stack_params_from_numpy(grads_j, stack).items()}
    want_p = {k: v.numpy() for k, v in
              stack_params_from_numpy(new_j, stack).items()}
    start = stack_params_from_numpy(jax_refs["multistate"][0], stack)
    # the step moved them by far more than the tolerance below
    assert max(np.abs(want_p[k] - start[k].numpy()).max()
               for k in want_p) > 100 * 1e-5 * MS_LR
    for loss, gs, grads, params, finals_q in runs:
        np.testing.assert_allclose(loss, l_j, rtol=1e-6)
        np.testing.assert_allclose(gs, gs_j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(finals_q, finals_j, rtol=0, atol=1e-9)
        for k, g in grads.items():
            w = want_g[k]
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-9),
                err_msg=k)
            np.testing.assert_allclose(params[k], want_p[k], rtol=0,
                                       atol=1e-5 * MS_LR, err_msg=k)


def test_dryrun_multichip():
    """Four gloo ranks (dp 1 x sp 4 on 108 atoms): finite, and the same
    step as one rank's."""
    from mdgrad_tpu_torch.parallel import dryrun
    from mdgrad_tpu_torch.parallel.replica import make_sharded_fit_step
    res = dryrun.dryrun_multichip(4, device="cpu")
    assert (res["dp"], res["sp"], res["backend"]) == (1, 4, "gloo")
    lj, cfg, system = dryrun.dryrun_config("cpu")
    step = make_sharded_fit_step(lj, cfg, None, np.ones(NBINS),
                                 rdf_range=RDF_RANGE, nbins=NBINS, lr=1e-4)
    loss, finals = step(dryrun.dryrun_states(system, 2, "cpu"),
                        system.get_masses())
    np.testing.assert_allclose(res["loss"], loss.item(), rtol=1e-5)
    np.testing.assert_allclose(res["sigma"], lj.sigma.item(), rtol=1e-5)
    assert res["sigma"] != 0.9
