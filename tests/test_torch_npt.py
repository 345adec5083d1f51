"""The port's barostats (``NPTBerendsenNHC``, ``NPTMTKNHC``) against the
JAX package's (tests/test_npt.py:73-230 mirrored): trajectories of q, v,
the chain momenta, the cell and the barostat momentum in float64, the
gradients through the barostatted trajectory, the 2-D barostat, and
``rethermalize`` zeroing ``peps``.

The system: 108 LJ atoms on the FCC lattice at the reduced density 0.845
(T 1.2, LJ cutoff 2.3, dense), as tests/test_npt.py's.  The JAX
integrators round their initial cell to float32; both packages start here
from the JAX state, so the comparison starts from equal bits.  The JAX
side runs inside ``jax.enable_x64(True)``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.md import NPTBerendsenNHC as BerendsenJ
from mdgrad_tpu.md import NPTMTKNHC as MTKJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.md import rethermalize as rethermalize_j
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import units
from mdgrad_tpu_torch.md import rethermalize

RHO, T_RED, CUT, P0 = 0.845, 1.2, 2.3, 3.0
A = (4 / RHO) ** (1 / 3)
KINDS = {"berendsen": (BerendsenJ, mt.NPTBerendsenNHC,
                       dict(Q=50.0, tau_p=0.5)),
         "mtk": (MTKJ, mt.NPTMTKNHC, dict(tau=0.4, tau_p=0.5))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(cls, seed=1):
    s = cls.from_lattice("fcc", 3, A)
    s.set_temperature(T_RED / units.kB, rng=np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 10)
    s.positions = s.positions + 0.05 * rng.standard_normal(s.positions.shape)
    return s


def _jax(kind, adjoint=False):
    cls_j, _, kw = KINDS[kind]
    sj = _system(SystemJ)
    pair = PairPotentialsJ(sj, potentials_j.LennardJones(1.0, 1.0),
                           cutoff=CUT)
    integ = cls_j(pair, sj, T=T_RED / units_j.kB, P=P0, num_chains=3,
                  adjoint=adjoint, **kw)
    sim = SimulationJ(sj, integ)
    return integ, sim


def _port(kind, state_j, adjoint=False):
    """(pair, integrator, simulation, the JAX initial state as the port's)"""
    _, cls, kw = KINDS[kind]
    s = _system(mt.System)
    pair = mt.PairPotentials(s, mt.potentials.LennardJones(1.0, 1.0),
                             cutoff=CUT, mode="dense", device="cpu").double()
    integ = cls(pair, s, T=T_RED / units.kB, P=P0, num_chains=3,
                adjoint=adjoint, device="cpu", dtype=torch.float64, **kw)
    sim = mt.Simulation(s, integ)
    state, aux = sim.initial_state()
    state = state._replace(**{k: torch.tensor(np.asarray(
        getattr(state_j, k)), dtype=torch.float64)
        for k in ("v", "q", "pv", "cell") + (
            ("peps",) if kind == "mtk" else ())})
    return pair, integ, sim, state, aux


FIELDS = {"berendsen": ("q", "v", "pv", "cell"),
          "mtk": ("q", "v", "pv", "cell", "peps")}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_trajectory_matches_jax_f64(kind):
    """Two epochs of 20 frames (the second restarted from the first's last
    state, wrapped against its own cell): every state field equals JAX's
    to 1e-10 (the cell moves by ~1e-3 over them)."""
    with jax.enable_x64(True):
        integ_j, sim_j = _jax(kind)
        ode_j = sim_j.epoch_fn(0.005, 20)
        state_j, aux_j = sim_j.initial_state()
        state_j = state_j._replace(cell=jnp.asarray(state_j.cell,
                                                    jnp.float64))
        ref = []
        st, ax = state_j, aux_j
        for _ in range(2):
            traj_j, ax = ode_j(sim_j.params, st, ax, integ_j.default_ctrl())
            ref.append({k: np.asarray(getattr(traj_j, k))
                        for k in FIELDS[kind]})
            st = jax.tree_util.tree_map(lambda x: x[-1], traj_j)
    _, integ, sim, state, aux = _port(kind, state_j)
    ode = sim.epoch_fn(0.005, 20)
    with torch.no_grad():
        for r in ref:
            traj, aux = ode(state, aux, integ.default_ctrl())
            for k in FIELDS[kind]:
                np.testing.assert_allclose(getattr(traj, k).numpy(), r[k],
                                           rtol=0, atol=1e-10,
                                           err_msg=f"{kind} {k}")
            state = traj._replace(**{k: getattr(traj, k)[-1]
                                     for k in ("v", "q", "pv", "cell", "f")
                                     + (("peps",) if kind == "mtk" else ())})
    assert abs(traj.cell[-1, 0].item() - traj.cell[0, 0].item()) > 1e-5


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gradients_through_barostat_match_jax(kind):
    """d(mean volume of the last 10 frames)/d(sigma, eps) through a
    30-frame barostatted epoch: the replay adjoint equals direct autograd
    to 1e-9 and JAX's ``jax.grad`` to 1e-8, float64; both nonzero.  The
    pressure inside each step is differentiated again in the replay."""
    with jax.enable_x64(True):
        integ_j, sim_j = _jax(kind, adjoint=True)
        ode_j = sim_j.epoch_fn(0.005, 30)
        state_j, aux_j = sim_j.initial_state()
        state_j = state_j._replace(cell=jnp.asarray(state_j.cell,
                                                    jnp.float64))
        g = jax.grad(lambda p: jnp.prod(ode_j(
            p, state_j, aux_j, integ_j.default_ctrl())[0].cell[-10:],
            axis=-1).mean())(sim_j.params)
        ref = np.array([float(g["sigma"]), float(g["epsilon"])])
    grads = {}
    for adjoint in (True, False):
        pair, integ, sim, state, aux = _port(kind, state_j, adjoint=adjoint)
        traj, _ = sim.epoch_fn(0.005, 30)(state, aux, integ.default_ctrl())
        torch.prod(traj.cell[-10:], dim=-1).mean().backward()
        grads[adjoint] = np.array([pair.model.sigma.grad.item(),
                                   pair.model.epsilon.grad.item()])
    assert np.all(np.abs(ref) > 1e-8)
    np.testing.assert_allclose(grads[True], grads[False], rtol=1e-9)
    np.testing.assert_allclose(grads[True], ref, rtol=1e-8)


def test_density_gradient_in_sigma_is_negative():
    """The NPT density fit's signal (tests/test_npt.py's density fit): the
    mean density of the last 10 of 30 barostatted frames falls as sigma
    grows (a larger core), so a denser target shrinks sigma; Berendsen,
    tau_p 1, P 3.6."""
    _, cls, _ = KINDS["berendsen"]
    s = _system(mt.System)
    pair = mt.PairPotentials(s, mt.potentials.LennardJones(1.0, 1.0),
                             cutoff=CUT, mode="dense", device="cpu").double()
    integ = cls(pair, s, T=T_RED / units.kB, P=3.6, Q=50.0, num_chains=3,
                tau_p=1.0, adjoint=True, device="cpu", dtype=torch.float64)
    sim = mt.Simulation(s, integ)
    state, aux = sim.initial_state()
    traj, _ = sim.epoch_fn(0.005, 30)(state, aux, integ.default_ctrl())
    rho = 108 / torch.prod(traj.cell[-10:], dim=-1).mean()
    rho.backward()
    assert rho.item() != pytest.approx(RHO)
    assert pair.model.sigma.grad.item() < 0


def test_2d_barostat_scales_only_xy():
    """A 2-D system barostats its first two axes: z keeps its length, x
    moves; the port's cell equals JAX's after 80 steps (float64)."""
    from mdgrad_tpu.lattice import square_lattice_2d
    positions, cell = square_lattice_2d(0.4, 4)
    out = {}
    for name in ("jax", "port"):
        if name == "jax":
            with jax.enable_x64(True):
                sj = SystemJ(positions, cell, dim=2)
                sj.masses = np.ones(len(positions))
                sj.set_temperature(0.2 / units.kB,
                                   rng=np.random.default_rng(4))
                pair = PairPotentialsJ(sj, potentials_j.ExcludedVolume(
                    1.0, float(np.float32(0.9)), 12), cutoff=2.0)
                integ = BerendsenJ(pair, sj, T=0.2 / units_j.kB, P=0.5,
                                   Q=30.0, num_chains=3, tau_p=0.5,
                                   adjoint=False)
                sim = SimulationJ(sj, integ)
                st, _ = sim.initial_state()
                cell0 = np.asarray(st.cell)
                sim.state, sim.aux = st._replace(
                    cell=jnp.asarray(st.cell, jnp.float64)), \
                    integ.aux_init(st.q)
                sim.simulate(80, dt=0.005, frequency=40)
                out[name] = np.asarray(sim.state.cell)
        else:
            s = mt.System(positions, cell, dim=2)
            s.masses = np.ones(len(positions))
            s.set_temperature(0.2 / units.kB, rng=np.random.default_rng(4))
            pair = mt.PairPotentials(s, mt.potentials.ExcludedVolume(
                1.0, 0.9, 12), cutoff=2.0, device="cpu").double()
            integ = mt.NPTBerendsenNHC(pair, s, T=0.2 / units.kB, P=0.5,
                                       Q=30.0, num_chains=3, tau_p=0.5,
                                       adjoint=False, device="cpu",
                                       dtype=torch.float64)
            sim = mt.Simulation(s, integ)
            st, aux = sim.initial_state()
            sim.state, sim.aux = st._replace(cell=torch.tensor(cell0)), aux
            sim.simulate(80, dt=0.005, frequency=40)
            assert len(sim.log["cell"]) == 2
            assert bool(torch.isfinite(sim.state.q).all())
            out[name] = sim.state.cell.numpy()
    z0 = float(np.float32(cell[2, 2]))
    assert out["port"][2] == pytest.approx(z0)
    assert out["port"][0] != pytest.approx(float(cell[0, 0]))
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=1e-10)


def test_rethermalize_zeroes_peps_and_update_P():
    """``rethermalize`` on an MTK state: fresh velocities (JAX's draws from
    the same numpy seed), the chain and the barostat momentum zeroed, the
    force cache stale, q and the cell kept; ``update_P`` sets the
    target."""
    with jax.enable_x64(True):
        integ_j, sim_j = _jax("mtk")
        st_j, _ = sim_j.initial_state()
        hot_j = st_j._replace(pv=jnp.full_like(st_j.pv, 3.0),
                              peps=jnp.asarray(2.0))
        new_j = rethermalize_j(hot_j, 1.1, _system(SystemJ).get_masses(),
                               rng=np.random.default_rng(3))
    _, integ, _, state, _ = _port("mtk", st_j)
    hot = state._replace(pv=torch.full_like(state.pv, 3.0),
                         peps=torch.tensor(2.0, dtype=torch.float64),
                         fv=True)
    new = rethermalize(hot, 1.1, _system(mt.System).get_masses(),
                       rng=np.random.default_rng(3))
    np.testing.assert_allclose(new.v.numpy(), np.asarray(new_j.v),
                               rtol=1e-12)
    assert new.peps.item() == 0.0 and float(new_j.peps) == 0.0
    assert float(new.pv.abs().max()) == 0.0 and new.fv is False
    assert torch.equal(new.q, hot.q) and torch.equal(new.cell, hot.cell)
    ctrl = integ.update_P(4.5)
    assert integ.P == 4.5 and ctrl["P0"].item() == 4.5
    assert set(ctrl) == set(integ_j.default_ctrl())


def test_run_npt_fit_torch_dry_run(tmp_path):
    """``scripts/run_npt_fit_torch.py --dry_run -device cpu``: the reduced
    LJ mode (truth NVT for P_target, 8 NPT epochs of 19 steps at 32
    atoms, the RDF term) writes a finite evaluated density."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(repo / "scripts" / "run_npt_fit_torch.py"),
         "--dry_run", "-device", "cpu", "-logdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "epoch    0 | loss" in proc.stdout
    out = json.loads((tmp_path / "result.json").read_text())
    assert len(out["loss_log"]) == 8
    assert np.isfinite(out["rho_best_eval"]) and np.isfinite(out["P0"])
    assert (tmp_path / "best.pt").exists()
