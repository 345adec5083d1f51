"""The sampling slice of the port end to end against the JAX package, and
the guards around the port.

End to end: the water SchNet NVT path at a narrow width -- 64 O sites on
the diamond lattice at the water density, Stack{SchNet 16/16/8 (cutoff
6.0, (N, K) table), ExcludedVolume}, Nose-Hoover chain at 298 K, dt 0.5
fs -- sampled for 2 epochs of 10 steps in float32 on both sides with the
same weights, then the 109-bin RDF over (1.8, 7.5) A on the logged frames.
The JAX side runs ``gather_mode='pallas'`` and ``rdf(backend='pallas')``
in interpret mode, as tests/test_pallas.py does.

Guards: the port imports nothing of JAX or of the JAX package and the JAX
package nothing of the port; entry points called with the default device
raise without a card; chip_smoke.py fails without one.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu import potentials as potentials_j
from mdgrad_tpu import units as units_j
from mdgrad_tpu.interface import GNNPotentials as GNNPotentialsJ
from mdgrad_tpu.interface import PairPotentials as PairPotentialsJ
from mdgrad_tpu.interface import Stack as StackJ
from mdgrad_tpu.md import NoseHooverChain as NoseHooverChainJ
from mdgrad_tpu.md import Simulation as SimulationJ
from mdgrad_tpu.nn import SchNet as SchNetJ
from mdgrad_tpu.observables import rdf as rdf_j
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt
from mdgrad_tpu_torch import ops, units
from mdgrad_tpu_torch.data.registry import get_unit_len
from mdgrad_tpu_torch.nn.convert import stack_params_from_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent
L_WATER = get_unit_len(0.99749, 18.01528, 8)
WIDTHS = {"n_atom_basis": 16, "n_filters": 16, "n_gaussians": 8,
          "n_convolutions": 2, "cutoff": 6.0}
STEPS, FREQUENCY = 22, 11          # 2 epochs x 10 steps


def _water(cls):
    s = cls.from_lattice("diamond", 2, L_WATER, symbol="O")
    s.masses = np.full(64, 18.01528)
    s.set_temperature(298.0, rng=np.random.default_rng(0))
    return s


def _run_jax():
    s = _water(SystemJ)
    stack = StackJ({
        "nn": GNNPotentialsJ(s, SchNetJ({**WIDTHS, "gather_mode": "pallas"}),
                             cutoff=6.0, capacity_slack=1.25),
        "prior": PairPotentialsJ(s, potentials_j.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense")})
    integ = NoseHooverChainJ(stack, s, T=298.0, Q=50.0, num_chains=5)
    sim = SimulationJ(s, integ)
    sim.simulate(steps=STEPS, dt=0.5 * units_j.fs, frequency=FREQUENCY)
    frames = np.stack(sim.log["positions"])
    g = rdf_j(s, 109, (1.8, 7.5), backend="pallas")(jnp.asarray(frames))[2]
    return (jax.tree_util.tree_map(np.asarray, sim.params), frames,
            np.asarray(g))


def test_sampling_slice_matches_jax():
    params, frames_j, g_j = _run_jax()
    s = _water(mt.System)
    stack = mt.Stack({
        "nn": mt.GNNPotentials(s, mt.SchNet(WIDTHS), cutoff=6.0,
                               capacity_slack=1.25, device="cpu"),
        "prior": mt.PairPotentials(s, mt.potentials.ExcludedVolume(
            sigma=2.6, epsilon=0.01, power=12), cutoff=6.0, mode="dense",
            device="cpu")})
    stack.load_state_dict(stack_params_from_numpy(params, stack))
    sim = mt.Simulation(s, mt.NoseHooverChain(stack, s, T=298.0, Q=50.0,
                                              num_chains=5, device="cpu"))
    ops.reset_counts()
    sim.simulate(steps=STEPS, dt=0.5 * units.fs, frequency=FREQUENCY)
    frames = torch.stack(sim.log["positions"])
    g = mt.observables.rdf(s, 109, (1.8, 7.5), backend="pallas",
                           device="cpu")(frames)[2]
    calls = ops.counts()["plain_calls"]
    # per step one force: 2 convolutions, each one K1 forward and one K2a +
    # one K2b in its backward; plus one force per epoch entry; sampling
    # takes no RDF gradient
    n_forces = STEPS // FREQUENCY * FREQUENCY
    assert calls == {"gather_mul_reduce": 2 * n_forces,
                     "table_gather": 2 * n_forces,
                     "table_scatter": 2 * n_forces, "table_index_csr": 0,
                     "rdf_counts": 1,
                     "rdf_counts_bwd": 0, "lj_energy_forces": 0,
                     "lj_force": 0, "lj_force_vjp": 0, "lj_force_param": 0}
    assert not sim.overflowed and not sim.drifted
    # float32 on both sides, the JAX aggregation through the bf16 hi/lo
    # split (~1.5e-5 relative per feature): positions after 20 steps agree
    # to ~1e-7 A and g(r) to ~3e-7 of its peak (measured on the CPU).  The
    # bounds are ~100x that, and 1e-5 A is far below one step's
    # displacement (~4e-3 A).
    np.testing.assert_allclose(frames.numpy(), frames_j, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_j, atol=1e-5 * g_j.max())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_jax_package_do_not_import_each_other():
    banned = ("jax", "jaxlib", "flax", "optax", "mdgrad_tpu")
    port_files = [*sorted((REPO / "mdgrad_tpu_torch").rglob("*.py")),
                  REPO / "chip_smoke.py",
                  *sorted((REPO / "scripts").glob("*_torch.py"))]
    for path in port_files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in banned, (path, mod)
    for path in sorted((REPO / "mdgrad_tpu").rglob("*.py")):
        for mod in _imports(path):
            assert mod.split(".")[0] != "mdgrad_tpu_torch", (path, mod)
    code = (
        "import importlib, pkgutil, sys, mdgrad_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'mdgrad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{banned!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_default_device_raises_without_cuda(no_cuda):
    s = _water(mt.System)
    pair = mt.PairPotentials(s, mt.potentials.ExcludedVolume(), cutoff=6.0,
                             device="cpu")
    entry_points = [
        lambda: mt.GNNPotentials(s, mt.SchNet(WIDTHS), cutoff=6.0),
        lambda: mt.PairPotentials(s, mt.potentials.ExcludedVolume(),
                                  cutoff=6.0),
        lambda: mt.NoseHooverChain(pair, s, T=298.0),
        lambda: mt.observables.rdf(s, 109, (1.8, 7.5), backend="pallas"),
    ]
    for make in entry_points:
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_chip_smoke_fails_without_cuda(no_cuda):
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
