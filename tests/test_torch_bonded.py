"""The port's bonded interactions (``BondPotentials``, ``AnglePotentials``)
against the JAX package's: energies and forces in float64 (rtol 1e-12),
with bonds and angles that cross the periodic boundary, the ``cell=``
override, and the port's float32 against its float64 (rel 1e-5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu.interface import AnglePotentials as AngleJ
from mdgrad_tpu.interface import BondPotentials as BondJ
from mdgrad_tpu.system import System as SystemJ
import mdgrad_tpu_torch as mt

L = 6.0
TOP2 = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [6, 7]])
TOP3 = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4], [3, 4, 5], [5, 6, 7]])


def chain(cls, seed=2):
    """An 8-atom zig-zag chain of ~1.1 A bonds that wraps across every
    face of a 6 A box (positions inside the box)."""
    rng = np.random.default_rng(seed)
    xyz = [np.array([5.4, 5.5, 5.6])]
    for _ in range(7):
        xyz.append(xyz[-1] + np.array([0.6, 0.7, 0.6])
                   + 0.25 * rng.standard_normal(3))
    return cls(np.mod(np.array(xyz), L), cell=np.eye(3) * L)


def _energy_forces(inter_j, inter, xyz, cell=None):
    kw = {} if cell is None else {"cell": cell}
    with jax.enable_x64(True):
        xj = jnp.asarray(xyz)
        kwj = {} if cell is None else {"cell": jnp.asarray(cell)}
        u_j = float(inter_j.energy({}, xj, (), **kwj))
        f_j = -np.asarray(jax.grad(lambda x: inter_j.energy(
            {}, x, (), **kwj))(xj))
    xt = torch.tensor(xyz, dtype=torch.float64, requires_grad=True)
    u = inter.double().energy(xt, (), **kw)
    u.backward()
    return u.item(), -xt.grad.numpy(), u_j, f_j


@pytest.mark.parametrize("kind", ["bond", "angle"])
@pytest.mark.parametrize("override", [False, True])
def test_energy_and_forces_match_jax_f64(kind, override):
    """Across the boundary (the chain's raw differences exceed L/2), with
    and without a ``cell=`` override (the same box, given as lengths):
    energies rtol 1e-12, forces atol 1e-12 of the largest."""
    sj, s = chain(SystemJ), chain(mt.System)
    xyz = s.get_positions()
    raw = np.abs(xyz[TOP2[:, 0]] - xyz[TOP2[:, 1]])
    assert (raw > L / 2).any()
    if kind == "bond":
        inter_j, inter = BondJ(sj, TOP2, 2.0, 1.3), mt.BondPotentials(
            s, TOP2, 2.0, 1.3, device="cpu")
    else:
        inter_j, inter = AngleJ(sj, TOP3, 1.5, 1.9), mt.AnglePotentials(
            s, TOP3, 1.5, 1.9, device="cpu")
    cell = np.full(3, L) if override else None
    u, f, u_j, f_j = _energy_forces(inter_j, inter, xyz, cell)
    assert u > 0 and np.abs(f_j).max() > 1e-3
    np.testing.assert_allclose(u, u_j, rtol=1e-12)
    np.testing.assert_allclose(f, f_j, rtol=0,
                               atol=1e-12 * np.abs(f_j).max())


@pytest.mark.parametrize("kind", ["bond", "angle"])
def test_float32_against_float64(kind):
    """The port in float32 against itself in float64: energy rel 1e-5,
    forces 1e-5 of the largest."""
    s = chain(mt.System)
    cls = mt.BondPotentials if kind == "bond" else mt.AnglePotentials
    top = TOP2 if kind == "bond" else TOP3
    out = {}
    for dtype in (torch.float32, torch.float64):
        inter = cls(s, top, 2.0, 1.3, device="cpu").to(dtype)
        x = torch.tensor(s.get_positions(), dtype=dtype, requires_grad=True)
        u = inter.energy(x, ())
        u.backward()
        out[dtype] = (u.item(), -x.grad.double().numpy())
    (u32, f32), (u64, f64) = out[torch.float32], out[torch.float64]
    assert abs(u32 - u64) <= 1e-5 * abs(u64)
    np.testing.assert_allclose(f32, f64, rtol=0,
                               atol=1e-5 * np.abs(f64).max())


def test_straight_angle_is_finite():
    """A straight angle (cos = -1) is clipped to 0.999999 of it: finite
    energy and forces, the energy 0.5 k (arccos(-0.999999) - thetao)^2."""
    pos = np.array([[1.0, 3.0, 3.0], [2.0, 3.0, 3.0], [3.0, 3.0, 3.0]])
    s = mt.System(pos, cell=np.eye(3) * L)
    inter = mt.AnglePotentials(s, [[0, 1, 2]], 1.0, 2.0, device="cpu")
    x = torch.tensor(pos, dtype=torch.float64, requires_grad=True)
    u = inter.double().energy(x, ())
    u.backward()
    np.testing.assert_allclose(u.item(),
                               0.5 * (np.arccos(-0.999999) - 2.0) ** 2,
                               rtol=1e-12)
    assert torch.isfinite(x.grad).all()
