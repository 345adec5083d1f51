"""The port's pair MLPs (mdgrad_tpu_torch/nn/pair_mlp.py) against the JAX
package's flax modules (mdgrad_tpu/nn/pair_mlp.py), their weights carried
across by ``nn/convert.py``, and the activations table against jax.nn.

Single evaluations in float32 within 1e-5 of max(|ref|, 1): u, du/dr and
each parameter's gradient, on distances made with numpy from a seed.  The
JAX suite's pair-MLP tests (tests/test_potentials.py) run on the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgrad_tpu.nn import MLP as MLPJ
from mdgrad_tpu.nn import MLP2d as MLP2dJ
from mdgrad_tpu.nn import PairMLP as PairMLPJ
from mdgrad_tpu.nn import TPairMLP as TPairMLPJ
from mdgrad_tpu.nn.layers import ACTIVATIONS as ACT_J
from mdgrad_tpu_torch.nn import MLP, MLP2d, PairMLP, TPairMLP
from mdgrad_tpu_torch.nn.convert import pair_mlp_params_from_numpy
from mdgrad_tpu_torch.nn.layers import ACTIVATIONS

TOL = 1e-5


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref,
                                                             dtype=np.float64)
    scale = max(np.abs(ref).max(), 1.0)
    err = np.abs(got - ref).max()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol * scale:.3e}"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(ACT_J))
def test_activations_match_jax(name):
    """Each named activation (SELU's alpha and scale, ELU's and CELU's
    alpha, LeakyReLU's slope, ...) against jax.nn on [-6, 6], value and
    derivative, in float32 within 1e-6 (a few ulp)."""
    assert set(ACTIVATIONS) == set(ACT_J)
    x = np.linspace(-6.0, 6.0, 241).astype(np.float32)
    ref = ACT_J[name](jnp.asarray(x))
    dref = jax.vmap(jax.grad(ACT_J[name]))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = ACTIVATIONS[name](xt)
    (dy,) = torch.autograd.grad(y.sum(), xt)
    _close(y.detach().numpy(), ref, name, 1e-6)
    # away from the kinks at 0 (and ReLU6's at 6)
    smooth = (np.abs(x) > 1e-3) & (np.abs(x - 6.0) > 1e-3)
    _close(dy.numpy()[smooth], np.asarray(dref)[smooth], f"d{name}", 1e-6)


# (name, JAX module, port module, call arguments beyond r)
def _pair(res):
    kw = dict(n_gauss=12, r_start=0.0, r_end=2.5, n_layers=2, n_width=16,
              nonlinear="SELU", res=res)
    return PairMLPJ(**kw), PairMLP(**kw, device="cpu")


MODELS = {
    "PairMLP": lambda: _pair(False),
    "PairMLP-res": lambda: _pair(True),
    "TPairMLP": lambda: (
        TPairMLPJ(n_gauss=12, r_start=0.0, r_end=2.5, n_layers=1,
                  n_width=16, nonlinear="ELU"),
        TPairMLP(n_gauss=12, r_start=0.0, r_end=2.5, n_layers=1,
                 n_width=16, nonlinear="ELU", device="cpu")),
    "MLP": lambda: (MLPJ(H=16, num_layers=2, act="Tanh"),
                    MLP(H=16, num_layers=2, act="Tanh", device="cpu")),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pair_mlp_matches_jax(name):
    """JAX-initialised weights in the port: u, du/dr and the gradient of
    sum(u) in every parameter (TPairMLP at kT = 0.3)."""
    mj, mt = MODELS[name]()
    p = mj.init_params(jax.random.PRNGKey(4))
    mt.load_state_dict(pair_mlp_params_from_numpy(_np(p)))
    r = np.sort(np.random.default_rng(5).uniform(0.5, 2.5, 50)).astype(
        np.float32)[:, None]
    extra = (0.3,) if name == "TPairMLP" else ()
    u_j = mj(p, jnp.asarray(r), *extra)
    du_j = jax.grad(lambda x: mj(p, x, *extra).sum())(jnp.asarray(r))
    g_j = _np(jax.grad(lambda q: mj(q, jnp.asarray(r), *extra).sum())(p))
    rt = torch.tensor(r, requires_grad=True)
    u = mt(rt, *extra)
    assert u.shape == (50, 1)
    grads = torch.autograd.grad(u.sum(), [rt, *mt.parameters()])
    _close(u.detach().numpy(), u_j, f"{name} u")
    _close(grads[0].numpy(), du_j, f"{name} du/dr")
    ref = pair_mlp_params_from_numpy(g_j)
    names = [k for k, _ in mt.named_parameters()]
    assert sorted(names) == sorted(ref)
    for k, g in zip(names, grads[1:]):
        _close(g.numpy(), ref[k].numpy(), f"{name} d/d{k}")


def test_mlp2d_matches_jax():
    mj, mt = MLP2dJ(H=16, num_layers=1), MLP2d(H=16, num_layers=1,
                                               device="cpu")
    p = mj.init_params(jax.random.PRNGKey(6))
    mt.load_state_dict(pair_mlp_params_from_numpy(_np(p)))
    xy = np.random.default_rng(7).normal(size=(9, 2)).astype(np.float32)
    _close(mt(torch.tensor(xy)).detach().numpy(), mj(p, jnp.asarray(xy)),
           "MLP2d")
    assert mt(torch.tensor([0.1, 0.2])).shape == (1,)


def test_seeded_init_follows_flax():
    """The port draws its own weights: the same seed gives the same
    weights, another seed others; the smearing starts at the flax values
    (evenly spaced centres, widths the spacing), biases at 0, kernels
    LeCun-normal truncated at 2 sigma."""
    a = PairMLP(25, 0.0, 2.5, 3, 128, device="cpu")
    b = PairMLP(25, 0.0, 2.5, 3, 128, device="cpu")
    c = PairMLP(25, 0.0, 2.5, 3, 128, seed=1, device="cpu")
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), k
        if k.endswith("weight"):
            assert not torch.equal(x, z), k
    ref = _np(PairMLPJ(25, 0.0, 2.5, 3, 128).init_params())
    np.testing.assert_array_equal(
        a.net.smear.offsets.detach().numpy(),
        ref["_TrainableSmearing_0"]["offsets"])
    np.testing.assert_array_equal(
        a.net.smear.widths.detach().numpy(),
        ref["_TrainableSmearing_0"]["widths"])
    w = a.net.dense[2].weight.detach().numpy()
    std = np.sqrt(1.0 / 128) / 0.87962566103423978
    assert np.abs(w).max() <= 2 * std + 1e-7
    assert abs(w.std() / np.asarray(ref["Dense_2"]["kernel"]).std() - 1) < 0.05
    assert not a.net.dense[2].bias.detach().any()


# ---- tests/test_potentials.py's pair-MLP tests, on the port ---------------

def test_pair_mlp_shapes_and_grad():
    m = PairMLP(n_gauss=8, r_start=0.0, r_end=2.5, n_layers=1, n_width=16,
                nonlinear="SELU", device="cpu")
    r = torch.linspace(0.5, 2.0, 7)[:, None]
    u = m(r)
    assert u.shape == (7, 1)
    u.sum().backward()
    assert sum(p.grad.abs().sum().item() for p in m.parameters()) > 0


def test_tpair_mlp_temperature_dependence():
    m = TPairMLP(n_gauss=8, r_start=0.0, r_end=2.5, n_layers=1, n_width=16,
                 device="cpu")
    r = torch.ones((3, 1))
    with torch.no_grad():
        u1, u2 = m(r, torch.tensor(0.1)), m(r, torch.tensor(0.5))
    assert not np.allclose(u1.numpy(), u2.numpy())


def test_mlp_excluded_volume_core():
    m = MLP(H=8, num_layers=1, device="cpu")
    with torch.no_grad():
        small = m(torch.tensor([[0.1]]))[0, 0].item()
        large = m(torch.tensor([[2.0]]))[0, 0].item()
    assert small > 1e6
    assert abs(large) < 1e3
