"""The multi-state driver's schedules (train/optim.py) against optax: the
plateau schedule with cooldown and accumulation against
``optax.contrib.reduce_on_plateau``, scale for scale, and the cosine decay
against ``optax.cosine_decay_schedule``, alone and inside the update
(``clip_by_global_norm -> adam(cosine schedule)``, the JAX multistate
driver's ``lr_schedule='cosine'`` chain)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdgrad_tpu_torch.train.optim import (FitUpdate, ReduceOnPlateau,
                                          cosine_decay)


def _plateau_values(rng):
    """Improvements, a long noisy plateau with a NaN in it, one more
    improvement, and a second plateau: long enough for the driver's
    schedule (patience 30 and cooldown 30 averages of 5) to reach its
    floor."""
    vals = list(np.linspace(5.0, 2.0, 60))
    vals += list(2.0 + 0.01 * rng.standard_normal(700))
    vals[400] = float("nan")
    vals += list(np.linspace(1.9, 1.0, 20))
    vals += list(1.0 + 0.01 * rng.standard_normal(1400))
    return vals


@pytest.mark.parametrize("patience,cooldown,accumulation_size,min_scale", [
    (30, 30, 5, 0.05),      # fit_rdf_multistate's plateau schedule
    (3, 2, 5, 0.05),
    (4, 6, 1, 1e-3),
])
def test_plateau_cooldown_accumulation_matches_optax(
        patience, cooldown, accumulation_size, min_scale):
    """ReduceOnPlateau with cooldown and accumulation gives
    optax.contrib.reduce_on_plateau's scale at every step, bit for bit
    (both in float32), down to the floor; a snapshot restores the same
    sequence."""
    kw = dict(factor=0.5, patience=patience, cooldown=cooldown,
              accumulation_size=accumulation_size, min_scale=min_scale,
              atol=1e-5)
    rop = optax.contrib.reduce_on_plateau(**kw)
    params = {"w": jnp.zeros(3)}
    state = rop.init(params)

    @jax.jit
    def step(state, value):
        _, state = rop.update(params, state, params, value=value)
        return state.scale, state

    plateau = ReduceOnPlateau(**kw)
    scales = []
    for value in _plateau_values(np.random.default_rng(5)):
        ref, state = step(state, jnp.asarray(value, jnp.float32))
        got = plateau.update(value)
        assert got == float(ref), (len(scales), value, got, float(ref))
        scales.append(got)
    fired = [k for k in range(1, len(scales)) if scales[k] != scales[k - 1]]
    assert len(fired) >= 3
    # consecutive firings are at least patience + cooldown averages apart
    gaps = np.diff(fired)
    assert gaps.min() >= (patience + cooldown) * accumulation_size
    assert scales[-1] == float(np.float32(min_scale))
    again = ReduceOnPlateau(**kw)
    again.load_state_dict(plateau.state_dict())
    for value in (1.0, 0.5, 0.4, 0.3, 0.2, 0.1):
        assert again.update(value) == plateau.update(value)


@pytest.mark.parametrize("n_steps,alpha", [(500, 0.05), (7, 0.05),
                                           (1, 0.0)])
def test_cosine_decay_matches_optax(n_steps, alpha):
    """cosine_decay(n, alpha)(k) against optax.cosine_decay_schedule(1, n,
    alpha)(k) in float64 for k from 0 to n + 2: within 1e-14
    relative."""
    factor = cosine_decay(n_steps, alpha)
    with jax.enable_x64(True):
        sched = optax.cosine_decay_schedule(1.0, n_steps, alpha)
        want = [float(sched(jnp.asarray(k))) for k in range(n_steps + 3)]
    got = [factor(k) for k in range(n_steps + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    assert got[0] == 1.0 and got[-1] == pytest.approx(alpha, abs=1e-15)


def test_fit_update_cosine_matches_optax_chain():
    """FitUpdate with the cosine schedule against the JAX multistate
    driver's chain clip_by_global_norm(10) -> adam(cosine_decay_schedule(
    lr, 6, 0.05)), over 8 steps (past the decay's end), the update times
    the step scales of a NaN recovery.  Float32 formulas in another
    order: ~1 ulp of |p| < 4."""
    rng = np.random.default_rng(13)
    shapes = [(5, 3), (3,), (4, 4, 2)]
    p0 = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    grads = [[(rng.normal(size=sh) * s).astype(np.float32) for sh in shapes]
             for s in (0.5, 8.0, 2.0, 1.0, 0.1, 3.0, 1.0, 0.3)]
    step_scales = [1.0, 0.5, 0.63, 0.25, 0.315, 1.0, 1.0, 0.5]
    lr, n = 1e-3, 6
    opt = optax.chain(optax.clip_by_global_norm(10.0),
                      optax.adam(optax.cosine_decay_schedule(lr, n, 0.05)))
    params_j = [jnp.asarray(x) for x in p0]
    state = opt.init(params_j)
    for g, sc in zip(grads, step_scales):
        upd, state = opt.update([jnp.asarray(x) for x in g], state,
                                params_j)
        upd = jax.tree_util.tree_map(lambda u: u * jnp.asarray(sc), upd)
        params_j = optax.apply_updates(params_j, upd)

    params = [torch.nn.Parameter(torch.tensor(x)) for x in p0]
    update = FitUpdate(params, lr, 10.0, schedule=cosine_decay(n, 0.05))
    for g, sc in zip(grads, step_scales):
        for p, x in zip(params, g):
            p.grad = torch.tensor(x)
        update(None, sc)
    assert update.count == len(grads)
    for p, ref, start in zip(params, params_j, p0):
        assert np.abs(np.asarray(ref) - start).max() > 1e-4
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=5e-7)
