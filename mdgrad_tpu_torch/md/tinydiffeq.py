"""Fixed-grid ODE solvers on arbitrary (non-uniform) time grids.

Port of ``mdgrad_tpu/md/tinydiffeq.py``: ``odeint`` steps between
successive solution times with euler, midpoint or the RK4 "3/8 rule" and
returns y at every time, row 0 being ``y0``.  The state is a tensor or a
nest of tuples, NamedTuples, lists and dicts of tensors; any other leaf
(a Python bool such as an integrator's ``fv``) is carried unchanged.
Gradients reach ``y0``, ``t`` and the parameters ``func`` closes over
through plain autograd (the JAX package differentiates its ``lax.scan``);
:func:`~mdgrad_tpu_torch.md.adjoint.make_odeint` is the memory-lean
trajectory machinery.
"""

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` and the matching leaves of
    ``rest``; a leaf that is not a tensor is taken from ``tree``."""
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return tree


def rk4_step(derivs_fn, state, t, dt):
    """One RK4 "3/8 rule" step of ``derivs_fn(state, t)`` on a state nest,
    in the JAX package's order of operations."""
    k1 = derivs_fn(state, t)
    k2 = derivs_fn(tree_map(lambda y, k: y + dt * k / 3, state, k1),
                   t + dt / 3)
    k3 = derivs_fn(tree_map(lambda y, a, b: y + dt * (-a / 3 + b),
                            state, k1, k2), t + dt * 2 / 3)
    k4 = derivs_fn(tree_map(lambda y, a, b, c: y + dt * (a - b + c),
                            state, k1, k2, k3), t + dt)
    return tree_map(lambda y, a, b, c, d: y + (a + 3 * b + 3 * c + d)
                    * (dt / 8), state, k1, k2, k3, k4)


def _euler_step(func, y, t, dt):
    return tree_map(lambda a, k: a + dt * k, y, func(t, y))


def _midpoint_step(func, y, t, dt):
    mid = tree_map(lambda a, k: a + 0.5 * dt * k, y, func(t, y))
    return tree_map(lambda a, k: a + dt * k, y, func(t + 0.5 * dt, mid))


def _rk4_step(func, y, t, dt):
    return rk4_step(lambda s, tt: func(tt, s), y, t, dt)


_STEPPERS = {"euler": _euler_step, "midpoint": _midpoint_step,
             "rk4": _rk4_step}


def odeint(func, y0, t, method="rk4", substeps=1):
    """Solve dy/dt = ``func(t, y)`` at the times ``t``.

    ``y0`` is the state at ``t[0]``; ``t`` is a (T,) tensor of strictly
    monotone times at any spacing; ``substeps`` integration steps are taken
    per output interval.  Returns the state nest with a leading T axis on
    every tensor leaf, row 0 being ``y0``.
    """
    if method not in _STEPPERS:
        raise ValueError(f"unknown method {method!r}; "
                         f"have {sorted(_STEPPERS)}")
    stepper = _STEPPERS[method]
    t = torch.as_tensor(t)
    frames, y = [y0], y0
    for i in range(t.shape[0] - 1):
        t0 = t[i]
        h = (t[i + 1] - t0) / substeps
        for s in range(substeps):
            y = stepper(func, y, t0 + s * h, h)
        frames.append(y)
    return tree_map(lambda *xs: torch.stack(xs), *frames)
