"""Carry the JAX package's parameters into the port.

The JAX package keeps parameters as a pytree of arrays; tests turn it
into numpy with ``tree_map(np.asarray, params)`` and pass it here.  The
results are ``state_dict``s for ``load_state_dict``.  Three details
matter: a flax ``Dense`` kernel is (in, out) while ``nn.Linear.weight``
is (out, in); the ``Embed_0/embedding`` table has 100 rows; and the
readout heads are ``<key>_d0`` and ``<key>_d1``.  Nothing here imports
JAX.
"""

import numpy as np
import torch

from ..interface import GNNPotentials, PairPotentials

# flax auto-names inside SchNetConv, in creation order -> port submodules
_CONV_DENSE = {"Dense_0": "filter_in", "Dense_1": "filter_out",
               "Dense_2": "node_filter", "Dense_3": "update_in",
               "Dense_4": "update_out"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _dense(tree, prefix):
    return {f"{prefix}.weight": _t(np.asarray(tree["kernel"]).T),
            f"{prefix}.bias": _t(tree["bias"])}


def schnet_params_from_numpy(tree):
    """``SchNet`` state_dict from a flax SchNet parameter tree."""
    state = {"embedding.weight": _t(tree["Embed_0"]["embedding"])}
    convs = sorted((k for k in tree if k.startswith("SchNetConv_")),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    for i, name in enumerate(convs):
        for flax_name, port_name in _CONV_DENSE.items():
            state.update(_dense(tree[name][flax_name],
                                f"convs.{i}.{port_name}"))
    for name in tree:
        if name.endswith("_d0"):
            key = name[:-len("_d0")]
            state.update(_dense(tree[f"{key}_d0"], f"readouts.{key}.d0"))
            state.update(_dense(tree[f"{key}_d1"], f"readouts.{key}.d1"))
    return state


def stack_params_from_numpy(tree, stack):
    """``Stack`` state_dict from the JAX ``Stack.init_params()`` tree:
    GNN children take :func:`schnet_params_from_numpy`, pair children their
    scalar parameters (``sigma``, ``epsilon``, ...)."""
    state = {}
    for name, child in stack.models.items():
        if isinstance(child, GNNPotentials):
            sub, prefix = schnet_params_from_numpy(tree[name]), "gnn."
        elif isinstance(child, PairPotentials):
            sub, prefix = {k: _t(v) for k, v in tree[name].items()}, "model."
        else:
            raise TypeError(f"no parameter conversion for {type(child)}")
        state.update({f"models.{name}.{prefix}{k}": v
                      for k, v in sub.items()})
    return state
