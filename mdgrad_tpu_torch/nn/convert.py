"""Carry the JAX package's parameters into the port.

The JAX package keeps parameters as a pytree of arrays; tests turn it
into numpy with ``tree_map(np.asarray, params)`` and pass it here.  The
results are ``state_dict``s for ``load_state_dict``.  Four details
matter: a flax ``Dense`` kernel is (in, out) while ``nn.Linear.weight``
is (out, in); the ``Embed_0/embedding`` table has 100 rows; the readout
heads are ``<key>_d0`` and ``<key>_d1``; and with ``trainable_gauss``
each ``SchNetConv_i`` holds ``gauss_offsets`` and ``gauss_widths``, the
port's ``convs.i.offsets`` and ``convs.i.widths``.  The pair MLPs'
trees name their featurizer ``_TrainableSmearing_0`` and their layers
``Dense_k``; a ``TPairMLP`` nests its two networks as
``_PairMLPModule_0`` (E) and ``_PairMLPModule_1`` (S).  The
neural-force-field models (``nn/models.py``, ``nn/autopology.py``,
``nn/schnet_autopology.py``, ``nn/glue.py``) keep the flax names as
submodule names where they can; the functions below map the rest.
Nothing here imports JAX.
"""

import numpy as np
import torch

from ..interface import (AnglePotentials, BondPotentials, Electrostatics,
                         EwaldElectrostatics, GNNPotentials, PairPotentials,
                         TPairPotentials)
from .pair_mlp import MLP, PairMLP, TPairMLP

# flax auto-names inside SchNetConv, in creation order -> port submodules
_CONV_DENSE = {"Dense_0": "filter_in", "Dense_1": "filter_out",
               "Dense_2": "node_filter", "Dense_3": "update_in",
               "Dense_4": "update_out"}
# trainable_gauss: the Gaussian centres and widths
_CONV_GAUSS = {"gauss_offsets": "offsets", "gauss_widths": "widths"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _dense(tree, prefix):
    return {f"{prefix}.weight": _t(np.asarray(tree["kernel"]).T),
            f"{prefix}.bias": _t(tree["bias"])}


def schnet_params_from_numpy(tree):
    """``SchNet`` state_dict from a flax SchNet parameter tree."""
    state = {"embedding.weight": _t(tree["Embed_0"]["embedding"]),
             **_convs(tree, _numbered(tree, "SchNetConv_"), "convs")}
    for name in tree:
        if name.endswith("_d0"):
            key = name[:-len("_d0")]
            state.update(_dense(tree[f"{key}_d0"], f"readouts.{key}.d0"))
            state.update(_dense(tree[f"{key}_d1"], f"readouts.{key}.d1"))
    return state


def _pair_net(tree, prefix):
    """One flax ``_PairMLPModule`` tree as the port's ``_PairNet``."""
    state = {f"{prefix}smear.{k}": _t(tree["_TrainableSmearing_0"][k])
             for k in ("offsets", "widths")}
    for i in range(sum(k.startswith("Dense_") for k in tree)):
        state.update(_dense(tree[f"Dense_{i}"], f"{prefix}dense.{i}"))
    return state


def pair_mlp_params_from_numpy(tree):
    """State_dict of a ``PairMLP``, ``TPairMLP`` or ``MLP`` / ``MLP2d``
    from the flax tree of the JAX package's counterpart (its
    ``init_params()``), told apart by the tree's keys."""
    if "_PairMLPModule_0" in tree:
        return {**_pair_net(tree["_PairMLPModule_0"], "nets.0."),
                **_pair_net(tree["_PairMLPModule_1"], "nets.1.")}
    if "_TrainableSmearing_0" in tree:
        return _pair_net(tree, "net.")
    state = {}
    for i in range(len(tree)):
        state.update(_dense(tree[f"Dense_{i}"], f"dense.{i}"))
    return state


def pair_params_from_numpy(tree, pair):
    """State_dict of a ``PairPotentials`` / ``TPairPotentials`` from its
    JAX ``init_params()`` tree: a pair MLP's flax tree, an analytic
    potential's leaves (``sigma``, ``epsilon``, ``tab``, ...), and for a
    ``TPairPotentials`` the model under ``model`` beside ``kT``."""
    state = {}
    if isinstance(pair, TPairPotentials):
        state["kT"] = _t(tree["kT"])
        tree = tree["model"]
    if isinstance(pair.model, (PairMLP, TPairMLP, MLP)):
        sub = pair_mlp_params_from_numpy(tree)
    else:
        sub = {k: _t(v) for k, v in tree.items()}
    state.update({f"model.{k}": v for k, v in sub.items()})
    return state


def stack_params_from_numpy(tree, stack):
    """``Stack`` state_dict from the JAX ``Stack.init_params()`` tree:
    GNN children take :func:`schnet_params_from_numpy`, pair children
    :func:`pair_params_from_numpy`; an Ewald child its leaves as they are
    (``charges`` with ``learn_charges``, the molten-salt fit's ``qscale``),
    and the bonded terms and the cutoff Coulomb sum, which have no
    parameters, an empty tree."""
    state = {}
    for name, child in stack.models.items():
        if isinstance(child, GNNPotentials):
            sub, prefix = schnet_params_from_numpy(tree[name]), "gnn."
        elif isinstance(child, PairPotentials):
            sub, prefix = pair_params_from_numpy(tree[name], child), ""
        elif isinstance(child, (EwaldElectrostatics, Electrostatics,
                                BondPotentials, AnglePotentials)):
            sub, prefix = {k: _t(v) for k, v in tree[name].items()}, ""
        else:
            raise TypeError(f"no parameter conversion for {type(child)}")
        state.update({f"models.{name}.{prefix}{k}": v
                      for k, v in sub.items()})
    return state



def _dense_stack(tree, prefix):
    """``Dense_0 .. Dense_k`` of a flax tree as ``<prefix>.k``."""
    state = {}
    for i in range(sum(k.startswith("Dense_") for k in tree)):
        state.update(_dense(tree[f"Dense_{i}"], f"{prefix}.{i}"))
    return state


def _convs(tree, names, prefix):
    """Flax ``SchNetConv`` trees ``names`` as ``<prefix>.i``."""
    state = {}
    for i, name in enumerate(names):
        for flax_name, port_name in _CONV_DENSE.items():
            state.update(_dense(tree[name][flax_name],
                                f"{prefix}.{i}.{port_name}"))
        for flax_name, port_name in _CONV_GAUSS.items():
            if flax_name in tree[name]:
                state[f"{prefix}.{i}.{port_name}"] = _t(tree[name][flax_name])
    return state


def _numbered(tree, stem):
    return sorted((k for k in tree if k.startswith(stem)),
                  key=lambda k: int(k.rsplit("_", 1)[1]))


def graph_attention_params_from_numpy(tree):
    """``GraphAttention`` state_dict from its flax tree (``weight``)."""
    return {"weight": _t(tree["weight"])}


def edge_update_params_from_numpy(tree):
    """``SchNetEdgeUpdate`` state_dict from its flax tree."""
    return _dense_stack(tree, "dense")


def hybrid_params_from_numpy(tree, sys_n_convolutions):
    """``HybridGraphConv`` state_dict from its flax tree: the first
    ``sys_n_convolutions`` ``SchNetConv_i`` are the system stack (flax
    creates them first), the rest the molecular stack."""
    convs = _numbered(tree, "SchNetConv_")
    state = {"embedding.weight": _t(tree["Embed_0"]["embedding"]),
             **_convs(tree, convs[:sys_n_convolutions], "sys_convs"),
             **_convs(tree, convs[sys_n_convolutions:], "mol_convs"),
             **_dense(tree["Dense_0"], "d0"), **_dense(tree["Dense_1"], "d1")}
    if "v_ex_sigma" in tree:
        state["v_ex_sigma"] = _t(tree["v_ex_sigma"])
    return state


def autopology_params_from_numpy(tree):
    """``AuTopology`` state_dict from its flax tree: ``Embed_0``, the node
    convolutions, the ``<key>_<top>`` term nets (each predictor by its
    name) and the ``<key>_offset`` heads; a predictor that is not
    trainable has no tree and no parameters."""
    state = {"embedding.weight": _t(tree["Embed_0"]["embedding"])}
    convs = _numbered(tree, "_SingleNodeConv_") + _numbered(
        tree, "_DoubleNodeConv_")
    for i, name in enumerate(convs):
        state.update(_dense(tree[name]["Dense_0"], f"convs.{i}.dense"))
    for name, sub in tree.items():
        if name == "Embed_0" or name in convs:
            continue
        if name.endswith("_offset"):
            state.update(_dense_stack(sub, f"offsets.{name}.dense"))
            continue
        for pp_name, pp_tree in sub.items():
            state.update(_dense_stack(pp_tree,
                                      f"nets.{name}.pp.{pp_name}.dense"))
    return state


def schnet_autopology_params_from_numpy(tree):
    """``SchNetAuTopology`` state_dict from its ``{'schnet', 'autopology'}``
    tree."""
    return {**{f"schnet.{k}": v for k, v in
               schnet_params_from_numpy(tree["schnet"]).items()},
            **{f"autopology.{k}": v for k, v in
               autopology_params_from_numpy(tree["autopology"]).items()}}


def glue_stack_params_from_numpy(tree, stack):
    """``nn.glue.Stack`` state_dict from the JAX ``Stack.init_params()``
    tree, keyed by member name, each member a SchNet (or a
    ``GraphConvIntegration``, whose tree is SchNet's)."""
    state = {}
    for name in stack.models:
        state.update({f"models.{name}.{k}": v for k, v in
                      schnet_params_from_numpy(tree[name]).items()})
    return state
