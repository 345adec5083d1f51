"""SchNetAuTopology: a staged SchNet plus classical force field.

Port of ``mdgrad_tpu/nn/schnet_autopology.py``: train the AuTopology
prior first, then freeze it and switch on the SchNet correction
(:meth:`SchNetAuTopology.transfer_to_schnet`); the per-state energies can
be sorted so that energy_0 <= energy_1 <= ...  The JAX package freezes
through an optax mask (``trainable_labels``); here the same labels set
``requires_grad`` on the two submodules, ``schnet`` and ``autopology``,
whose names are the JAX tree's top-level keys.
"""

import torch
from torch import nn

from .autopology import AuTopology
from .schnet import SchNet


class SchNetAuTopology(nn.Module):
    """Combined model over one system.

    modelparams: {"schnet_params", "autopology_params",
    "sorted_result_keys", "sort_results"}; both submodels read out the
    same keys.
    """

    def __init__(self, modelparams, add_autopology=True, add_schnet=False,
                 seed=0):
        super().__init__()
        keys = tuple(modelparams["sorted_result_keys"])
        self.schnet = SchNet(dict(modelparams["schnet_params"],
                                  readout_keys=keys), seed=seed)
        self.autopology = AuTopology(dict(modelparams["autopology_params"],
                                          output_keys=keys), seed=seed + 1)
        self.sorted_result_keys = keys
        self.sort_results = modelparams.get("sort_results", False)
        self.add_autopology = add_autopology
        self.add_schnet = add_schnet

    def transfer_to_schnet(self):
        """The stage switch: add SchNet on top of the AuTopology prior,
        which is frozen; returns :meth:`trainable_labels`."""
        self.add_schnet = True
        labels = self.trainable_labels()
        for name, label in labels.items():
            getattr(self, name).requires_grad_(label == "train")
        return labels

    def trainable_labels(self):
        """{'schnet' | 'autopology' -> 'train' | 'frozen'}."""
        return {"schnet": "train" if self.add_schnet else "frozen",
                "autopology": "frozen" if self.add_schnet else "train"}

    def energies(self, z, xyz, nbrs_idx, offsets_real, nbr_mask, tops,
                 top_masks):
        """Per-state energies (K,), ordered as ``sorted_result_keys``
        (sorted with ``sort_results``); SchNet over the (P, 2) pair list
        ``nbrs_idx`` with real-space offsets."""
        total = xyz.new_zeros(len(self.sorted_result_keys))
        if self.add_schnet:
            out = self.schnet.atomwise(z, xyz, nbrs_idx, nbr_mask,
                                       offsets_real=offsets_real,
                                       edge_format="pairs")
            total = total + torch.stack(
                [out[k].sum() for k in self.sorted_result_keys])
        if self.add_autopology:
            out = self.autopology.atomwise(z, xyz, tops, top_masks)
            total = total + torch.stack(
                [out[k] for k in self.sorted_result_keys])
        if self.sort_results:
            total = torch.sort(total).values
        return total

    def energies_and_forces(self, z, xyz, nbrs_idx, offsets_real, nbr_mask,
                            tops, top_masks):
        """(energies (K,), forces (K, N, 3)), each state's force its own
        -dE_k/dxyz (reverse mode, one pass a state)."""
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            x = xyz.detach().requires_grad_(True)
            energies = self.energies(z, x, nbrs_idx, offsets_real,
                                     nbr_mask, tops, top_masks)
            grads = [torch.autograd.grad(e, x, retain_graph=True,
                                         create_graph=create_graph)[0]
                     for e in energies]
        return energies, -torch.stack(grads)
