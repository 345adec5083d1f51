"""Glue layer: combine batch-dict models into one prediction head.

Port of ``mdgrad_tpu/nn/glue.py``: the sum (or mean) of several models'
``batched_predict`` dicts over shared keys.  The members live in a
``ModuleDict`` under ``models``, so their parameters are named
``models.<name>.*`` and a member is frozen by that prefix.
"""

from torch import nn


class Stack(nn.Module):
    """Sum/mean of several batch-dict models' predictions.

    model_dict: {name: model}, each an ``nn.Module`` with
    ``batched_predict(batch) -> {key: tensor}`` (e.g. :class:`SchNet`).
    """

    def __init__(self, model_dict, mode="sum"):
        super().__init__()
        if mode not in ("sum", "mean"):
            raise NotImplementedError(
                f"{mode} mode is not implemented for Stack")
        self.models = nn.ModuleDict(dict(model_dict))
        self.mode = mode

    def batched_predict(self, batch,
                        keys_to_combine=("energy", "energy_grad")):
        out = {}
        for model in self.models.values():
            result = model.batched_predict(batch)
            for key in keys_to_combine:
                out[key] = out[key] + result[key] if key in out \
                    else result[key]
        if self.mode == "mean":
            for key in keys_to_combine:
                out[key] = out[key] / len(self.models)
        return out

    forward = batched_predict
