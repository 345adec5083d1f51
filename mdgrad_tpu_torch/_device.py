"""Device selection shared by the port's entry points."""

import torch


def resolve_device(device):
    """``torch.device`` for an entry point's ``device`` argument.

    A CUDA device without a card raises: the port never falls back to the
    CPU on its own, so a run that asked for the card cannot silently
    measure the CPU.  TF32 is switched off for matmuls and convolutions,
    the counterpart of the JAX package's ``precision=HIGHEST`` geometry
    products: TF32 keeps about three decimal digits, too few for
    minimum-image decisions and for the f32 parity this port is held to.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
