"""Default-device resolution for the port's entry points."""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says
    otherwise. Raises ``RuntimeError`` when CUDA is asked for (explicitly or
    by default) and no card is present — there is no silent CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "chambers_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU."
        )
    return device
