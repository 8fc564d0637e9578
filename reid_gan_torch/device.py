"""Device resolution for the port's entry points.

The port runs on the card. The CPU is used only when the caller names it
(the CPU tests do); a missing GPU is an error, never a silent fallback.
"""

import torch


def resolve_device(device=None):
    """``None`` → ``cuda``. Raises when a CUDA device is asked for (or
    implied) and none is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return device
