"""Device resolution for the port's entry points.

Entry points default to the card. They run on the CPU only when the caller
asks for it (the tests do), and raise when a card is asked for and none is
present — there is no silent fallback.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
