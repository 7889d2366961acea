"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``cuda``, and asking for it on a machine without a GPU
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "foveax_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions"
        )
    return dev
