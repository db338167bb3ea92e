"""Where the port's entry points put their tensors.

Every entry point that takes ``device=None`` runs on the card: ``None``
means ``cuda``. Without a CUDA device that raises; the CPU is used only
when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises when no CUDA device is present); any
    other value → ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
