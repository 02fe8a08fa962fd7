"""The device an entry point runs on, checked once.

Every entry point of the port (``Interpolator``, ``StreamingRenderer``,
the CLI, the scripts) runs on the card unless the caller asks for the CPU,
and none falls back from one to the other: ``device="cuda"`` without a
CUDA device raises here.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device, what: str = "the render") -> torch.device:
    """`device` as a ``torch.device``: "cpu" (the plain PyTorch path) or
    "cuda", which raises ``RuntimeError`` when no CUDA device is present.
    `what` names the work in that message."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA is not available: {what} needs a CUDA device "
            "(pass device='cpu' for the plain PyTorch path)"
        )
    return device

