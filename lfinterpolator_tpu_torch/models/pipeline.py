"""The render pipeline: method dispatch for the fixed-focus render.

Port of ``lfinterpolator_tpu/models/pipeline.py:30-45``:

  * "STD"           -> plain PyTorch ops (ops/blend_torch.py)
  * "TEN"/"TEN_WM"  -> the hand-written Hopper shift+blend kernel
                       (ops/shift_blend.py); on CPU tensors its plain version

PyTorch runs eagerly, so there is nothing to jit; shapes, focus and
trajectory may change from call to call at no cost.
"""

from __future__ import annotations

import torch

from ..ops import blend_torch, shift_blend


def render_fixed_focus(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32
    shifts: torch.Tensor,  # [G, 2] int32 (dx, dy)
    method: str = "STD",
) -> torch.Tensor:
    """Fixed-focus render -> [V, C, H, W] uint8."""
    if method == "STD":
        return blend_torch.render_fixed(images, weights, shifts)
    if method in ("TEN", "TEN_WM"):
        return shift_blend.shift_blend(images, weights, shifts)
    raise ValueError(f"unknown method {method!r}: use 'STD' or 'TEN'/'TEN_WM'")
