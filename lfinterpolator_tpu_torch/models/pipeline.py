"""The render pipeline: method dispatch for the fixed-focus and the
all-in-focus render.

Port of ``lfinterpolator_tpu/models/pipeline.py`` (``render_fixed_focus``
:30-45; ``compute_focus_maps``, ``blend_all_focus``, ``render_all_focus``
:55-86, 337-454). Fixed focus:

  * "STD"           -> plain PyTorch ops (ops/blend_torch.py)
  * "TEN"/"TEN_WM"  -> the hand-written Hopper shift+blend kernel
                       (ops/shift_blend.py); on CPU tensors its plain version

All-in-focus (``focus_range > 0``), both methods, as the JAX package routes
them when its kernels are available (``pipeline.py:359-390``): the estimate
kernel (ops/focus_estimate.py), the box filter in torch ops, and the fused
per-pixel-focus blend kernel (ops/allfocus_blend.py); on CPU tensors their
plain versions. STD blends with the filtered map, TEN with the raw one
(the reference's asymmetry, ``pipeline.py:135``).

PyTorch runs eagerly, so there is nothing to jit; shapes, focus and
trajectory may change from call to call at no cost.
"""

from __future__ import annotations

import torch

from ..state import FocusTables
from ..ops import allfocus_blend, blend_torch, focus_estimate, focus_torch, shift_blend


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


def compute_focus_maps(
    images: torch.Tensor,  # [G, C, H, W] uint8
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    focus_ids: torch.Tensor,  # [K] int64
    tables: FocusTables,
    *,
    radius: tuple[int, int],
    filter_radius: tuple[int, int],
    exact_taps: bool = True,
) -> torch.Tensor:
    """Estimate + filter -> maps [2, H, W] uint8 (raw, filtered)."""
    map0 = focus_estimate.focus_estimate(
        images[focus_ids], offsets[focus_ids], tables, radius, exact_taps
    )
    map1 = focus_torch.filter_focus_map(map0, filter_radius)
    return torch.stack([map0, map1])


def blend_all_focus(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    maps: torch.Tensor,  # [2, H, W] uint8 (from compute_focus_maps)
    decode: torch.Tensor,  # [256] float32
    method: str = "STD",
) -> torch.Tensor:
    """Per-pixel-focus blend -> views [V, C, H, W] uint8."""
    if method not in ("STD", "TEN", "TEN_WM"):
        raise ValueError(f"unknown method {method!r}: use 'STD' or 'TEN'/'TEN_WM'")
    fmap = maps[1] if method == "STD" else maps[0]
    return allfocus_blend.allfocus_blend(images, weights, offsets, fmap, decode)


def render_all_focus(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    focus_ids: torch.Tensor,  # [K] int64
    tables: FocusTables,
    *,
    method: str = "STD",
    radius: tuple[int, int],
    filter_radius: tuple[int, int],
    exact_taps: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-in-focus render: estimate -> filter -> per-pixel blend.

    Returns (views [V, C, H, W] uint8, maps [2, H, W] uint8).
    """
    maps = compute_focus_maps(
        images, offsets, focus_ids, tables, radius=radius,
        filter_radius=filter_radius, exact_taps=exact_taps,
    )
    views = blend_all_focus(
        images, weights, offsets, maps, tables.decode, method=method
    )
    return views, maps
