"""Bit-faithful NumPy oracle of the reference CUDA kernels.

The port's own copy of ``lfinterpolator_tpu/ops/reference.py`` (NumPy only,
with the port's ``core/geometry.py``; ``tests/test_torch_copies.py`` holds
the two equal).

This module reproduces, in plain NumPy and with the reference's exact numeric
semantics, the device kernels in reference: src/kernels.cu. It is the ground
truth for the fast XLA / Pallas paths and runs on the host (use small images
in tests).

Semantics reproduced exactly:
  * clamped surface reads (cudaBoundaryModeClamp, src/kernels.cu:123-125)
  * fixed-focus integer shifts (focusCoords, src/kernels.cu:72-76)
  * per-pixel focus shifts with C truncation-toward-zero int casts
    (src/kernels.cu:78-82)
  * fp16-quantized weights, float32 accumulation, round-half-to-even output
    conversion (__float2int_rn, src/kernels.cu:292-310)
  * the 32-step disparity search with a 3x3 stencil of Chebyshev color ranges
    over 32 selected views (src/kernels.cu:164-258)
  * the asymmetric [c-r, c+r) box filter of the focus map (src/kernels.cu:260-280)

Known semantic pin: per-pixel focus coordinates are computed as
trunc(f32(coord) + f32(focus*offset)) -- two roundings (multiply, then add).
nvcc's default FMA contraction could compile the reference's
`coords.x + focus * offset.x` (src/kernels.cu:81) to a single-rounding fmaf,
which would differ from this oracle in the rare case where the product lies
within half an ulp of an integer boundary. Without CUDA hardware this cannot
be verified; the mul-then-add semantics are pinned here and every fast path
matches THEM bit-for-bit.

Conscious fixes (documented deviations):
  * outputs are clipped to [0, 255] before the uint8 cast -- the reference's
    uchar cast wraps on overflow, which can only happen through fp16 weight
    rounding pushing the sum epsilon above 255 (src/kernels.cu:301-310)
  * a filter radius of 0 copies the unfiltered map instead of dividing by zero
    (src/kernels.cu:271-277)
"""

from __future__ import annotations

import numpy as np

from ..core import geometry


def _clip_coords(y: np.ndarray, x: np.ndarray, h: int, w: int):
    return np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)


def _shift_clamped(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """img[clip(y+dy), clip(x+dx)] for every pixel (y, x)."""
    h, w = img.shape[:2]
    ys = np.clip(np.arange(h) + int(dy), 0, h - 1)
    xs = np.clip(np.arange(w) + int(dx), 0, w - 1)
    return img[np.ix_(ys, xs)]


def _round_nearest_even_u8(acc: np.ndarray) -> np.ndarray:
    """__float2int_rn + clip to uint8 (src/kernels.cu:301-310)."""
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def blend_fixed(
    images: np.ndarray,  # [G, H, W, C>=3] uint8
    weights_f16: np.ndarray,  # [V, G] float16
    offsets_px: np.ndarray,  # [G, 2] int32 (dx, dy)
) -> np.ndarray:
    """Standard fixed-focus blend (Standard::process<false>, src/kernels.cu:312-342).

    Returns [V, H, W, 3] uint8.
    """
    g_count, h, w = images.shape[:3]
    v_count = weights_f16.shape[0]
    acc = np.zeros((v_count, h, w, 3), dtype=np.float32)
    wf = weights_f16.astype(np.float32)
    for g in range(g_count):
        px = _shift_clamped(images[g, :, :, :3], offsets_px[g, 1], offsets_px[g, 0])
        acc += wf[:, g][:, None, None, None] * px.astype(np.float32)[None]
    return _round_nearest_even_u8(acc)


def blend_fixed_fp16acc(
    images: np.ndarray,  # [G, H, W, C>=3] uint8
    weights_f16: np.ndarray,  # [V, G] float16
    offsets_px: np.ndarray,  # [G, 2] int32 (dx, dy)
    batch: int = 16,
) -> np.ndarray:
    """TEN_WM **half-accumulation** emulation (Tensors::process: the WMMA
    accumulator fragments are half, src/kernels.cu:420-425, one mma_sync per
    16-image batch, src/kernels.cu:432-448).

    Model: pixels and weights are half before the product (the CUDA kernel
    stages both as half, src/kernels.cu:372-385, 436-437); each 16-image mma
    step's dot is computed at full precision (tensor cores sum the step's K
    products in a wide accumulator); the add into the running half
    accumulator rounds to nearest-even fp16 once per step. Output conversion
    matches __float2int_rn.

    This is NOT a path the port renders with -- every production path
    accumulates in f32 (strictly more precise than the reference tensor
    kernel). It exists so users comparing against the actual CUDA binary's
    TEN_WM output can separate *expected* fp16 accumulation loss from real
    divergence (see the PARITY.md row quantifying the PSNR of f32-vs-fp16
    accumulation at the gate config). Returns [V, H, W, 3] uint8.
    """
    g_count, h, w = images.shape[:3]
    v_count = weights_f16.shape[0]
    acc = np.zeros((v_count, h, w, 3), dtype=np.float16)
    wh = weights_f16.astype(np.float16)
    for b0 in range(0, g_count, batch):
        idx = range(b0, min(b0 + batch, g_count))
        shifted = np.stack([
            _shift_clamped(
                images[g, :, :, :3], offsets_px[g, 1], offsets_px[g, 0]
            ).astype(np.float16)
            for g in idx
        ])  # [B, H, W, 3] (u8 values are exact in fp16)
        part = np.einsum(
            "vb,bhwc->vhwc",
            wh[:, list(idx)].astype(np.float32),
            shifted.astype(np.float32),
        )
        acc = (acc.astype(np.float32) + part).astype(np.float16)
    return _round_nearest_even_u8(acc.astype(np.float32))


def focus_values_from_map(
    focus_map: np.ndarray, focus: float, focus_range: float
) -> np.ndarray:
    """Decode a uint8 focus map to per-pixel focus values.

    focus + byte/255 * range (loadFocusFromMap, src/kernels.cu:134-137).
    """
    return (
        np.float32(focus)
        + focus_map.astype(np.float32) / np.float32(255) * np.float32(focus_range)
    ).astype(np.float32)


def blend_allfocus(
    images: np.ndarray,  # [G, H, W, C>=3] uint8
    weights_f16: np.ndarray,  # [V, G] float16
    offsets: np.ndarray,  # [G, 2] float32 (x, y)
    focus_map: np.ndarray,  # [H, W] uint8
    focus: float,
    focus_range: float,
) -> np.ndarray:
    """Per-pixel-focus blend (Standard::process<true>, src/kernels.cu:312-342).

    Per-pixel source coordinate: int(coord + focusValue * offset), where the
    int cast truncates toward zero (focusCoords, src/kernels.cu:78-82).
    Returns [V, H, W, 3] uint8.
    """
    g_count, h, w = images.shape[:3]
    v_count = weights_f16.shape[0]
    fv = focus_values_from_map(focus_map, focus, focus_range)  # [H, W]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    acc = np.zeros((v_count, h, w, 3), dtype=np.float32)
    wf = weights_f16.astype(np.float32)
    for g in range(g_count):
        cx = np.trunc(xx.astype(np.float32) + fv * offsets[g, 0]).astype(np.int64)
        cy = np.trunc(yy.astype(np.float32) + fv * offsets[g, 1]).astype(np.int64)
        cy, cx = _clip_coords(cy, cx, h, w)
        px = images[g, :, :, :3][cy, cx]  # [H, W, 3]
        acc += wf[:, g][:, None, None, None] * px.astype(np.float32)[None]
    return _round_nearest_even_u8(acc)


def focus_map_estimate(
    images: np.ndarray,  # [G, H, W, C>=3] uint8
    offsets: np.ndarray,  # [G, 2] float32 (x, y)
    view_ids: np.ndarray,  # [K] int
    focus: float,
    focus_range: float,
    radius: tuple[int, int],  # (rx, ry)
    steps: int = 32,
) -> np.ndarray:
    """Per-pixel disparity search (FocusMap::estimate, src/kernels.cu:239-258).

    For each of `steps` candidates f, the cost is the sum over a 3x3 stencil
    (spacing = radius) of the Chebyshev distance between the per-channel
    min and max over the selected views, sampled at
    int(coord + f*offset_view) + stencil offset, clamped
    (focusDispersion, src/kernels.cu:196-217). The first strict minimum wins
    (MinDispersion, src/kernels.cu:219-237).

    Returns the uint8 focus map ((best-focus)/range * 255, rounded half away
    from zero, src/kernels.cu:253-257).
    """
    h, w = images.shape[1:3]
    rx, ry = int(radius[0]), int(radius[1])
    yy, xx = np.meshgrid(
        np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij"
    )
    candidates = geometry.focus_candidates(focus, focus_range, steps)

    best_cost = np.full((h, w), np.finfo(np.float32).max, dtype=np.float32)
    best_focus = np.zeros((h, w), dtype=np.float32)

    stencil = [(sx, sy) for sx in (-rx, 0, rx) for sy in (-ry, 0, ry)]

    for f in candidates:
        mins = np.full((9, h, w, 3), np.inf, dtype=np.float32)
        maxs = np.full((9, h, w, 3), -np.inf, dtype=np.float32)
        for vid in view_ids:
            # focusCoords float path: int cast truncates toward zero.
            cx0 = np.trunc(xx + np.float32(f) * offsets[vid, 0]).astype(np.int64)
            cy0 = np.trunc(yy + np.float32(f) * offsets[vid, 1]).astype(np.int64)
            for i, (sx, sy) in enumerate(stencil):
                cy, cx = _clip_coords(cy0 + sy, cx0 + sx, h, w)
                px = images[vid, :, :, :3][cy, cx].astype(np.float32)
                np.minimum(mins[i], px, out=mins[i])
                np.maximum(maxs[i], px, out=maxs[i])
        cost = np.zeros((h, w), dtype=np.float32)
        for i in range(9):
            cost += np.max(maxs[i] - mins[i], axis=-1)  # Chebyshev over channels
        better = cost < best_cost
        best_cost = np.where(better, cost, best_cost)
        best_focus = np.where(better, np.float32(f), best_focus)

    normalized = (best_focus - np.float32(focus)) / np.float32(focus_range)
    return geometry.round_half_away(normalized * np.float32(255)).astype(np.uint8)


def focus_map_filter(focus_map: np.ndarray, radius: tuple[int, int]) -> np.ndarray:
    """Box filter of the focus map (FocusMap::filter, src/kernels.cu:260-280).

    The reference window is asymmetric: x in [cx-rx, cx+rx), y in [cy-ry, cy+ry)
    (2rx * 2ry taps, clamped reads), averaged and rounded half away from zero.
    A radius of 0 returns the map unchanged (the reference divides by zero).
    """
    rx, ry = int(radius[0]), int(radius[1])
    if rx == 0 or ry == 0:
        return focus_map.copy()
    h, w = focus_map.shape
    acc = np.zeros((h, w), dtype=np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for dx in range(-rx, rx):
        for dy in range(-ry, ry):
            cy, cx = _clip_coords(yy + dy, xx + dx, h, w)
            acc += focus_map[cy, cx].astype(np.float32)
    acc /= np.float32(4 * rx * ry)
    return geometry.round_half_away(acc).astype(np.uint8)
