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
kernel (ops/focus_estimate.py) -- or, given a ``pyramid`` plan
(``--focus-pyramid``), the coarse-to-fine estimate on the same kernel --
the box filter in torch ops, and the fused per-pixel-focus blend kernel
(ops/allfocus_blend.py); on CPU tensors their plain versions. STD blends
with the filtered map, TEN with the raw one (the reference's asymmetry,
``pipeline.py:135``).

Row blocks: ``render_fixed_focus``, ``estimate_focus`` and
``blend_all_focus`` take ``row_start`` and ``row_count`` and render only
those rows of the frame (one rank's rows of a multi-GPU render,
``parallel/mesh.py``, which gathers the raw map between the estimate and
the filter); the defaults render the frame. ``FocusBands`` estimates a
frame's raw map band by band on one prepared estimate, so that a TEN
frame rendered in row bands (``api._OnePass``) blends each band right
after its rows are estimated, and filters after the last. The estimate
of a frame counts its row blocks as ``estimate bands``
(``profiling.launch_counts``): 1 for a whole-frame estimate.

PyTorch runs eagerly, so there is nothing to jit; shapes, focus and
trajectory may change from call to call at no cost.
"""

from __future__ import annotations

import torch

from ..ops import allfocus_blend, blend_torch, focus_estimate, focus_torch, shift_blend
from ..ops.estimate_geometry import FocusTables, Pyramid
from ..utils import profiling


def render_fixed_focus(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32
    shifts: torch.Tensor,  # [G, 2] int32 (dx, dy)
    method: str = "STD",
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """Fixed-focus render of a block of rows -> [V, C, hb, W] uint8."""
    with profiling.span("lfi.blend"):
        if method == "STD":
            return blend_torch.render_fixed(images, weights, shifts, row_start, row_count)
        if method in ("TEN", "TEN_WM"):
            return shift_blend.shift_blend(images, weights, shifts,
                                           row_start=row_start, row_count=row_count)
    raise ValueError(f"unknown method {method!r}: use 'STD' or 'TEN'/'TEN_WM'")


def estimate_focus(
    images: torch.Tensor,  # [G, C, H, W] uint8
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    focus_ids: torch.Tensor,  # [K] int64
    tables: FocusTables,
    *,
    radius: tuple[int, int],
    exact_taps: bool = True,
    pyramid: Pyramid | None = None,
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """The raw focus map of a block of rows -> [hb, W] uint8.

    `pyramid` (exact taps, the whole frame only) runs the approximate
    coarse-to-fine estimate instead of the full sweep. Counts one
    ``estimate bands``."""
    profiling.count("estimate bands")
    selected, sel_offsets = images[focus_ids], offsets[focus_ids]
    if pyramid is None:
        return focus_estimate.focus_estimate(
            selected, sel_offsets, tables, radius, exact_taps,
            row_start=row_start, row_count=row_count)
    if not exact_taps:
        raise ValueError("the focus pyramid is exact-taps only")
    if blend_torch.row_block(images.shape[2], row_start, row_count) != (0, images.shape[2]):
        raise ValueError("the focus pyramid estimates the whole frame only")
    return focus_estimate.focus_estimate_pyramid(
        selected, sel_offsets, tables, radius, pyramid)


def compute_focus_maps(
    images: torch.Tensor,  # [G, C, H, W] uint8
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    focus_ids: torch.Tensor,  # [K] int64
    tables: FocusTables,
    *,
    radius: tuple[int, int],
    filter_radius: tuple[int, int],
    exact_taps: bool = True,
    pyramid: Pyramid | None = None,
) -> torch.Tensor:
    """Estimate + filter -> maps [2, H, W] uint8 (raw, filtered).

    `pyramid` (exact taps only) runs the approximate coarse-to-fine
    estimate instead of the full sweep."""
    with profiling.span("lfi.estimate"):
        map0 = estimate_focus(images, offsets, focus_ids, tables, radius=radius,
                              exact_taps=exact_taps, pyramid=pyramid)
    with profiling.span("lfi.filter"):
        map1 = focus_torch.filter_focus_map(map0, filter_radius)
    return torch.stack([map0, map1])


class FocusBands:
    """A frame's focus maps estimated in row bands, in order, on one
    prepared estimate (``focus_estimate.Estimate``: the focus views'
    gather, RGBx words, tables and clean flags made once, in the first
    band): ``rows(r0, hb)`` writes the raw map's rows [r0, r0 + hb) into
    ``maps[0]`` (under ``lfi.estimate``, one ``estimate bands`` each) and
    returns ``maps``; once the bands cover the frame, ``finish()`` filters
    the whole raw map into ``maps[1]`` (under ``lfi.filter``) -> ``maps``
    [2, H, W] (raw, filtered), the bytes of ``compute_focus_maps``.

    A TEN blend reads only the raw map (``blend_all_focus``), so band k
    blends as soon as its rows exist; the filter's window crosses the
    bands, so it runs after the last. The exact sweep or the fast one,
    never the pyramid (whose refine pass takes the whole frame)."""

    def __init__(self, images, offsets, focus_ids, tables: FocusTables, *,
                 radius: tuple[int, int], filter_radius: tuple[int, int],
                 exact_taps: bool = True):
        self._operands = (images, offsets, focus_ids, tables, radius, exact_taps)
        self._filter_radius = filter_radius
        self._estimate = None
        self.maps = torch.empty((2, *images.shape[2:]), dtype=torch.uint8,
                                device=images.device)

    def rows(self, r0: int, hb: int) -> torch.Tensor:
        with profiling.span("lfi.estimate"):
            profiling.count("estimate bands")
            if self._estimate is None:
                images, offsets, ids, tables, radius, exact_taps = self._operands
                self._estimate = focus_estimate.Estimate(
                    images[ids], offsets[ids], tables, radius, exact_taps, out=self.maps[0])
            self._estimate.rows(r0, hb)
        return self.maps

    def finish(self) -> torch.Tensor:
        self._estimate = None  # the RGBx words go back to the allocator
        with profiling.span("lfi.filter"):
            self.maps[1] = focus_torch.filter_focus_map(self.maps[0], self._filter_radius)
        return self.maps


def blend_all_focus(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    maps: torch.Tensor,  # [2, hb, W] uint8 (raw, filtered) of the block's rows
    decode: torch.Tensor,  # [256] float32
    method: str = "STD",
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """Per-pixel-focus blend of a block of rows -> views [V, C, hb, W]
    uint8."""
    if method not in ("STD", "TEN", "TEN_WM"):
        raise ValueError(f"unknown method {method!r}: use 'STD' or 'TEN'/'TEN_WM'")
    fmap = maps[1] if method == "STD" else maps[0]
    with profiling.span("lfi.blend"):
        return allfocus_blend.allfocus_blend(images, weights, offsets, fmap, decode,
                                             row_start, row_count)


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
    pyramid: Pyramid | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-in-focus render: estimate -> filter -> per-pixel blend.

    Returns (views [V, C, H, W] uint8, maps [2, H, W] uint8).
    """
    maps = compute_focus_maps(
        images, offsets, focus_ids, tables, radius=radius,
        filter_radius=filter_radius, exact_taps=exact_taps, pyramid=pyramid,
    )
    views = blend_all_focus(
        images, weights, offsets, maps, tables.decode, method=method
    )
    return views, maps
