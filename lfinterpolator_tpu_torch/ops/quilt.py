"""Quilt output: wrappers of the two hand-written Hopper kernels.

  * ``quilt_blend`` -- the quilt-only fixed-focus render: the shift-blend
    kernel's quilt instantiation (``csrc/shift_blend.cu``, kQuilt) blends
    views 0..cols*rows-1 and stores each straight at its tile of the canvas,
    so the per-view stack never exists. Replaces
    ``blend_pallas._blend_quilt_kernel`` fed by ``shift_pallas._pshift_kernel``
    (``quilt.render_fixed_quilt_padded``). Plain version: the first
    cols*rows views of ``blend_torch.render_fixed``, then the montage.
    Preconditions and numerics are ``shift_blend``'s: fp16-valued weights,
    the near-tie rule against the plain version, bit-equal to the tiles of
    a ``shift_blend`` render.
  * ``quilt_copy`` -- the tile copy of every two-stage quilt
    (``csrc/quilt.cu``). Replaces ``quilt._copy_kernel``. Plain version:
    ``quilt_torch.montage``, a reshape/permute.

``assemble_quilt`` is the two-stage montage of rendered views: the resize
(``quilt_torch.resize_tiles``, a float32 ``torch.matmul`` on the views'
device, as the JAX package left it to XLA) where a tile size is asked for,
then ``quilt_copy``.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel, or raises. No path falls back
from one to the other. The TPU kernels needed h % 8 == 0 and w % 128 == 0
(``blend_pallas.supports_quilt``, ``quilt.py:157``); these take any size.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import _build, blend_torch, quilt_torch, shift_blend


def quilt_blend_reference(
    images: torch.Tensor, weights: torch.Tensor, shifts: torch.Tensor,
    cols: int = 5, rows: int = 9,
) -> torch.Tensor:
    """The plain PyTorch version of ``quilt_blend`` (any device)."""
    n = cols * rows
    return quilt_torch.montage(
        blend_torch.render_fixed(images, weights[:n], shifts), cols, rows)


def quilt_blend(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V >= cols*rows, G] float32, fp16-valued
    shifts: torch.Tensor,  # [G, 2] int32 (dx, dy)
    cols: int = 5,
    rows: int = 9,
) -> torch.Tensor:
    """Quilt-only fixed-focus render -> [C, rows*H, cols*W] uint8 canvas,
    view i at tile (i // cols, i % cols) (kernel on CUDA tensors)."""
    shift_blend.check_operands(images, weights, shifts)
    n = cols * rows
    if cols < 1 or rows < 1 or weights.shape[0] < n:
        raise ValueError(
            f"Quilt needs {n} views ({cols}x{rows}), got {weights.shape[0]}")
    if images.device.type == "cpu":
        return quilt_blend_reference(images, weights, shifts, cols, rows)
    if images.device.type != "cuda":
        raise ValueError(f"quilt_blend runs on cpu or cuda, not {images.device}")

    lib = _build.load()
    g, c, h, w = images.shape
    if g > lib.lfi_shift_blend_max_grid():
        raise ValueError(
            f"the kernel takes at most {lib.lfi_shift_blend_max_grid()} "
            f"grid images, got {g}"
        )
    clipped = shift_blend.clip_shifts(shifts, h, w)
    out = torch.empty((c, rows * h, cols * w), dtype=torch.uint8, device=images.device)
    _build.launch("lfi_quilt_blend", images.device, images.data_ptr(),
                  weights.data_ptr(), clipped.data_ptr(), out.data_ptr(),
                  g, c, h, w, cols, rows)
    profiling.count("quilt_blend")
    return out


def quilt_copy(tiles: torch.Tensor, cols: int = 5, rows: int = 9) -> torch.Tensor:
    """[N >= cols*rows, C, th, tw] uint8 -> [C, rows*th, cols*tw] uint8, tile
    i at cell (i // cols, i % cols) (kernel on CUDA tensors)."""
    quilt_torch.check_views(tiles, cols, rows)
    if tiles.device.type == "cpu":
        return quilt_torch.montage(tiles, cols, rows)
    if tiles.device.type != "cuda":
        raise ValueError(f"quilt_copy runs on cpu or cuda, not {tiles.device}")
    if not tiles.is_contiguous():
        raise ValueError("quilt_copy needs contiguous tiles")

    _, c, th, tw = tiles.shape
    out = torch.empty((c, rows * th, cols * tw), dtype=torch.uint8, device=tiles.device)
    _build.launch("lfi_quilt_copy", tiles.device, tiles.data_ptr(), out.data_ptr(),
                  c, th, tw, cols, rows)
    profiling.count("quilt_copy")
    return out


def assemble_quilt(
    views: torch.Tensor,  # [V, C, H, W] uint8
    cols: int = 5,
    rows: int = 9,
    tile_size: tuple[int, int] | None = None,  # (tile_h, tile_w)
) -> torch.Tensor:
    """First cols*rows views -> [C, rows*tile_h, cols*tile_w] uint8: the
    resize where `tile_size` differs from the views' size, then the tile
    copy (kernel on CUDA tensors)."""
    return quilt_copy(quilt_torch.tiles_for(views, cols, rows, tile_size)
                      .contiguous(), cols, rows)
