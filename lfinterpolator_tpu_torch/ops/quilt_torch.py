"""Quilt assembly in plain PyTorch (Looking Glass format).

Port of ``lfinterpolator_tpu/ops/quilt.py`` (``assemble_quilt``,
``to_hwc``): the first cols x rows views laid out row-major from the top
left, view i at cell (i // cols, i % cols) of a ``[C, rows*th, cols*tw]``
canvas, the montage of ``scripts/viewsToQuilt.sh``. These functions are
also the plain versions of the hand-written kernels in ``ops/quilt.py``.

Tiles keep the native view size unless a tile size is asked for. The
resize is ``jax.image.resize(..., "bilinear")``'s, which antialiases when
it shrinks (``torch.nn.functional.interpolate`` does not): a triangle
filter widened by the shrink factor. It is built here, as in
``jax/_src/image/scale.py`` (``compute_weight_mat``), as one weight matrix
per axis in NumPy float32 on the host, applied as a separable float32
contraction, then rounded half to even, clipped and cast to u8
(``quilt.py:143-146``).
"""

from __future__ import annotations

import numpy as np
import torch

from .blend_torch import matmul_f32


def check_views(views: torch.Tensor, cols: int, rows: int) -> int:
    """Raise unless `views` is [V >= cols*rows, C, H, W] uint8; -> cols*rows."""
    n = cols * rows
    if cols < 1 or rows < 1:
        raise ValueError(f"a quilt needs cols, rows >= 1, got {cols}x{rows}")
    if views.dtype != torch.uint8 or views.dim() != 4:
        raise ValueError(
            f"views must be [V, C, H, W] uint8, got {tuple(views.shape)} {views.dtype}"
        )
    if views.shape[0] < n:
        raise ValueError(f"Quilt needs {n} views, got {views.shape[0]}")
    return n


def montage(tiles: torch.Tensor, cols: int, rows: int) -> torch.Tensor:
    """[N >= cols*rows, C, th, tw] -> [C, rows*th, cols*tw], tile i at cell
    (i // cols, i % cols)."""
    n = check_views(tiles, cols, rows)
    _, c, th, tw = tiles.shape
    return (tiles[:n].reshape(rows, cols, c, th, tw).permute(2, 0, 3, 1, 4)
            .reshape(c, rows * th, cols * tw))


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32 weights of jax's antialiased triangle
    resize along one axis (``compute_weight_mat``, translation 0)."""
    f32 = np.float32
    inv_scale = f32(1) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > f32(1000 * np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1)), f32(0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], weights, f32(0)).astype(f32).T.copy()


def resize_tiles(tiles: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """[N, C, H, W] uint8 -> [N, C, th, tw] uint8, antialiased bilinear."""
    _, _, h, w = tiles.shape
    x = tiles.to(torch.float32)
    if th != h:
        wy = torch.from_numpy(resize_weights(h, th)).to(tiles.device)
        x = matmul_f32(wy, x)  # [th, h] @ [N, C, h, W]
    if tw != w:
        wx = torch.from_numpy(resize_weights(w, tw)).to(tiles.device)
        x = matmul_f32(x, wx.T)  # [N, C, th, w] @ [w, tw]
    return x.round_().clamp_(0, 255).to(torch.uint8)


def tiles_for(
    views: torch.Tensor, cols: int, rows: int,
    tile_size: tuple[int, int] | None = None,
) -> torch.Tensor:
    """The quilt's tiles: the first cols*rows views, resized to `tile_size`
    (tile_h, tile_w) when it differs from theirs. Native tiles are the
    views themselves (no copy)."""
    n = check_views(views, cols, rows)
    h, w = views.shape[2:]
    if tile_size is None or tuple(tile_size) == (h, w):
        return views
    th, tw = (int(v) for v in tile_size)
    if th < 1 or tw < 1:
        raise ValueError(f"tile size must be positive, got {tile_size}")
    return resize_tiles(views[:n], th, tw)


def assemble_quilt(
    views: torch.Tensor,  # [V, C, H, W] uint8
    cols: int = 5,
    rows: int = 9,
    tile_size: tuple[int, int] | None = None,  # (tile_h, tile_w)
) -> torch.Tensor:
    """First cols*rows views -> [C, rows*tile_h, cols*tile_w] uint8."""
    return montage(tiles_for(views, cols, rows, tile_size), cols, rows)


def to_hwc(quilt_chw: torch.Tensor) -> torch.Tensor:
    """[C, H, W] -> [H, W, C] (contiguous)."""
    return quilt_chw.permute(1, 2, 0).contiguous()
