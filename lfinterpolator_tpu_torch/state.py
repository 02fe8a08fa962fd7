"""The state carried from the host to the device for one render.

``render_params`` builds a fixed-focus render's host arrays -- the
fp16-quantized weight matrix and the integer focused offsets
(``lfinterpolator_tpu/api.py:593-611``) -- and ``allfocus_params`` an
all-in-focus render's (``api.py:593-637``), both with the JAX package's
NumPy-only geometry. The upload functions take those arrays and the decoded
RGBA stack of a ``LightField`` as numpy and upload them in the layout the
port's kernels read. As in ``api.py:239-251``, alpha is dropped and the
stack transposed to planar on the host, so the device never holds the RGBA
copy.

The all-focus render's three host tables (``focus_tables``) hold every
value that needs a division -- the candidate focus values, the map byte of
each candidate and the 256-entry byte decode -- computed here in NumPy
float32 with the oracle's own expressions, so the device only multiplies,
adds and looks up.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.core.config import RenderConfig


def render_params(
    trajectory: str,
    *,
    cols: int,
    rows: int,
    height: int,
    width: int,
    focus: float,
    effect: float = 3.0,
    aspect: float = 1.0,
    views: int = 64,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (weights [V, G] float32, fp16-valued; shifts [G, 2] int32 (dx, dy))."""
    _, wm, offsets = _weights_and_offsets(
        trajectory, cols, rows, height, width, effect, aspect, views
    )
    return wm, geometry.focused_offsets(offsets, focus)


def _weights_and_offsets(trajectory, cols, rows, height, width, effect, aspect,
                         views):
    """-> (start_end, weights [V, G] float32 fp16-valued, offsets [G, 2]
    float32 (x, y), pixels per unit focus)."""
    start_end = geometry.parse_trajectory(trajectory, (cols, rows))
    wm = geometry.weight_matrix(start_end, cols, rows, effect, views)
    # fp16 weight quantization for parity with the reference
    # (src/interpolator.cu:217-219); accumulation stays float32.
    wm = geometry.quantize_weights_f16(wm).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, width, height, aspect, geometry.trajectory_center(start_end)
    )
    return start_end, wm, offsets


class FocusTables(NamedTuple):
    """The host tables of the focus search and the per-pixel decode."""

    candidates: np.ndarray | torch.Tensor  # [S] float32 candidate focus values
    candidate_bytes: np.ndarray | torch.Tensor  # [S] uint8 map byte of each
    decode: np.ndarray | torch.Tensor  # [256] float32 focus value of each byte


def focus_tables(focus: float, focus_range: float, steps: int) -> FocusTables:
    """The tables in NumPy float32, with the oracle's expressions.

    Candidates: ``geometry.focus_candidates`` (``reference.py:192``).
    Bytes: ``round_half_away((f_i - focus) / range * 255)``
    (``reference.py:218-219``). Decode: ``focus + b / 255 * range``
    (``reference.py:124-134``).
    """
    candidates = geometry.focus_candidates(focus, focus_range, steps)
    normalized = (candidates - np.float32(focus)) / np.float32(focus_range)
    candidate_bytes = geometry.round_half_away(
        normalized * np.float32(255)
    ).astype(np.uint8)
    decode = (
        np.float32(focus)
        + np.arange(256, dtype=np.float32) / np.float32(255)
        * np.float32(focus_range)
    ).astype(np.float32)
    return FocusTables(candidates, candidate_bytes, decode)


@dataclasses.dataclass(frozen=True)
class AllFocusParams:
    """Host arrays of one all-in-focus render."""

    weights: np.ndarray  # [V, G] float32, fp16-valued
    offsets: np.ndarray  # [G, 2] float32 (x, y), pixels per unit focus
    focus_ids: np.ndarray  # [K] int32, the views the focus search reads
    radius: tuple[int, int]  # (rx, ry) stencil spacing of the search
    filter_radius: tuple[int, int]  # (rx, ry) of the map's box filter
    tables: FocusTables


def allfocus_params(
    trajectory: str,
    *,
    cols: int,
    rows: int,
    height: int,
    width: int,
    config: RenderConfig,
) -> AllFocusParams:
    """An all-in-focus render's host arrays, as ``api.py:593-637`` builds
    them (the focus, range, effect, aspect and counts come from `config`)."""
    start_end, wm, offsets = _weights_and_offsets(
        trajectory, cols, rows, height, width, config.effect, config.aspect,
        config.view_count,
    )
    radius = geometry.block_radius(width, height, config.pixel_size_factor)
    return AllFocusParams(
        weights=wm,
        offsets=offsets,
        focus_ids=geometry.select_focus_views(
            start_end, cols, rows, config.focus_map_views
        ),
        radius=radius,
        filter_radius=(
            radius[0] // config.filter_radius_divisor,
            radius[1] // config.filter_radius_divisor,
        ),
        tables=focus_tables(config.focus, config.focus_range, config.focus_steps),
    )


def upload_allfocus(
    params: AllFocusParams, device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, FocusTables]:
    """-> (weights [V, G] f32, offsets [G, 2] f32, focus_ids [K] int64,
    tables) on device."""

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (
        up(params.weights),
        up(params.offsets),
        up(params.focus_ids.astype(np.int64)),
        FocusTables(*(up(t) for t in params.tables)),
    )


def upload_images(lf_images_np: np.ndarray, device) -> torch.Tensor:
    """[G, H, W, 4|3] uint8 -> device [G, 3, H, W] uint8 (one upload)."""
    planar = np.ascontiguousarray(lf_images_np[..., :3].transpose(0, 3, 1, 2))
    return torch.from_numpy(planar).to(device)


def upload_params(
    weights_np: np.ndarray, focused_offsets_np: np.ndarray, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (weights [V, G] float32, shifts [G, 2] int32 (dx, dy)) on device."""
    weights = np.ascontiguousarray(weights_np, dtype=np.float32)
    shifts = np.ascontiguousarray(focused_offsets_np, dtype=np.int32)
    return torch.from_numpy(weights).to(device), torch.from_numpy(shifts).to(device)


def to_device_state(
    lf_images_np: np.ndarray,
    weights_np: np.ndarray,
    focused_offsets_np: np.ndarray,
    device,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (images [G,3,H,W] u8, weights [V,G] f32, shifts [G,2] int32)."""
    return (
        upload_images(lf_images_np, device),
        *upload_params(weights_np, focused_offsets_np, device),
    )
