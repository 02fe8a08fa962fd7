"""The state carried from the host to the device for one render.

``render_params`` builds a fixed-focus render's host arrays -- the
fp16-quantized weight matrix and the integer focused offsets
(``lfinterpolator_tpu/api.py:593-611``) -- and ``allfocus_params`` an
all-in-focus render's (``api.py:593-693``), both with the JAX package's
NumPy-only geometry (the port's copy, ``core/geometry.py``). The upload functions take those arrays and the decoded
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

import numpy as np
import torch
from .core import geometry
from .core.config import RenderConfig
from .ops import estimate_geometry
from .ops.estimate_geometry import Pyramid


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


def focus_tables(focus: float, focus_range: float,
                 steps: int) -> estimate_geometry.FocusTables:
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
    return estimate_geometry.FocusTables(candidates, candidate_bytes, decode)


@dataclasses.dataclass(frozen=True)
class AllFocusParams:
    """Host arrays of one all-in-focus render."""

    weights: np.ndarray  # [V, G] float32, fp16-valued
    offsets: np.ndarray  # [G, 2] float32 (x, y), pixels per unit focus
    focus_ids: np.ndarray  # [K] int32, the views the focus search reads
    radius: tuple[int, int]  # (rx, ry) stencil spacing of the search
    filter_radius: tuple[int, int]  # (rx, ry) of the map's box filter
    tables: estimate_geometry.FocusTables
    # The coarse-to-fine estimate's plan when the config asks for it
    # (focus_pyramid, exact taps) and the geometry takes it; None: the
    # exact sweep runs (focus.py:186-201).
    pyramid: Pyramid | None


def allfocus_params(
    trajectory: str,
    *,
    cols: int,
    rows: int,
    height: int,
    width: int,
    config: RenderConfig,
) -> AllFocusParams:
    """An all-in-focus render's host arrays, as ``api.py:593-693`` builds
    them (the focus, range, effect, aspect, counts and the pyramid flag come
    from `config`). The pyramid's pad and spans take every grid image's
    offset, as there, not only the focus views'."""
    start_end, wm, offsets = _weights_and_offsets(
        trajectory, cols, rows, height, width, config.effect, config.aspect,
        config.view_count,
    )
    radius = geometry.block_radius(width, height, config.pixel_size_factor)
    focus_ids = geometry.select_focus_views(
        start_end, cols, rows, config.focus_map_views
    )
    pyramid = None
    if config.focus_pyramid and config.exact_focus_taps:
        # the JAX package's shift pad (px, py), max(shift_pad_bound,
        # radius + 1), and its per-chunk shift spans fix the pyramid's
        # geometry
        px, py = estimate_geometry.shift_pad_bound(
            offsets, config.focus, config.focus_range, radius, height, width
        )
        pad = (max(px, radius[0] + 1), max(py, radius[1] + 1))
        spans = estimate_geometry.chunk_spans(
            offsets, config.focus, config.focus_range, config.focus_steps, 4
        )
        pyramid = estimate_geometry.pyramid_plan(
            height, width, len(focus_ids), config.focus_steps, radius, spans, pad
        )
    return AllFocusParams(
        weights=wm,
        offsets=offsets,
        focus_ids=focus_ids,
        radius=radius,
        filter_radius=(
            radius[0] // config.filter_radius_divisor,
            radius[1] // config.filter_radius_divisor,
        ),
        tables=focus_tables(config.focus, config.focus_range, config.focus_steps),
        pyramid=pyramid,
    )


def fp16_valued(weights: np.ndarray) -> np.ndarray:
    """`weights` as contiguous float32, after checking that float16 holds
    every value exactly.

    The blend kernels contract on the tensor cores with fp16 operands, so a
    weight that fp16 cannot hold (a float32 with more than 11 significant
    bits, beyond +-65504, or not finite) would be rounded silently on the
    card. Every weight matrix is checked here, in NumPy, where it is
    uploaded -- for the CPU too, so that both devices take the same inputs
    -- and the kernels' wrappers state fp16-valued weights as their
    precondition. ``geometry.quantize_weights_f16`` makes such a matrix."""
    w = np.ascontiguousarray(weights, dtype=np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        exact = np.array_equal(w.astype(np.float16).astype(np.float32), w)
    if not exact:
        raise ValueError(
            "the weight matrix holds values that float16 cannot represent "
            "exactly; quantize it first (geometry.quantize_weights_f16)"
        )
    return w


def upload_allfocus(
    params: AllFocusParams, device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, estimate_geometry.FocusTables]:
    """-> (weights [V, G] f32, offsets [G, 2] f32, focus_ids [K] int64,
    tables) on device. Raises ValueError unless the weights are fp16-valued
    (``fp16_valued``)."""

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (
        up(fp16_valued(params.weights)),
        up(params.offsets),
        up(params.focus_ids.astype(np.int64)),
        estimate_geometry.FocusTables(*(up(t) for t in params.tables)),
    )


def upload_images(lf_images_np: np.ndarray, device) -> torch.Tensor:
    """[G, H, W, 4|3] uint8 -> device [G, 3, H, W] uint8 (one upload)."""
    planar = np.ascontiguousarray(lf_images_np[..., :3].transpose(0, 3, 1, 2))
    return torch.from_numpy(planar).to(device)


def upload_params(
    weights_np: np.ndarray, focused_offsets_np: np.ndarray, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (weights [V, G] float32, shifts [G, 2] int32 (dx, dy)) on device.
    Raises ValueError unless the weights are fp16-valued (``fp16_valued``)."""
    weights = fp16_valued(weights_np)
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
