"""The state carried from the host to the device for one render.

``render_params`` builds a render's host arrays -- the fp16-quantized
weight matrix and the integer focused offsets
(``lfinterpolator_tpu/api.py:593-611``) -- with the JAX package's
NumPy-only geometry. The upload functions take those arrays and the decoded
RGBA stack of a ``LightField`` as numpy and upload them in the layout the
port's kernels read. As in ``api.py:239-251``, alpha is dropped and the
stack transposed to planar on the host, so the device never holds the RGBA
copy.
"""

from __future__ import annotations

import numpy as np
import torch
from lfinterpolator_tpu.core import geometry


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
    start_end = geometry.parse_trajectory(trajectory, (cols, rows))
    wm = geometry.weight_matrix(start_end, cols, rows, effect, views)
    # fp16 weight quantization for parity with the reference
    # (src/interpolator.cu:217-219); accumulation stays float32.
    wm = geometry.quantize_weights_f16(wm).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, width, height, aspect, geometry.trajectory_center(start_end)
    )
    return wm, geometry.focused_offsets(offsets, focus)


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
