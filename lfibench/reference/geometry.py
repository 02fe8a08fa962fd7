"""The host geometry of a render, frozen for the reference.

A copy of the functions of the original tool's host math (reference:
ichlubna/lfInterpolator src/interpolator.cu:141-246, 318-337) that the
reference needs to work out a render's weights, offsets, focus views and
candidates from the trajectory and focus alone. NumPy only, float32 as the
original computes them. It is frozen here on purpose: the check must not
move when the program's own copy does.

Flat image order: ``col * rows + row``.
"""

from __future__ import annotations

import numpy as np


def round_half_away(x: np.ndarray) -> np.ndarray:
    """Round half away from zero (C++ ``std::round``)."""
    x = np.asarray(x)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def parse_trajectory(trajectory: str, cols: int, rows: int) -> np.ndarray:
    """``"c0,r0,c1,r1"`` in [0, 1] -> absolute grid coordinates [4] float32."""
    vals = np.array([float(p) for p in trajectory.split(",")], dtype=np.float32)
    if vals.shape != (4,):
        raise ValueError(f"trajectory {trajectory!r} needs 4 values")
    scale = np.array([cols - 1, rows - 1, cols - 1, rows - 1], dtype=np.float32)
    return vals * scale


def trajectory_center(start_end: np.ndarray) -> np.ndarray:
    se = np.asarray(start_end, dtype=np.float32)
    return (se[:2] + (se[2:] - se[:2]) * np.float32(0.5)).astype(np.float32)


def grid_positions(cols: int, rows: int) -> np.ndarray:
    """[G, 2] camera (col, row) in flat order."""
    cc, rr = np.meshgrid(np.arange(cols), np.arange(rows), indexing="ij")
    return np.stack([cc.ravel(), rr.ravel()], axis=-1).astype(np.float32)


def weight_matrix(start_end: np.ndarray, cols: int, rows: int, effect: float,
                  views: int) -> np.ndarray:
    """[V, G] float32: row v weighs each camera by
    ``(|(cols, rows)| - distance) ** effect``, normalised, at the v-th of
    `views` equally spaced points from start to end, then quantised to
    IEEE half as the original stores it (src/interpolator.cu:209-224)."""
    se = np.asarray(start_end, dtype=np.float32)
    start, end = se[:2], se[2:]
    if views == 1:
        points = start[None, :]
    else:
        step = (end - start) / np.float32(views - 1)
        points = start[None, :] + step[None, :] * np.arange(views, dtype=np.float32)[:, None]
    pos = grid_positions(cols, rows)
    max_distance = np.float32(np.hypot(np.float32(cols), np.float32(rows)))
    out = []
    for p in points.astype(np.float32):
        dist = np.hypot(p[0] - pos[:, 0], p[1] - pos[:, 1]).astype(np.float32)
        w = np.power(max_distance - dist, np.float32(effect), dtype=np.float32)
        out.append((w / w.sum(dtype=np.float32)).astype(np.float32))
    return np.stack(out).astype(np.float16).astype(np.float32)


def offsets(cols: int, rows: int, width: int, height: int, aspect: float,
            center: np.ndarray) -> np.ndarray:
    """[G, 2] float32 (x, y) shift of each camera, pixels per unit focus
    (src/interpolator.cu:226-246)."""
    pos = grid_positions(cols, rows)
    off = (center[None, :].astype(np.float32) - pos) / np.array([cols, rows], dtype=np.float32)
    off = off * np.array([width, height], dtype=np.float32)
    off[:, 1] *= np.float32(width) / np.float32(height) / np.float32(aspect)
    return off.astype(np.float32)


def focused_offsets(off: np.ndarray, focus: float) -> np.ndarray:
    """[G, 2] int (dx, dy): ``round(offset * focus)``, half away from zero."""
    return round_half_away(off * np.float32(focus)).astype(np.int64)


def focus_views(start_end: np.ndarray, cols: int, rows: int, count: int) -> np.ndarray:
    """The `count` cameras nearest the trajectory's center, ties by flat
    index (src/interpolator.cu:194-207)."""
    center = trajectory_center(start_end)
    pos = grid_positions(cols, rows)
    dist = np.hypot(pos[:, 0] - center[0], pos[:, 1] - center[1]).astype(np.float32)
    return np.argsort(dist, kind="stable")[:count].astype(np.int64)


def block_radius(width: int, height: int, pixel_size_factor: int) -> tuple[int, int]:
    """The search stencil's spacing: size / factor, rounded up to even, at
    least 2 (src/interpolator.cu:141-146)."""
    rx, ry = width // pixel_size_factor, height // pixel_size_factor
    rx += rx % 2
    ry += ry % 2
    return max(rx, 2), max(ry, 2)


def candidates(focus: float, focus_range: float, steps: int) -> np.ndarray:
    """[S] float32 ``focus + i * range / (steps - 1)`` (src/kernels.cu:245-250)."""
    step = np.float32(focus_range) / np.float32(steps - 1)
    return (np.float32(focus) + step * np.arange(steps, dtype=np.float32)).astype(np.float32)


def candidate_bytes(cands: np.ndarray, focus: float, focus_range: float) -> np.ndarray:
    """[S] uint8 map byte of each candidate: ``round((f - focus) / range *
    255)``, half away from zero (src/kernels.cu:253-257)."""
    norm = (cands - np.float32(focus)) / np.float32(focus_range)
    return round_half_away(norm * np.float32(255)).astype(np.uint8)


def decode_table(focus: float, focus_range: float) -> np.ndarray:
    """[256] float32 focus value of each map byte: ``focus + b / 255 *
    range`` (src/kernels.cu:134-137)."""
    b = np.arange(256, dtype=np.float32)
    return (np.float32(focus) + b / np.float32(255) * np.float32(focus_range)).astype(np.float32)
