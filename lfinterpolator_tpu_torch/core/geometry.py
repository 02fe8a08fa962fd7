"""Host-side geometry: trajectories, blend weights, per-image shift offsets.

The port's own copy of ``lfinterpolator_tpu/core/geometry.py`` (NumPy only),
held equal to it by its outputs, not by its text: ``weight_matrix`` weighs
every view of a trajectory in one broadcast expression where the original
calls ``generate_weights`` once per view, with the same float32 operations
in the same order, so the matrices are equal bit for bit
(``tests/test_torch_copies.py``, ``tests/test_torch_weights.py``).
Re-derives the reference's host math (reference: src/interpolator.cu:156-246,
318-337) with NumPy. All of this is tiny (O(views x grid)) and runs on the
host; the resulting arrays feed the device kernels.

Grid convention: an image named ``a_b.ext`` is the camera at column ``a``, row
``b`` (the reference's help text, src/main.cpp:17). The flat image order used
for weights, offsets and the image stack is ``col * rows + row``
(src/interpolator.cu:106-113, 161-167, 233-243). The reference's loader
transposes filename coordinates in a way that is only self-consistent for
square grids (src/lfLoader.cpp:57,64 vs src/interpolator.cu:106); we use the
documented column_row interpretation uniformly, which is identical for square
grids and well-defined for rectangular ones.
"""

from __future__ import annotations

import numpy as np


def round_half_away(x: np.ndarray) -> np.ndarray:
    """Round half away from zero, matching C++ std::round / glm::round.

    (NumPy's np.round is half-to-even, which differs on exact .5 values;
    the reference uses glm::round for focused offsets, src/interpolator.cu:241.)
    """
    x = np.asarray(x)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def parse_trajectory(trajectory: str, cols_rows: tuple[int, int]) -> np.ndarray:
    """Parse ``"startCol,startRow,endCol,endRow"`` into absolute grid coords.

    Normalized values are scaled by (cols-1, rows-1, cols-1, rows-1)
    (reference: src/interpolator.cu:318-337).
    """
    parts = [p for p in trajectory.split(",")]
    if len(parts) != 4:
        raise ValueError(
            f"Trajectory {trajectory!r} must have 4 comma-separated values: "
            "startCol,startRow,endCol,endRow"
        )
    vals = np.array([float(p) for p in parts], dtype=np.float32)
    scale = np.array(
        [cols_rows[0] - 1, cols_rows[1] - 1, cols_rows[0] - 1, cols_rows[1] - 1],
        dtype=np.float32,
    )
    return vals * scale


def generate_trajectory(start_end: np.ndarray, n_views: int) -> np.ndarray:
    """64 (n_views) equally spaced positions from start to end.

    Reference: src/interpolator.cu:174-182 (step = (end-start)/(n-1)).
    Returns [n_views, 2] float32.
    """
    start_end = np.asarray(start_end, dtype=np.float32)
    start = start_end[:2]
    end = start_end[2:]
    if n_views == 1:  # a single view sits at the start (no step to divide by)
        return start[None, :].astype(np.float32)
    step = (end - start) / np.float32(n_views - 1)
    i = np.arange(n_views, dtype=np.float32)[:, None]
    return (start[None, :] + step[None, :] * i).astype(np.float32)


def trajectory_center(start_end: np.ndarray) -> np.ndarray:
    """Midpoint of the trajectory (reference: src/interpolator.cu:189-192)."""
    start_end = np.asarray(start_end, dtype=np.float32)
    return (start_end[:2] + (start_end[2:] - start_end[:2]) * np.float32(0.5)).astype(
        np.float32
    )


def grid_positions(cols: int, rows: int) -> np.ndarray:
    """[G, 2] camera (col, row) positions in flat order col*rows + row."""
    cc, rr = np.meshgrid(np.arange(cols), np.arange(rows), indexing="ij")
    return np.stack([cc.ravel(), rr.ravel()], axis=-1).astype(np.float32)


def generate_weights(
    coords: np.ndarray, cols: int, rows: int, effect: float
) -> np.ndarray:
    """Per-image blend weights for one virtual view position.

    weight_g = (maxDistance - |coords - pos_g|) ** effect, normalized to sum 1.
    maxDistance = |(cols, rows)| (reference: src/interpolator.cu:156-172 --
    note: NOT (cols-1, rows-1)).
    Returns [G] float32 in flat order col*rows + row.
    """
    return _weights(np.asarray(coords)[None, :], cols, rows, effect)[0]


def weight_matrix(
    start_end: np.ndarray, cols: int, rows: int, effect: float, n_views: int
) -> np.ndarray:
    """[n_views, G] float32 weight matrix over the whole trajectory.

    Row v holds the per-image weights for trajectory point v
    (reference: src/interpolator.cu:209-224, row-major [views x gridSize]).
    """
    return _weights(generate_trajectory(start_end, n_views), cols, rows, effect)


def _weights(points: np.ndarray, cols: int, rows: int, effect: float) -> np.ndarray:
    """[V, G] float32: the weights of each of the [V, 2] points.

    One broadcast expression over all points. Every float32 operation is
    the per-point one, elementwise, and each row's sum reduces its own G
    weights, so a row is bit for bit what one point alone would give.
    """
    pos = grid_positions(cols, rows)
    max_distance = np.float32(np.hypot(np.float32(cols), np.float32(rows)))
    points = points.astype(np.float32)
    dist = np.hypot(
        points[:, 0, None] - pos[:, 0], points[:, 1, None] - pos[:, 1]
    ).astype(np.float32)
    w = np.power(max_distance - dist, np.float32(effect), dtype=np.float32)
    return (w / w.sum(axis=-1, keepdims=True, dtype=np.float32)).astype(np.float32)


def quantize_weights_f16(weights: np.ndarray) -> np.ndarray:
    """Quantize to IEEE half, matching the reference's storage precision
    (reference: src/interpolator.cu:217-219 casts each weight to `half`)."""
    return weights.astype(np.float16)


def compute_offsets(
    cols: int,
    rows: int,
    width: int,
    height: int,
    aspect: float,
    center: np.ndarray,
) -> np.ndarray:
    """Per-image float shift vectors (pixels per unit focus).

    offset_g = (center - pos_g) / (cols, rows) * (width, height),
    with offset.y scaled by (width/height)/aspect
    (reference: src/interpolator.cu:226-246).
    Returns [G, 2] float32 (x, y) in flat order col*rows + row.
    """
    pos = grid_positions(cols, rows)
    off = (center[None, :].astype(np.float32) - pos) / np.array(
        [cols, rows], dtype=np.float32
    )
    off = off * np.array([width, height], dtype=np.float32)
    offset_aspect = np.float32(width) / np.float32(height) / np.float32(aspect)
    off[:, 1] *= offset_aspect
    return off.astype(np.float32)


def focused_offsets(offsets: np.ndarray, focus: float) -> np.ndarray:
    """Integer pixel shifts for the fixed-focus path.

    round(offset * focus) with glm::round (half away from zero)
    (reference: src/interpolator.cu:241-242).
    Returns [G, 2] int32 (dx, dy).
    """
    return round_half_away(offsets * np.float32(focus)).astype(np.int32)


def select_focus_views(
    start_end: np.ndarray, cols: int, rows: int, count: int
) -> np.ndarray:
    """IDs of the `count` grid views nearest the trajectory center.

    (reference: src/interpolator.cu:194-207). Ties broken by flat index
    (deterministic; the reference's std::sort leaves ties unspecified).
    Returns [count] int32 flat indices.
    """
    g = cols * rows
    if count > g:
        raise ValueError(
            f"Focus estimation needs at least {count} grid images, got {g}. "
            "Reduce focus_map_views or use a larger grid."
        )
    center = trajectory_center(start_end)
    pos = grid_positions(cols, rows)
    dist = np.hypot(pos[:, 0] - center[0], pos[:, 1] - center[1]).astype(np.float32)
    order = np.argsort(dist, kind="stable")
    return order[:count].astype(np.int32)


def block_radius(width: int, height: int, pixel_size_factor: int = 100) -> tuple[int, int]:
    """Focus-search stencil spacing: resolution/100, rounded up to even.

    (reference: src/interpolator.cu:141-146). The reference yields radius 0 for
    images narrower than `pixel_size_factor` pixels, which makes its stencil
    loop diverge (src/kernels.cu:208, step 0); we clamp to a minimum of 2,
    the smallest value the reference itself can produce for valid inputs.
    """
    rx = width // pixel_size_factor
    ry = height // pixel_size_factor
    if rx % 2 != 0:
        rx += 1
    if ry % 2 != 0:
        ry += 1
    return max(rx, 2), max(ry, 2)


def focus_candidates(focus: float, focus_range: float, steps: int) -> np.ndarray:
    """The candidate focus values scanned by the disparity search.

    f_i = focus + i * range/(steps-1) (reference: src/kernels.cu:245-250).
    """
    step = np.float32(focus_range) / np.float32(steps - 1)
    return (np.float32(focus) + step * np.arange(steps, dtype=np.float32)).astype(
        np.float32
    )
