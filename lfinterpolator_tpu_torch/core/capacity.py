"""Host-side device-memory planning for one-GPU renders.

Port of ``lfinterpolator_tpu/core/capacity.py``, re-derived for the port's
kernels. Every oversized request is caught by host arithmetic before any
device allocation, and a render whose output does not fit runs in view
batches instead of failing in the allocator.

The budget (``device_hbm_bytes``) is what a render may still allocate: the
free device memory plus the blocks PyTorch's caching allocator holds
unused, free + reserved - allocated. It does NOT include the
Interpolator's resident image stack, which is allocated at construction;
no plan here counts that stack. ``LFI_HBM_BYTES`` overrides the budget with
the same meaning (bytes beyond the resident stack), which keeps the batched
arm testable on the CPU, whose own budget is unbounded; an explicit
``budget=`` bypasses the reading.

When the budget is read and when it is reused: ``free`` is a CUDA call
(``cudaMemGetInfo``, about a millisecond of host time) and ``reserved`` and
``allocated`` are the caching allocator's counts. The allocator's own
``cudaMalloc`` and ``cudaFree`` move ``free`` and ``reserved`` by equal and
opposite amounts, so free + reserved, taken at one free-memory reading,
stays true while only PyTorch's allocator touches the card. Each reading
keeps that sum per device, and a later request is sized against it less
the allocator's current ``allocated`` bytes: one read of the allocator's
counts, no ``cudaMemGetInfo``. Free memory is read again whenever the
cached budget could give another answer than a fresh reading:

  - the request's peak (``plan_render``'s one-pass bytes, or
    ``check_capacity``'s bytes) is more than half the cached budget. A
    plan that would batch views or raise, and a check that would raise,
    all lie there (the headroom takes at most a sixteenth of a budget), so
    a request near the memory limit is always sized against a fresh
    reading;
  - the reading is older than ``READING_TTL_S`` (1 s, on a monotonic
    clock). That bounds how long an allocation made outside PyTorch's
    allocator (another process, NCCL, the CUDA context) goes unseen.

One rule for every caller: ``plan_render`` and ``check_capacity`` (the
stream, the fused quilt, a mesh rank's shard) share it. Each free-memory
reading counts as ``capacity budget reads`` (``profiling.launch_counts``)
and runs inside an ``lfi.plan.read`` span.

What a render holds beyond the stack, uint8 unless noted (``plan_render``):

  estimate (all in focus, K focus views; ``estimate_bytes``): the K views
            gathered [K, C, H, W], their RGBx words [K, H, W, 4] for the
            estimate kernels and those kernels' scratch (the per-candidate
            maps of one chunk and the running best,
            ``focus_estimate.SCRATCH_BYTES_PER_PIXEL`` a pixel), the maps
            [2, H, W] and the box filter's int64 integral image. The clean
            flags and their temporaries (under 64 MiB) go to the headroom;
  render:   per view the kernel's planar output [C, H, W] and its
            [H, W, C] copy for the download; STD's plain ops add
            ``blend_torch.temp_bytes`` (the shifted stack, its f32 copy and
            the f32 product); an all-focus render keeps its maps.

The port's kernels clamp their indices, so there is no edge-padded stack,
no shifted or selected stack and no (8, 128) tile alignment to count. Two
arms remain: everything at once, or view batches with two batch outputs in
flight (one renders while the other downloads). The JAX package's other
arms exist only for the TPU's operands and are not ported (ROADMAP.md):
``drop_images``, the XLA row-block select, ``estimate_row_block``,
``est_fused_bytes``/``slab_bytes_fn`` and ``estimate_fused``.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from ..ops import blend_torch, focus_estimate
from ..utils import profiling

#: The budget reported where no device memory limits a render (the CPU).
UNBOUNDED = 1 << 62
#: Seconds a reading of free + reserved serves (module docstring).
READING_TTL_S = 1.0

#: The device's free + reserved bytes at its last free-memory reading, and the
#: reading's time on ``_clock``, by device index. A fact of the process
#: (every caller on a device shares its memory), so kept per module.
_readings: dict[int, tuple[int, float]] = {}
_clock = time.monotonic  # the readings' age (tests put a fake clock here)


def _current(stats: dict, key: str) -> int:
    return stats[key]["all"]["current"]


def _read(index: int) -> int:
    """One free-memory reading of device `index`, kept in ``_readings``: -> its
    budget. The allocator's counts come from its nested statistics, without
    ``torch.cuda.memory_stats``' flattening."""
    with profiling.span("lfi.plan.read"):
        free, _ = torch.cuda.mem_get_info(index)
        stats = torch.cuda.memory_stats_as_nested_dict(index)
    profiling.count("capacity budget reads")
    held = free + _current(stats, "reserved_bytes")
    _readings[index] = (held, _clock())
    return held - _current(stats, "allocated_bytes")


def device_hbm_bytes(device, peak: int | None = None) -> int:
    """Bytes a render on `device` may still allocate (module docstring).

    `LFI_HBM_BYTES` overrides; any device but CUDA is unbounded. A CUDA
    device reports free + reserved - allocated: with `peak`, the bytes the
    request needs, from the last free-memory reading while it is younger than
    ``READING_TTL_S`` and `peak` is at most half the budget it gives;
    else, and without `peak`, from a new reading."""
    env = os.environ.get("LFI_HBM_BYTES")
    if env:
        return int(env)
    device = torch.device(device)
    if device.type != "cuda":
        return UNBOUNDED
    index = device.index if device.index is not None else torch.cuda.current_device()
    cached = _readings.get(index)
    if peak is not None and cached is not None and _clock() - cached[1] <= READING_TTL_S:
        budget = cached[0] - _current(torch.cuda.memory_stats_as_nested_dict(index),
                                      "allocated_bytes")
        if 2 * peak <= budget:
            return budget
    return _read(index)


def _headroom(budget: int) -> int:
    """Slack for the caching allocator's block rounding and fragmentation,
    cuBLAS's workspace and small constants: 512 MiB at full-card budgets."""
    return min(512 * 2**20, budget // 16)


def _units(*nbytes: int) -> tuple[str, float]:
    return ("GiB", 2.0**30) if max(nbytes) >= 2**30 else ("MiB", 2.0**20)


def estimate_bytes(focus_views: int, c: int, h: int, w: int) -> int:
    """Peak bytes of the focus-map phase of an all-in-focus render (module
    docstring); 0 without focus views."""
    if not focus_views:
        return 0
    return (focus_views * (c + 4) + focus_estimate.SCRATCH_BYTES_PER_PIXEL + 48) * h * w


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """How one render fits device memory."""

    view_batch: int | None  # weight rows per kernel launch; None = all at once
    budget: int  # effective bytes the plan was sized against
    bytes_unbatched: int  # peak bytes of the render in one pass

    @property
    def batched(self) -> bool:
        return self.view_batch is not None


def plan_render(
    g: int,
    c: int,
    h: int,
    w: int,
    v: int,
    *,
    method: str,
    focus_views: int = 0,
    extra: int = 0,
    device="cuda",
    budget: int | None = None,
) -> RenderPlan:
    """Size a render of `v` views from `g` images and pick its arm.

    `method` is "TEN" or "STD"; `focus_views` > 0 sizes an all-in-focus
    render (both methods blend on the kernel then); `extra` bytes are held
    beside the render throughout (a quilt's canvas). Raises ValueError with
    the arithmetic when even a one-view batch cannot fit."""
    n = c * h * w
    estimate = estimate_bytes(focus_views, c, h, w)
    maps = 2 * h * w if focus_views else 0
    std = method == "STD" and not focus_views

    def render_bytes(vb: int, in_flight: int) -> int:
        temp = blend_torch.temp_bytes(g, vb, c, h, w) if std else 0
        return maps + in_flight * 2 * vb * n + temp + extra

    total = max(estimate + extra, render_bytes(v, 1))
    b = device_hbm_bytes(device, total) if budget is None else budget
    b_eff = b - _headroom(b)
    if total <= b_eff:
        return RenderPlan(None, b_eff, total)
    if estimate + extra <= b_eff:
        vb = min(v, max(0, b_eff - maps - extra) // (4 * n))
        while vb >= 1 and render_bytes(vb, 2) > b_eff:
            vb -= 1
        if vb >= 1:
            return RenderPlan(vb, b_eff, total)
    unit, div = _units(total, b_eff)
    raise ValueError(
        f"Render too large for one device: {g} images of {w}x{h} need "
        f"{estimate / div:.2f} {unit} to estimate the focus maps and "
        f"{render_bytes(1, 2) / div:.2f} {unit} for a one-view batch, "
        f"against a {b_eff / div:.2f} {unit} budget beyond the resident "
        f"stack, so even a one-view batch does not fit. Reduce the "
        f"resolution, the grid or the focus views."
    )


def check_capacity(resident_bytes: int, what: str, *, device="cuda",
                   budget: int | None = None, hint: str | None = None) -> None:
    """Raise before any device allocation when `resident_bytes` cannot fit.

    A lower-bound guard for paths without a batched arm (the stream, the
    fused quilt, a mesh rank's shard): it trips only on arithmetic
    certainty. `hint` replaces the default advice (a mesh render must not
    be told to batch views, ``MESH_HINT``)."""
    b = device_hbm_bytes(device, resident_bytes) if budget is None else budget
    b_eff = b - _headroom(b)
    if resident_bytes > b_eff:
        unit, div = _units(resident_bytes, b_eff)
        hint = hint or (
            "Use Interpolator.interpolate (which batches views "
            "automatically), or reduce the resolution or the grid."
        )
        raise ValueError(
            f"{what} needs at least {resident_bytes / div:.2f} {unit} of "
            f"device memory against a {b_eff / div:.2f} {unit} budget. {hint}"
        )


#: The advice of a mesh rank's shard that does not fit, the port's wording
#: of ``lfinterpolator_tpu/core/capacity.py:402-407`` (the port batches
#: views but has no row-block arm on one device).
MESH_HINT = (
    "Add GPUs along the mesh's 'space' axis (row sharding divides every "
    "per-rank operand but the replicated stack and the gathered views), "
    "shrink the replicated stack (fewer grid images or lower resolution), "
    "or render on one GPU without a mesh (Interpolator.interpolate batches "
    "views automatically)."
)
