"""Render configuration.

The port's own copy of ``lfinterpolator_tpu/core/config.py`` (same fields,
defaults, coercion and validation, so a config means the same render in
both packages). Mirrors the reference's flag surface (reference:
src/main.cpp:7-27) and exposes the quantities the reference hard-codes as
compile-time constants (reference: src/kernels.cu:9-13, 60-68, 245) as
overridable-but-defaulted fields.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Configuration of one interpolation run.

    CLI-facing fields mirror the reference flags (reference: src/main.cpp:7-43):
      focus       -> -f (default 0)
      focus_range -> -r (default 0; >0 enables the per-pixel focus map)
      method      -> -m ("STD" = plain PyTorch ops, "TEN" / "TEN_WM" = the hand-written kernels)
      effect      -> -s (default 3.0, values <= 0 coerced to 3.0, src/main.cpp:31-33)
      aspect      -> -a (default 1.0, values <= 0 coerced to 1.0, src/main.cpp:35-37)
    """

    # --- user-facing knobs (CLI flags) ---
    focus: float = 0.0
    focus_range: float = 0.0
    method: str = "STD"
    effect: float = 3.0
    aspect: float = 1.0

    # --- constants the reference bakes in at compile time ---
    # Number of synthesized novel views (VIEW_TOTAL_COUNT, src/kernels.cu:11-13).
    view_count: int = 64
    # Focus-search candidate count (STEPS, src/kernels.cu:245).
    focus_steps: int = 32
    # Number of center-nearest views used by the disparity search
    # (FOCUS_MAP_IDS_COUNT, src/kernels.cu:68).
    focus_map_views: int = 32
    # Color channels blended (CHANNELS, src/kernels.cu:9). Alpha is always 255.
    channels: int = 3
    # Stencil block radius = resolution / pixel_size_factor, rounded up to even
    # (PIXEL_SIZE_FACTOR, src/interpolator.cu:141-146).
    pixel_size_factor: int = 100
    # Focus-map box filter radius = block_radius / filter_radius_divisor
    # (src/kernels.cu:266-268).
    filter_radius_divisor: int = 10
    # Exact per-pixel truncation at every disparity-search stencil tap
    # (bit-identical to the reference kernel). False evaluates the tap
    # truncation at the center pixel (--fast-focus), which can flip the
    # argmin in a radius-wide band at coordinate sign changes
    # (ops/focus_torch.py).
    exact_focus_taps: bool = True
    # Coarse-to-fine disparity pyramid (cli --focus-pyramid): full candidate
    # sweep at half resolution, presence-predicated refine at full res
    # (ops/focus_estimate.focus_estimate_pyramid). APPROXIMATE: a pixel
    # whose global best lies outside its block's [coarse min-1, max+1]
    # window gets the best scanned candidate instead. Exact taps only;
    # geometries the plan does not take run the exact sweep. No reference
    # analogue (full sweep always, src/kernels.cu:239-258).
    focus_pyramid: bool = False
    # Streaming-only: re-estimate the focus maps every N frames; frames in
    # between blend with the most recent maps. APPROXIMATE for N > 1: stale
    # maps cost quality in proportion to depth motion (refresh frames are
    # bit-exact). 1 = per-frame estimation, the reference's per-run flow
    # (src/interpolator.cu:261-266). Ignored outside StreamingRenderer.
    focus_map_refresh: int = 1
    # (Benchmark repetitions are the CLI -b / api benchmark_runs parameter;
    # the reference hard-codes 100, src/interpolator.h:13.)

    def __post_init__(self):
        # The reference coerces non-positive -s / -a to their defaults
        # (src/main.cpp:31-37); we mirror that here so the API matches the CLI.
        if self.effect <= 0:
            object.__setattr__(self, "effect", 3.0)
        if self.aspect <= 0:
            object.__setattr__(self, "aspect", 1.0)

    def validate(self) -> None:
        if self.method not in ("STD", "TEN", "TEN_WM"):
            raise ValueError(
                f"The specified interpolation method {self.method!r} does not exist! "
                "Use 'STD' or 'TEN' (alias 'TEN_WM')."
            )
        if self.view_count <= 0:
            raise ValueError("view_count must be positive")
        if self.focus_steps < 2:
            raise ValueError("focus_steps must be >= 2")
        if self.channels != 3:
            raise ValueError("only 3-channel (RGB) blending is supported")
        if self.focus_map_refresh < 1:
            raise ValueError("focus_map_refresh must be >= 1")

    @property
    def uses_focus_map(self) -> bool:
        # range > 0 enables the per-pixel focus path (src/interpolator.cu:261).
        return self.focus_range > 0
