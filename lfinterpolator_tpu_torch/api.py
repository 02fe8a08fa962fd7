"""High-level API: the Interpolator, on PyTorch.

Port of the single-device part of ``lfinterpolator_tpu/api.py``
(``RenderResult``, ``QuiltResult``, ``Interpolator.__init__``/
``interpolate``/``render_quilt``, the one-shot ``interpolate``):

    interp = Interpolator("/data/scene")            # load + upload once
    result = interp.interpolate("0,0,1,1", method="TEN", focus=0.2)
    result.save("out/")                             # 00.png..63.png
    result.save_quilt("out/quilt.png")              # 5x9 montage
    result = interp.interpolate("0,0,1,1", focus=0.1, focus_range=0.3)
    result.save("out/")                             # + map0.png, map1.png
    interp.render_quilt("0,0,1,1", focus=0.2).save("out/quilt.png")

The light field is uploaded once, as a planar u8 stack, at construction.
Each render computes its host arrays (``state.render_params`` for a
fixed-focus render; ``state.allfocus_params`` -- weights, offsets, focus
views, the focus tables and, with ``focus_pyramid``, the coarse-to-fine
plan -- for an all-in-focus one) and runs the pipeline on the
Interpolator's device. ``device="cuda"`` without a CUDA device raises;
nothing runs on the CPU instead.

Not ported yet (ROADMAP.md): batched trajectories, the capacity plan with
its view-batched and row-block arms for renders larger than device memory
(slice 4), meshes (slice 5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from lfinterpolator_tpu.core.config import RenderConfig

from . import state
from .io import LightField, load_light_field, write_quilt, write_views
from .models import pipeline
from .ops import blend_torch, quilt, quilt_torch
from .utils import profiling


@dataclasses.dataclass
class RenderResult:
    """Output of one interpolate() call."""

    views: np.ndarray  # [V, H, W, 3] uint8
    maps: np.ndarray | None  # [2, H, W] uint8 raw, filtered (focus_range > 0)
    run_times_s: list[float]  # per timed repetition (empty if not benchmarked)
    config: RenderConfig
    device: str = "cpu"  # where the render ran; save_quilt assembles there

    @property
    def avg_ms(self) -> float | None:
        if not self.run_times_s:
            return None
        return 1000.0 * sum(self.run_times_s) / len(self.run_times_s)

    @property
    def megapixels_per_s(self) -> float | None:
        """Output-pixel throughput of the render step."""
        if not self.run_times_s:
            return None
        v, h, w = self.views.shape[:3]
        avg = sum(self.run_times_s) / len(self.run_times_s)
        return v * h * w / avg / 1e6

    def save(self, path: str, *, progress: bool = True) -> list[str]:
        return write_views(path, self.views, maps=self.maps, progress=progress)

    def save_quilt(self, path: str, cols: int = 5, rows: int = 9,
                   tile_size: tuple[int, int] | None = None) -> str:
        """Write the first cols*rows views as a quilt PNG at `path`,
        assembled on the render's device (the tile-copy kernel on CUDA)."""
        n = cols * rows
        if self.views.shape[0] < n:
            raise ValueError(f"Quilt needs {n} views, got {self.views.shape[0]}")
        views = blend_torch.to_planar(
            torch.from_numpy(np.ascontiguousarray(self.views[:n])).to(self.device))
        q = quilt.assemble_quilt(views, cols, rows, tile_size)
        return write_quilt(path, quilt_torch.to_hwc(q).cpu().numpy())


@dataclasses.dataclass
class QuiltResult:
    """Output of one render_quilt() call."""

    quilt: np.ndarray  # [rows*tile_h, cols*tile_w, 3] uint8
    run_times_s: list[float]  # per timed repetition (empty if not benchmarked)
    config: RenderConfig
    fused: bool  # True when the direct-to-canvas kernel ran

    @property
    def avg_ms(self) -> float | None:
        if not self.run_times_s:
            return None
        return 1000.0 * sum(self.run_times_s) / len(self.run_times_s)

    @property
    def gigapixels_per_s(self) -> float | None:
        """Canvas-pixel throughput of the render step."""
        if not self.run_times_s:
            return None
        h, w = self.quilt.shape[:2]
        avg = sum(self.run_times_s) / len(self.run_times_s)
        return h * w / avg / 1e9

    def save(self, path: str) -> str:
        return write_quilt(path, self.quilt)


def _not_ported(what: str, slice_no: int | str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to lfinterpolator_tpu_torch "
        f"(ROADMAP slice {slice_no})"
    )


def _free_bytes(device: torch.device) -> int:
    return torch.cuda.mem_get_info(device)[0]


class Interpolator:
    """Load a light field once; render novel-view sets many times."""

    def __init__(
        self,
        source: str | LightField,
        *,
        config: RenderConfig | None = None,
        progress: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"device must be cpu or cuda, not {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the render needs a CUDA device "
                "(pass device='cpu' for the plain PyTorch path)"
            )
        self.config = config or RenderConfig()
        self.lf = (
            source if isinstance(source, LightField)
            else load_light_field(source, progress=progress)
        )
        if progress:
            print(
                f"Loaded {self.lf.cols}x{self.lf.rows} grid of "
                f"{self.lf.width}x{self.lf.height} images"
            )
        g, h, w = self.lf.grid_size, self.lf.height, self.lf.width
        if self.device.type == "cuda":
            need, free = g * 3 * h * w, _free_bytes(self.device)
            if need > free:
                raise RuntimeError(
                    f"the {g}-image stack needs {need / 2**30:.2f} GiB of "
                    f"device memory, {free / 2**30:.2f} GiB are free"
                )
        # One host->device upload of the planar RGB stack (api.py:239-260).
        self.images = state.upload_images(self.lf.images, self.device)

    def _check_memory(self, v: int, method_key: str, focus_views: int = 0,
                      extra: int = 0) -> None:
        """Raise before allocating when a render cannot fit the device.

        `focus_views` > 0 sizes an all-in-focus render: beside the output
        it holds the K focus views, gathered and in the estimate kernel's
        RGBx layout, and the two maps. `extra` bytes are held beside it
        (a quilt's canvas)."""
        if self.device.type != "cuda":
            return
        g, c, h, w = self.images.shape
        out = v * c * h * w
        # output + its [V, H, W, C] copy for the download, + the plain
        # path's temporaries
        need = 2 * out + extra
        if focus_views:
            need += focus_views * (c + 4) * h * w + 2 * h * w
        elif method_key == "STD":
            need += blend_torch.temp_bytes(g, v, c, h, w)
        free = _free_bytes(self.device)
        if need > free:
            raise RuntimeError(
                f"rendering {v} views of {w}x{h} needs {need / 2**30:.2f} GiB "
                f"of device memory beyond the stack, {free / 2**30:.2f} GiB "
                "are free; view-batched rendering is not yet ported "
                "(ROADMAP slice 4)"
            )

    def _config(self, focus, focus_range, method, effect, aspect):
        """-> (the render's validated config, "TEN" or "STD")."""
        cfg = dataclasses.replace(
            self.config,
            focus=focus,
            focus_range=focus_range,
            method=(method or self.config.method),
            effect=(effect if effect is not None else self.config.effect),
            aspect=(aspect if aspect is not None else self.config.aspect),
        )
        cfg.validate()
        return cfg, "TEN" if cfg.method in ("TEN", "TEN_WM") else "STD"

    def _render_step(self, trajectory: str, cfg: RenderConfig, method_key: str,
                     progress: bool, extra: int = 0):
        """Upload one render's host arrays; -> the step that renders
        (views [V, C, H, W] uint8, maps [2, H, W] uint8 or None) on the
        device. `extra` bytes are held beside the render (_check_memory)."""
        lf = self.lf
        if cfg.uses_focus_map:
            params = state.allfocus_params(
                trajectory, cols=lf.cols, rows=lf.rows, height=lf.height,
                width=lf.width, config=cfg,
            )
            weights, offsets, ids, tables = state.upload_allfocus(
                params, self.device
            )
            self._check_memory(cfg.view_count, method_key,
                               len(params.focus_ids), extra)
            if progress:
                print("Estimating focus map...")

            def step() -> tuple[torch.Tensor, torch.Tensor]:
                return pipeline.render_all_focus(
                    self.images, weights, offsets, ids, tables,
                    method=method_key, radius=params.radius,
                    filter_radius=params.filter_radius,
                    exact_taps=cfg.exact_focus_taps, pyramid=params.pyramid,
                )
            return step
        wm, fo = state.render_params(
            trajectory, cols=lf.cols, rows=lf.rows, height=lf.height,
            width=lf.width, focus=cfg.focus, effect=cfg.effect,
            aspect=cfg.aspect, views=cfg.view_count,
        )
        weights, shifts = state.upload_params(wm, fo, self.device)
        self._check_memory(cfg.view_count, method_key, extra=extra)

        def step() -> tuple[torch.Tensor, None]:
            return pipeline.render_fixed_focus(
                self.images, weights, shifts, method=method_key
            ), None
        return step

    def _run(self, step, benchmark_runs: int, progress: bool):
        """-> (step(), the times of `benchmark_runs` more runs)."""
        out = step()
        if benchmark_runs <= 0:
            return out, []
        if progress:
            print("Rendering views...")
        bench = profiling.benchmark(step, runs=benchmark_runs, device=self.device)
        if progress:
            print(
                f"Average time of {benchmark_runs} runs: "
                f"{bench.avg_ms:.3f} ms ({bench.device})"
            )
        return out, bench.times_s

    def interpolate(
        self,
        trajectory: str,
        *,
        focus: float = 0.0,
        focus_range: float = 0.0,
        method: str | None = None,
        effect: float | None = None,
        aspect: float | None = None,
        benchmark_runs: int = 0,
        progress: bool = True,
    ) -> RenderResult:
        """Synthesize the novel-view set for one trajectory.

        Mirrors ``lfinterpolator_tpu.api.Interpolator.interpolate`` on one
        device; `benchmark_runs > 0` additionally times that many
        repetitions of the render step on the device (for an all-in-focus
        render: estimate, filter and blend). `focus_range > 0` renders all
        in focus and returns the maps, with the config's `focus_pyramid`
        by the approximate coarse-to-fine estimate where the geometry takes
        it (else the exact sweep, as ``api.py:690-693`` routes it). The
        render must fit the device (the capacity plan, view-batched arm,
        row blocks and mesh of ``api.py:364-526, 641-672`` come with ROADMAP
        slice 4).
        """
        cfg, method_key = self._config(focus, focus_range, method, effect, aspect)
        step = self._render_step(trajectory, cfg, method_key, progress)
        (views, maps), run_times = self._run(step, benchmark_runs, progress)
        views_np = blend_torch.from_planar(views).cpu().numpy()
        maps_np = None if maps is None else maps.cpu().numpy()
        return RenderResult(
            views=views_np, maps=maps_np, run_times_s=run_times, config=cfg,
            device=str(self.device),
        )

    def render_quilt(
        self,
        trajectory: str,
        *,
        focus: float = 0.0,
        focus_range: float = 0.0,
        method: str | None = None,
        effect: float | None = None,
        aspect: float | None = None,
        cols: int = 5,
        rows: int = 9,
        tile_size: tuple[int, int] | None = None,
        benchmark_runs: int = 0,
        progress: bool = True,
    ) -> QuiltResult:
        """Quilt-only render (Looking Glass 5x9 by default).

        A fixed-focus TEN render with native tiles takes the fused route
        (``fused=True``): ``quilt.quilt_blend`` blends only the cols*rows
        placed views, each straight into its tile of the canvas, and the
        per-view stack never exists. Everything else -- STD, all in focus
        (`focus_range > 0`), resized tiles -- renders every view and then
        assembles the canvas on the device (``quilt.assemble_quilt``), with
        the same bytes. The JAX package also sends geometries its TPU
        kernel cannot tile (h % 8 != 0 or w % 128 != 0) and
        capacity-batched sizes to the two-stage route; the port's kernel
        takes every geometry, so only method, focus range and tile size
        decide. `benchmark_runs` times the whole step: render and assembly
        for the two-stage route.
        """
        cfg, method_key = self._config(focus, focus_range, method, effect, aspect)
        lf = self.lf
        n = cols * rows
        if cols < 1 or rows < 1 or cfg.view_count < n:
            raise ValueError(
                f"Quilt needs {n} views ({cols}x{rows}), but view_count is "
                f"{cfg.view_count}"
            )
        native = tile_size is None or tuple(tile_size) == (lf.height, lf.width)
        th, tw = (lf.height, lf.width) if native else (int(v) for v in tile_size)
        if th < 1 or tw < 1:
            raise ValueError(f"tile size must be positive, got {tile_size}")
        canvas = 2 * n * 3 * th * tw  # the canvas and its [H, W, C] copy
        fused = not cfg.uses_focus_map and method_key == "TEN" and native
        if fused:
            wm, fo = state.render_params(
                trajectory, cols=lf.cols, rows=lf.rows, height=lf.height,
                width=lf.width, focus=cfg.focus, effect=cfg.effect,
                aspect=cfg.aspect, views=cfg.view_count,
            )
            weights, shifts = state.upload_params(wm, fo, self.device)
            self._check_memory(0, method_key, extra=canvas)

            def step() -> torch.Tensor:
                return quilt.quilt_blend(self.images, weights, shifts, cols, rows)
        else:
            resize = 0 if native else 4 * n * 3 * (lf.height * lf.width
                                                   + th * lf.width + th * tw)
            render = self._render_step(trajectory, cfg, method_key, progress,
                                       extra=canvas + resize)

            def step() -> torch.Tensor:
                views, _ = render()
                return quilt.assemble_quilt(views, cols, rows, tile_size)

        q, run_times = self._run(step, benchmark_runs, progress)
        return QuiltResult(
            quilt=quilt_torch.to_hwc(q).cpu().numpy(), run_times_s=run_times,
            config=cfg, fused=fused,
        )

    def interpolate_batch(self, *args, **kwargs):
        raise _not_ported("Batched trajectories (interpolate_batch)", 4)


def interpolate(
    input_path: str,
    output_path: str,
    trajectory: str,
    *,
    focus: float = 0.0,
    focus_range: float = 0.0,
    method: str = "STD",
    effect: float = 3.0,
    aspect: float = 1.0,
    benchmark_runs: int = 0,
    progress: bool = True,
    device: str | torch.device = "cuda",
) -> RenderResult:
    """One-shot convenience wrapper matching the reference CLI's behavior."""
    interp = Interpolator(
        input_path,
        config=RenderConfig(method=method, effect=effect, aspect=aspect),
        progress=progress,
        device=device,
    )
    result = interp.interpolate(
        trajectory,
        focus=focus,
        focus_range=focus_range,
        benchmark_runs=benchmark_runs,
        progress=progress,
    )
    result.save(output_path, progress=progress)
    return result
