"""High-level API: the Interpolator, on PyTorch.

Port of ``lfinterpolator_tpu/api.py`` (``RenderResult``, ``QuiltResult``,
``Interpolator.__init__``/``interpolate``/``render_quilt``/
``interpolate_batch``, the view-batched arms, the mesh arms, the one-shot
``interpolate``):

    interp = Interpolator("/data/scene")            # load + upload once
    result = interp.interpolate("0,0,1,1", method="TEN", focus=0.2)
    result.save("out/")                             # 00.png..63.png
    result.save_quilt("out/quilt.png")              # 5x9 montage
    result = interp.interpolate("0,0,1,1", focus=0.1, focus_range=0.3)
    result.save("out/")                             # + map0.png, map1.png
    interp.render_quilt("0,0,1,1", focus=0.2).save("out/quilt.png")
    batch = interp.interpolate_batch(["0,0,1,1", "0.2,0.2,0.8,0.8"], focus=0.2)

The light field is uploaded once, as a planar u8 stack, at construction.
Each render computes its host arrays (``state.render_params`` for a
fixed-focus render; ``state.allfocus_params`` -- weights, offsets, focus
views, the focus tables and, with ``focus_pyramid``, the coarse-to-fine
plan -- for an all-in-focus one), sizes itself against the device's free
memory (``core/capacity.plan_render``) and runs the pipeline on the
Interpolator's device: in one pass, or, when the output does not fit, in
view batches, each downloaded into pinned host memory while the next one
renders (``_view_batched``). A one-pass frame on a card renders and
downloads in row bands where its shape gives it several
(``transfer.band_count``): each band's download overlaps the next band's
blend, and, all in focus with TEN, the next band's estimate
(``_OnePass``). ``device="cuda"`` without a CUDA device raises;
nothing runs on the CPU instead.

With ``mesh=`` (``parallel.mesh.make_mesh``, after
``parallel.distributed.initialize``) every rank of the process group
constructs the Interpolator and makes the same calls: each renders its
views and rows of the frame (``parallel/mesh.py``) and the results are
gathered to every rank, so each returns the whole result. On a mesh a
render's per-rank bytes are checked against its GPU and raise with
``capacity.MESH_HINT`` when they do not fit (no view batches), the quilt
takes the two-stage route, ``focus_pyramid`` is ignored (the exact sweep
runs, as ``api.py:690-692`` routes it), and `benchmark_runs` are timed on
the host clock from a barrier to a barrier across the ranks.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable

import numpy as np
import torch

from . import state
from .core import capacity, geometry
from .core.config import RenderConfig
from .io import LightField, load_light_field, write_quilt, write_views
from .models import pipeline
from .ops import blend_torch, quilt, quilt_torch
from .parallel import mesh as pmesh
from .utils import devices, profiling, transfer


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
        q = _assemble_host_views(self.views[:n], torch.device(self.device),
                                 cols, rows, tile_size)
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


def _assemble_host_views(views: np.ndarray, device: torch.device, cols: int,
                         rows: int, tile_size) -> torch.Tensor:
    """Host [n, H, W, 3] views -> the quilt canvas [C, rows*th, cols*tw] on
    `device`."""
    planar = blend_torch.to_planar(
        torch.from_numpy(np.ascontiguousarray(views)).to(device))
    return quilt.assemble_quilt(planar, cols, rows, tile_size)


def _group_by_center(centers: np.ndarray, tolerance: float) -> list[list[int]]:
    """Indices grouped by trajectory center, in order of first appearance
    (``lfinterpolator_tpu/api.py:1024-1042``): equal centers (to 1e-5 grid
    cells), or with `tolerance` > 0 the first earlier group whose founding
    center lies within it (Euclidean, grid cells)."""
    groups: dict[tuple, list[int]] = {}
    if tolerance > 0.0:
        reps: list[np.ndarray] = []
        for i, c in enumerate(centers):
            for gi, rep in enumerate(reps):
                if float(np.hypot(*(c - rep))) <= tolerance:
                    groups[(gi,)].append(i)
                    break
            else:
                groups[(len(reps),)] = [i]
                reps.append(c)
    else:
        for i, c in enumerate(centers):
            groups.setdefault(tuple(np.round(c / 1e-5).astype(np.int64)), []).append(i)
    return list(groups.values())


@dataclasses.dataclass(frozen=True)
class _OnePass:
    """The step of a render in one pass on one device (no view batches, no
    mesh). Called, it renders the frame on the device: -> (views [V, C, H,
    W], maps [2, H, W] or None). ``download`` renders it into host memory
    in its row `bands` (``transfer.frame_bands``), each downloaded while
    the next renders; with `focus_bands`, each band's rows of the raw map
    are estimated just before the band blends, and the filter runs after
    the last band."""

    blend: Callable  # (maps, r0, hb) -> views [V, C, hb, W]; hb None: the frame
    estimate: Callable | None  # () -> maps [2, H, W]; None for a fixed focus
    bands: list[tuple[int, int]]
    focus_bands: Callable | None = None  # () -> pipeline.FocusBands; None: whole

    def __call__(self):
        maps = None if self.estimate is None else self.estimate()
        return self.blend(maps, 0, None), maps

    def download(self, downloader: transfer.Downloader):
        """-> (host views [V, H, W, C], host maps [2, H, W] or None),
        rendered and downloaded band by band (``Downloader.start_bands``)."""
        if self.focus_bands is not None:
            est = self.focus_bands()
            return downloader.start_bands(
                lambda r0, hb: self.blend(est.rows(r0, hb), r0, hb), self.bands,
                est.finish).wait()
        maps = None if self.estimate is None else self.estimate()
        out = downloader.start_bands(functools.partial(self.blend, maps), self.bands,
                                     maps).wait()
        return out if maps is not None else (out, None)


class Interpolator:
    """Load a light field once; render novel-view sets many times."""

    def __init__(
        self,
        source: str | LightField,
        *,
        config: RenderConfig | None = None,
        progress: bool = True,
        device: str | torch.device = "cuda",
        mesh=None,  # parallel.mesh.make_mesh()'s (view, space) DeviceMesh
    ):
        self.device = devices.resolve(device, "the render")
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
        self.mesh = mesh
        if mesh is not None:
            n_space, n_view = pmesh.axis_size(mesh, "space"), pmesh.axis_size(mesh, "view")
            if h % n_space != 0:
                raise ValueError(
                    f"Image height {h} must divide by the mesh space axis "
                    f"({n_space}) for sharded rendering"
                )
            if self.config.view_count % n_view != 0:
                raise ValueError(
                    f"view_count {self.config.view_count} must divide by the "
                    f"mesh view axis ({n_view})"
                )
        if self.device.type == "cuda":
            need, free = g * 3 * h * w, torch.cuda.mem_get_info(self.device)[0]
            if need > free:
                raise RuntimeError(
                    f"the {g}-image stack needs {need / 2**30:.2f} GiB of "
                    f"device memory, {free / 2**30:.2f} GiB are free"
                )
        # One host->device upload of the planar RGB stack (api.py:239-260),
        # on a mesh then rank 0's bytes on every rank.
        self.images = state.upload_images(self.lf.images, self.device)
        if mesh is not None:
            pmesh.replicate(mesh, self.images)
        # The downloads' side stream (utils/transfer.py).
        self._download = transfer.Downloader(self.device)

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

    def _plan(self, v: int, method_key: str, focus_views: int, extra: int,
              progress: bool) -> capacity.RenderPlan:
        g, c, h, w = self.images.shape
        with profiling.span("lfi.plan"):
            plan = capacity.plan_render(g, c, h, w, v, method=method_key,
                                        focus_views=focus_views, extra=extra,
                                        device=self.device)
        if plan.batched and progress:
            print(f"Rendering {v} views in {-(-v // plan.view_batch)} batches "
                  f"of {plan.view_batch} (the output exceeds device memory)")
        return plan

    def _view_batched(self, weights: torch.Tensor, vb: int, render) -> np.ndarray:
        """Render the rows of `weights` [V, G] in batches of `vb`,
        ``render(rows)`` -> device views [vb, C, H, W] each, and download
        each batch (a side stream, into its rows of one pinned host array)
        while the next renders, so at most two batch outputs are on the
        device (``lfinterpolator_tpu/api.py:98-121``). -> host [V, H, W, C]."""
        _, c, h, w = self.images.shape
        v = weights.shape[0]
        out = transfer.host_empty((v, h, w, c), self.device)
        pending = None
        for lo in range(0, v, vb):
            started = self._download.start(render(weights[lo:lo + vb]),
                                           out=out[lo:lo + vb])
            if pending is not None:
                pending.wait()
            pending = started
        pending.wait()
        return out.numpy()

    def _fixed_step(self, wm: np.ndarray, fo: np.ndarray, method_key: str,
                    progress: bool, extra: int = 0):
        """-> the step of a fixed-focus render of the weight rows `wm`
        [V, G] at the shifts `fo` [G, 2]: () -> (views, None), views device
        [V, C, H, W], or host [V, H, W, C] when the plan batches. On a
        mesh: this rank's block [V/nv, C, H/ns, W] (``_collect`` gathers)."""
        if self.mesh is not None:
            return self._mesh_fixed_step(wm, fo, method_key, extra)
        plan = self._plan(len(wm), method_key, 0, extra, progress)
        with profiling.span("lfi.upload"):
            weights, shifts = state.upload_params(wm, fo, self.device)

        def render(rows: torch.Tensor, r0: int = 0, hb: int | None = None) -> torch.Tensor:
            return pipeline.render_fixed_focus(self.images, rows, shifts, method=method_key,
                                               row_start=r0, row_count=hb)

        if plan.batched:
            return lambda: (self._view_batched(weights, plan.view_batch, render), None)
        return _OnePass(lambda maps, r0, hb: render(weights, r0, hb), None,
                        self._bands(len(wm), allfocus=False))

    def _allfocus_step(self, params: state.AllFocusParams, cfg: RenderConfig,
                       method_key: str, progress: bool, extra: int = 0):
        """-> the step of an all-in-focus render of `params` (its weight
        rows, possibly several trajectories' stacked): () -> (views, maps
        [2, H, W] on the device). The maps are estimated once per step;
        every view batch blends with them on the per-pixel-focus kernel. On a
        mesh: this rank's blocks (``_collect`` gathers)."""
        if self.mesh is not None:
            return self._mesh_allfocus_step(params, cfg, method_key, progress, extra)
        plan = self._plan(len(params.weights), method_key, len(params.focus_ids),
                          extra, progress)
        with profiling.span("lfi.upload"):
            weights, offsets, ids, tables = state.upload_allfocus(params, self.device)
        if progress:
            print("Estimating focus map...")

        def estimate() -> torch.Tensor:
            return pipeline.compute_focus_maps(
                self.images, offsets, ids, tables, radius=params.radius,
                filter_radius=params.filter_radius,
                exact_taps=cfg.exact_focus_taps, pyramid=params.pyramid,
            )

        def render(rows: torch.Tensor, maps: torch.Tensor, r0: int = 0,
                   hb: int | None = None) -> torch.Tensor:
            block = maps if hb is None else maps[:, r0:r0 + hb]
            return pipeline.blend_all_focus(self.images, rows, offsets, block,
                                            tables.decode, method=method_key,
                                            row_start=r0, row_count=hb)

        if plan.batched:
            def step():
                maps = estimate()
                return self._view_batched(weights, plan.view_batch,
                                          lambda rows: render(rows, maps)), maps
            return step
        v, k = len(params.weights), len(params.focus_ids)
        bands = self._bands(v, allfocus=True)
        focus_bands = None
        # TEN blends with the raw map alone, so each band can blend right
        # after its rows are estimated, where the copy sets the frame's pace;
        # the pyramid's refine pass takes the whole frame. The prepared
        # estimate keeps its RGBx words through the blend, so it runs only
        # where the plan's budget holds them too.
        g, c, h, w = self.images.shape
        if (method_key == "TEN" and params.pyramid is None and len(bands) > 1
                and transfer.estimate_in_bands(g, v, c, h, w, k, cfg.focus_steps)
                and plan.bytes_unbatched + 4 * k * h * w <= plan.budget):
            def focus_bands() -> pipeline.FocusBands:
                return pipeline.FocusBands(
                    self.images, offsets, ids, tables, radius=params.radius,
                    filter_radius=params.filter_radius, exact_taps=cfg.exact_focus_taps)
        return _OnePass(lambda maps, r0, hb: render(weights, maps, r0, hb), estimate,
                        bands, focus_bands)

    def _check_mesh(self, phases: dict[str, int], what: str, extra: int) -> None:
        """Raise ValueError with the per-rank arithmetic and
        ``capacity.MESH_HINT`` before anything is allocated when a shard's
        peak (`phases`, from ``pmesh.*_shard_bytes``; the stack is resident
        already) and `extra` bytes do not fit this rank's device."""
        capacity.check_capacity(
            phases["peak"] - phases["stack"] + extra,
            f"{what} (per rank, beyond the replicated stack)",
            device=self.device, hint=capacity.MESH_HINT)

    def _mesh_fixed_step(self, wm: np.ndarray, fo: np.ndarray, method_key: str,
                         extra: int = 0):
        """The mesh arm of ``_fixed_step`` (``api.py:732-765``)."""
        g, c, h, w = self.images.shape
        self._check_mesh(pmesh.fixed_shard_bytes(
            pmesh.axis_size(self.mesh, "view"), pmesh.axis_size(self.mesh, "space"),
            g, c, h, w, len(wm), method=method_key),
            "Mesh fixed-focus render", extra)
        weights_l, shifts = state.upload_params(pmesh.shard_weights(self.mesh, wm),
                                                fo, self.device)
        return lambda: (pmesh.render_fixed_sharded(self.mesh, self.images, weights_l,
                                                   shifts, method_key), None)

    def _mesh_allfocus_step(self, params: state.AllFocusParams, cfg: RenderConfig,
                            method_key: str, progress: bool, extra: int = 0):
        """The mesh arm of ``_allfocus_step`` (``api.py:654-700``): the
        exact or fast sweep, never the pyramid."""
        g, c, h, w = self.images.shape
        self._check_mesh(pmesh.allfocus_shard_bytes(
            pmesh.axis_size(self.mesh, "view"), pmesh.axis_size(self.mesh, "space"),
            g, len(params.focus_ids), c, h, w, len(params.weights),
            radius=params.radius, filter_radius=params.filter_radius,
            steps=cfg.focus_steps), "Mesh all-focus render", extra)
        local = dataclasses.replace(
            params, weights=pmesh.shard_weights(self.mesh, params.weights))
        weights_l, offsets, ids, tables = state.upload_allfocus(local, self.device)
        if progress:
            print("Estimating focus map...")
        return lambda: pmesh.render_all_focus_sharded(
            self.mesh, self.images, weights_l, offsets, ids, tables,
            method=method_key, radius=params.radius,
            filter_radius=params.filter_radius, exact_taps=cfg.exact_focus_taps)

    def _collect(self, views, maps):
        """A step's output as the whole result: on a mesh, every rank's
        blocks gathered to device [V, C, H, W] views and [2, H, W] maps on
        every rank; else as it is."""
        if self.mesh is None:
            return views, maps
        views = pmesh.gather_views_device(self.mesh, views)
        return views, None if maps is None else pmesh.gather_rows(self.mesh, maps)

    def _render_step(self, trajectory: str, cfg: RenderConfig, method_key: str,
                     progress: bool, extra: int = 0):
        """The step of one trajectory's render (``_fixed_step`` or
        ``_allfocus_step``). `extra` bytes are held beside the render."""
        lf = self.lf
        with profiling.span("lfi.params"):
            if cfg.uses_focus_map:
                params = state.allfocus_params(
                    trajectory, cols=lf.cols, rows=lf.rows, height=lf.height,
                    width=lf.width, config=cfg,
                )
            else:
                wm, fo = state.render_params(
                    trajectory, cols=lf.cols, rows=lf.rows, height=lf.height,
                    width=lf.width, focus=cfg.focus, effect=cfg.effect,
                    aspect=cfg.aspect, views=cfg.view_count,
                )
        if cfg.uses_focus_map:
            return self._allfocus_step(params, cfg, method_key, progress, extra)
        return self._fixed_step(wm, fo, method_key, progress, extra)

    def _to_host(self, views, maps) -> tuple[np.ndarray, np.ndarray | None]:
        """A step's output on the host: the download helper for device
        views; view batches are on the host already."""
        if isinstance(views, np.ndarray):
            return views, None if maps is None else maps.cpu().numpy()
        out = self._download.start(views, maps).wait()
        return out if maps is not None else (out, None)

    def _bands(self, v: int, allfocus: bool) -> list[tuple[int, int]]:
        """The row bands of a one-pass frame of `v` views
        (``transfer.frame_bands``)."""
        g, c, h, w = self.images.shape
        return transfer.frame_bands(self.device, g, c, h, w, v, allfocus=allfocus)

    def _host_frame(self, step) -> tuple[np.ndarray, np.ndarray | None]:
        """Run `step` once -> its output on the host: a one-pass step of
        several row bands rendered and downloaded band by band
        (``_OnePass.download``), any other rendered whole, gathered and
        downloaded (``_to_host``). For ``interpolate``."""
        if isinstance(step, _OnePass) and len(step.bands) > 1:
            return step.download(self._download)
        return self._to_host(*self._collect(*step()))

    def _run(self, step, benchmark_runs: int, progress: bool):
        """-> (step(), the times of `benchmark_runs` more runs)."""
        out = step()
        if benchmark_runs <= 0:
            return out, []
        if progress:
            print("Rendering views...")
        timer = profiling.benchmark if self.mesh is None else pmesh.benchmark
        bench = timer(step, runs=benchmark_runs, device=self.device)
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
        render: estimate, filter and blend; for a view-batched render also
        the downloads it overlaps). `focus_range > 0` renders all in focus
        and returns the maps, with the config's `focus_pyramid` by the
        approximate coarse-to-fine estimate where the geometry takes it
        (else the exact sweep, as ``api.py:690-693`` routes it). A render
        whose output does not fit the device runs in view batches; one
        that cannot fit even so raises before allocating.

        A frame rendered in one pass on one card is downloaded in row
        bands where ``transfer.band_count`` gives its shape more than one
        (the longer its blend against its copy to the host, the more, at
        most 8): the estimate and filter run on the whole frame and their
        maps go to the host as one copy, then each band of rows is blended
        and copied into its rows of the one pinned host array while the
        next band blends, so the copy starts after the first band, not
        after the whole blend. A TEN all-in-focus frame without the
        pyramid estimates each band's rows of its raw map just before it
        blends them (TEN blends with the raw map alone), filters after the
        last band and sends its maps last, so the copy starts after one
        band's estimate, not the frame's. A short blend (HCI's 512² frames), view
        batches, a mesh, the CPU and `benchmark_runs > 0` download the
        whole frame after its render, as ``interpolate_batch`` and
        ``render_quilt`` always do; the host arrays are the same bytes
        either way.
        """
        with profiling.span("lfi.interpolate"):
            cfg, method_key = self._config(focus, focus_range, method, effect, aspect)
            step = self._render_step(trajectory, cfg, method_key, progress)
            if benchmark_runs > 0:  # the step is timed rendering whole frames
                out, run_times = self._run(step, benchmark_runs, progress)
                views_np, maps_np = self._to_host(*self._collect(*out))
            else:
                (views_np, maps_np), run_times = self._host_frame(step), []
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
        (`focus_range > 0`), resized tiles -- renders every view (in view
        batches when they do not fit) and then assembles the canvas on the
        device (``quilt.assemble_quilt``), with the same bytes. The JAX
        package also sends geometries its TPU kernel cannot tile
        (h % 8 != 0 or w % 128 != 0) to the two-stage route; the port's
        kernel takes every geometry, so only method, focus range and tile
        size decide. `benchmark_runs` times the whole step: render and
        assembly for the two-stage route. Either route's canvas is
        downloaded whole through ``transfer.Downloader.start``, as a
        one-image frame, into pinned host memory that the returned quilt
        then owns.
        """
        with profiling.span("lfi.render_quilt"):
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
            fused = (self.mesh is None and not cfg.uses_focus_map
                     and method_key == "TEN" and native)
            if fused:
                with profiling.span("lfi.params"):
                    wm, fo = state.render_params(
                        trajectory, cols=lf.cols, rows=lf.rows, height=lf.height,
                        width=lf.width, focus=cfg.focus, effect=cfg.effect,
                        aspect=cfg.aspect, views=cfg.view_count,
                    )
                with profiling.span("lfi.upload"):
                    weights, shifts = state.upload_params(wm, fo, self.device)
                with profiling.span("lfi.plan"):
                    capacity.check_capacity(
                        canvas, f"A {cols}x{rows} quilt of {lf.width}x{lf.height} tiles",
                        device=self.device)

                def step() -> torch.Tensor:
                    with profiling.span("lfi.blend"):
                        return quilt.quilt_blend(self.images, weights, shifts, cols, rows)
            else:
                resize = 0 if native else 4 * n * 3 * (lf.height * lf.width
                                                       + th * lf.width + th * tw)
                render = self._render_step(trajectory, cfg, method_key, progress,
                                           extra=canvas + resize)

                def step() -> torch.Tensor:
                    views, _ = self._collect(*render())
                    if isinstance(views, np.ndarray):  # view batches, on the host
                        return _assemble_host_views(views[:n], self.device, cols,
                                                    rows, tile_size)
                    return quilt.assemble_quilt(views, cols, rows, tile_size)

            q, run_times = self._run(step, benchmark_runs, progress)
            with profiling.span("lfi.quilt.hwc"):
                pending = self._download.start(q[None])
            with profiling.span("lfi.quilt.download"):
                q = pending.wait()[0]
            return QuiltResult(quilt=q, run_times_s=run_times, config=cfg, fused=fused)

    def interpolate_batch(
        self,
        trajectories: list[str],
        *,
        focus: float = 0.0,
        focus_range: float = 0.0,
        method: str | None = None,
        effect: float | None = None,
        aspect: float | None = None,
        center_tolerance: float = 0.0,
        progress: bool = True,
    ) -> list[RenderResult]:
        """Render several trajectories in few kernel passes.

        Port of ``lfinterpolator_tpu.api.Interpolator.interpolate_batch``
        (``api.py:967-1224``). The per-image shifts depend only on a
        trajectory's center, so trajectories are grouped by center, and
        each group stacks its weight matrices into one [n*V, G] matrix that
        one launch of the kernel blends: every source pixel is read once
        for the whole group. Each group is planned on its own and falls
        back to view batches when its stacked output does not fit. With
        `focus_range > 0` a group also shares its focus views and maps:
        one estimate per group, and each result carries the group's maps.
        Results come back in the caller's order.

        `center_tolerance` (grid-cell units, default 0 = off) also merges
        groups whose centers lie within that distance of an earlier
        group's first center; members of a merged group render with that
        first member's center (its offsets, focus views and maps), an
        approximation for jittered serving traffic.

        An empty list of trajectories returns an empty list: there is no
        group to render, and nothing is planned, uploaded or launched. (The
        JAX package raises ``ValueError`` from ``np.stack`` there, which no
        caller can want; the arguments are still validated.)
        """
        with profiling.span("lfi.interpolate_batch"):
            cfg, method_key = self._config(focus, focus_range, method, effect, aspect)
            lf = self.lf
            v = cfg.view_count
            centers = [
                geometry.trajectory_center(geometry.parse_trajectory(t, (lf.cols, lf.rows)))
                for t in trajectories
            ]
            results: list[RenderResult | None] = [None] * len(trajectories)
            for idxs in _group_by_center(centers, center_tolerance):
                first = trajectories[idxs[0]]
                with profiling.span("lfi.params"):
                    if cfg.uses_focus_map:
                        params = state.allfocus_params(
                            first, cols=lf.cols, rows=lf.rows, height=lf.height,
                            width=lf.width, config=cfg,
                        )
                    members = [
                        state.render_params(
                            trajectories[i], cols=lf.cols, rows=lf.rows,
                            height=lf.height, width=lf.width, focus=cfg.focus,
                            effect=cfg.effect, aspect=cfg.aspect, views=v,
                        )
                        for i in idxs
                    ]
                big = np.concatenate([wm for wm, _ in members])  # [len(idxs) * V, G]
                fo = members[0][1]  # the first member's shifts
                if self.mesh is not None and len(big) % pmesh.axis_size(self.mesh, "view"):
                    raise ValueError(
                        f"batched view count {len(big)} must divide by the mesh "
                        f"view axis ({pmesh.axis_size(self.mesh, 'view')})"
                    )
                if cfg.uses_focus_map:
                    step = self._allfocus_step(dataclasses.replace(params, weights=big),
                                               cfg, method_key, progress)
                else:
                    step = self._fixed_step(big, fo, method_key, progress)
                views_np, maps_np = self._to_host(*self._collect(*step()))
                for j, i in enumerate(idxs):
                    results[i] = RenderResult(
                        views=views_np[j * v:(j + 1) * v], maps=maps_np,
                        run_times_s=[], config=cfg, device=str(self.device),
                    )
            return results  # type: ignore[return-value]


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
