"""Streaming (video) light-field rendering.

Port of ``lfinterpolator_tpu/streaming.py``: render a sequence of
light-field frames of one geometry, with the host->device upload of frame
t+1 and the download of frame t-1 overlapped with the render of frame t,
and PNG writes overlapped with all three.

The JAX package expresses the overlap as a prefetch queue over its
asynchronous dispatch. The CUDA form of it:

    decode thread:    frames -> pinned host buffers         (prefetch + 1)
    upload stream:    pinned buffer -> device frame t+1     (event; enqueued
                                                            by the decode
                                                            thread)
    current stream:   planar copy + render of frame t       (waits on it)
    download stream:  views of frame t-1 -> pinned memory   (event)
    writer pool:      PNG encode (``render_to_dir``)

At most `prefetch` renders are in flight before the oldest one is
downloaded and yielded. The stream's spans (``utils/profiling.span``):

    lfi.stream.feed    decode thread: one host frame into its pinned buffer
                       (a buffer's first allocation too; not the wait for
                       the slot's last upload)
    lfi.stream.take    render loop: the wait for the next uploaded frame,
                       its event and the planar copy's launch
    lfi.stream.frame   one frame's render and ``Downloader.start`` (its
                       ``lfi.estimate``, ``lfi.filter``, ``lfi.blend`` and
                       ``lfi.download.start`` inside)
    lfi.stream.drain   the wait for the oldest frame's download (its
                       ``lfi.download.wait`` inside), the last ones too

and its counter, ``stream stalls``: the frames for which the render loop
found no uploaded frame ready when it asked (``profiling.launch_counts``).

A fixed-focus TEN frame is one ``shift_blend`` launch on the raw stack:
its operand load is the clamp-shift that the JAX package's
``shift_pallas._shift_kernel`` (K2) computed into a tiled intermediate, so
no shifted or tile-padded stack exists and every geometry streams. A fixed-focus STD frame is the plain ops; an all-focus frame is
a per-pixel blend with the maps (estimate, filter) of the first of every
``focus_map_refresh`` N frames: at N = 1 every frame's own.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import queue
import threading
import time
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from . import state
from .core import capacity
from .core.config import RenderConfig
from .io import writer
from .models import pipeline
from .ops import blend_torch
from .utils import devices, profiling, transfer


@dataclasses.dataclass
class StreamStats:
    frames: int  # total accounted for (rendered + skipped)
    total_s: float
    skipped: int = 0  # complete frames skipped by resume

    @property
    def rendered(self) -> int:
        return self.frames - self.skipped

    @property
    def fps(self) -> float:
        """Throughput of the frames actually rendered."""
        return self.rendered / self.total_s if self.total_s > 0 else 0.0


def _take(ready: queue.Queue, done: object):
    """The decode thread's next frame from `ready`, or None after its last
    (`done`); an error of the thread is raised here. A frame that was not
    there yet when asked for counts as a ``stream stalls``."""
    stalled = ready.empty()
    item = ready.get()
    if isinstance(item, BaseException):
        raise item
    if item is done:
        return None
    if stalled:
        profiling.count("stream stalls")
    return item


def _drain(pending: transfer.Pending):
    """The oldest frame's download, waited for."""
    with profiling.span("lfi.stream.drain"):
        return pending.wait()


class StreamingRenderer:
    """Fixed-geometry renderer for a sequence of light-field frames.

    Frames are [G, H, W, C>=3] uint8 host arrays, G = cols * rows, all of
    one shape. ``device="cuda"`` (the default) without a CUDA device
    raises; ``device="cpu"`` runs the plain PyTorch path.
    """

    def __init__(
        self,
        cols: int,
        rows: int,
        width: int,
        height: int,
        trajectory: str,
        *,
        config: RenderConfig | None = None,
        prefetch: int = 2,
        device: str | torch.device = "cuda",
    ):
        self.device = devices.resolve(device, "the stream")
        self.cfg = config or RenderConfig()
        self.cfg.validate()
        self.cols, self.rows = cols, rows
        self.width, self.height = width, height
        self.prefetch = max(1, prefetch)
        self.method = "TEN" if self.cfg.method in ("TEN", "TEN_WM") else "STD"
        cfg = self.cfg
        if cfg.uses_focus_map:
            self._params = state.allfocus_params(
                trajectory, cols=cols, rows=rows, height=height, width=width,
                config=cfg,
            )
            (self.weights, self._offsets, self._ids,
             self._tables) = state.upload_allfocus(self._params, self.device)
            self._frame_idx = 0
            self._maps = None
        else:
            wm, fo = state.render_params(
                trajectory, cols=cols, rows=rows, height=height, width=width,
                focus=cfg.focus, effect=cfg.effect, aspect=cfg.aspect,
                views=cfg.view_count,
            )
            self.weights, self.shifts = state.upload_params(wm, fo, self.device)
        # Host-side guard: the stream has no view-batched arm. Each frame in
        # flight holds its upload (RGBA at most) and planar stack, its views
        # and their download copy; plus the estimate's operands all in
        # focus, or STD's plain temporaries.
        g, n = cols * rows, height * width
        frame = g * 7 * n + 2 * cfg.view_count * 3 * n
        resident = (self.prefetch + 1) * frame
        if cfg.uses_focus_map:
            resident += capacity.estimate_bytes(len(self._params.focus_ids), 3,
                                                height, width)
        elif self.method == "STD":
            resident += blend_torch.temp_bytes(g, cfg.view_count, 3, height, width)
        capacity.check_capacity(
            resident,
            f"Streaming {cfg.view_count} views per {width}x{height} frame "
            f"from {g} images (prefetch={self.prefetch})",
            device=self.device,
        )
        self._download = transfer.Downloader(self.device)
        # pinned host frames and the upload stream, kept across streams
        self._host_frames: dict[int, torch.Tensor] = {}
        self._upload = None

    def _render(self, images: torch.Tensor):
        """One planar frame [G, 3, H, W] on the device -> views
        [V, 3, H, W], or (views, maps [2, H, W]) all in focus."""
        if not self.cfg.uses_focus_map:
            return pipeline.render_fixed_focus(images, self.weights, self.shifts,
                                               method=self.method)
        cfg, p = self.cfg, self._params
        # Temporal map reuse (streaming.py:224-252): re-estimate every N
        # frames, blend the frames in between with the latest maps. A frame
        # that estimates (every frame at N = 1) is the frame's all-in-focus
        # render.
        if self._frame_idx % cfg.focus_map_refresh == 0:
            self._maps = pipeline.compute_focus_maps(
                images, self._offsets, self._ids, self._tables, radius=p.radius,
                filter_radius=p.filter_radius, exact_taps=cfg.exact_focus_taps,
                pyramid=p.pyramid)
        self._frame_idx += 1
        views = pipeline.blend_all_focus(images, self.weights, self._offsets,
                                         self._maps, self._tables.decode,
                                         method=self.method)
        return views, self._maps

    def _frames_cuda(self, frames: Iterable[np.ndarray]) -> Iterator[torch.Tensor]:
        """Planar device frames: a decode thread copies each host frame into
        one of prefetch + 1 pinned buffers and enqueues its copy to the
        device on the upload stream at once; the current stream waits for
        that copy's event before the planar copy. A buffer is refilled only
        after the event of its last upload.

        The upload is enqueued by the decode thread, not when the render
        loop takes the frame: an all-in-focus frame's render waits on the
        host for its own estimate (the filter's divisor, a host scalar
        copied to the device), and an upload enqueued only then would sit
        on that wait, one frame's copy a frame, instead of running under
        the frames before it."""
        dev = self.device
        if self._upload is None:
            self._upload = torch.cuda.Stream(dev)
        upload, buffers = self._upload, self._host_frames
        free: queue.Queue = queue.Queue()
        for slot in range(self.prefetch + 1):
            free.put((slot, None))
        ready: queue.Queue = queue.Queue()
        done = object()
        stop = threading.Event()

        def feeder():
            try:
                for f in frames:
                    slot, event = free.get()
                    if stop.is_set():
                        return
                    if event is not None:
                        event.synchronize()
                    with profiling.span("lfi.stream.feed"):
                        f = torch.from_numpy(np.asarray(f))
                        buf = buffers.get(slot)
                        if buf is None or buf.shape != f.shape:
                            buf = torch.empty(f.shape, dtype=torch.uint8, pin_memory=True)
                            buffers[slot] = buf
                        buf.copy_(f)  # on torch's intra-op threads, not one core
                    event = torch.cuda.Event()
                    with torch.cuda.stream(upload):
                        raw = buf.to(dev, non_blocking=True)
                        event.record(upload)
                    ready.put((slot, raw, event))
                    del raw
                ready.put(done)
            except BaseException as e:  # forwarded to the consumer
                ready.put(e)

        def take() -> torch.Tensor | None:
            with profiling.span("lfi.stream.take"):
                item = _take(ready, done)
                if item is None:
                    return None
                slot, raw, event = item
                free.put((slot, event))
                current = torch.cuda.current_stream(dev)
                current.wait_event(event)
                raw.record_stream(current)
                return blend_torch.to_planar(raw)

        thread = threading.Thread(target=feeder, daemon=True)
        thread.start()
        try:
            # no reference to a yielded frame stays here: the render loop
            # frees it once rendered
            yield from iter(take, None)
        finally:
            stop.set()
            free.put((0, None))  # wake a feeder waiting for a buffer
            thread.join()
            while not ready.empty():  # frames uploaded and never taken
                ready.get()
            upload.synchronize()  # the buffers serve the next stream

    def _frames_cpu(self, frames: Iterable[np.ndarray]) -> Iterator[torch.Tensor]:
        """Planar CPU frames, decoded `prefetch` frames ahead by a thread."""
        ready: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()

        def feeder():
            try:
                for f in frames:
                    with profiling.span("lfi.stream.feed"):
                        f = np.asarray(f)
                    ready.put(f)
                ready.put(done)
            except BaseException as e:  # forwarded to the consumer
                ready.put(e)

        def take() -> torch.Tensor | None:
            with profiling.span("lfi.stream.take"):
                f = _take(ready, done)
                return None if f is None else blend_torch.to_planar(torch.from_numpy(f))

        threading.Thread(target=feeder, daemon=True).start()
        yield from iter(take, None)

    def render_stream(self, frames: Iterable[np.ndarray]) -> Iterator:
        """Yield [V, H, W, 3] uint8 view stacks, one per input frame -- or
        ([V, H, W, 3] views, [2, H, W] maps) tuples when the config enables
        the per-pixel focus map (focus_range > 0). Errors raised by
        `frames` propagate; an empty stream yields nothing."""
        source = (self._frames_cuda if self.device.type == "cuda"
                  else self._frames_cpu)(frames)
        pending: list[transfer.Pending] = []
        for images in source:
            with profiling.span("lfi.stream.frame"):
                out = self._render(images)
                del images
                views, maps = out if self.cfg.uses_focus_map else (out, None)
                pending.append(self._download.start(views, maps))
                del out, views, maps
            if len(pending) > self.prefetch:
                yield _drain(pending.pop(0))
        while pending:
            yield _drain(pending.pop(0))

    def render_to_dir(
        self,
        frames: Iterable,
        output_dir: str,
        *,
        writers: int = 4,
        resume: bool = False,
    ) -> StreamStats:
        """Render a stream and write each frame's views under
        output_dir/frame_%05d/ with a background writer pool.

        `frames` yields uint8 arrays or zero-argument callables returning
        them. With `resume=True`, frames whose directory already holds every
        file ``write_views`` writes (checked by exact name, so stray PNGs do
        not count) are skipped, and their callables are never called. PNG
        writes are atomic (a ``.tmp`` file renamed into place)."""
        t0 = time.perf_counter()
        n = skipped = 0
        v_count = self.cfg.view_count
        digits = max(2, len(str(v_count - 1)))
        expected = [f"{i:0{digits}d}.png" for i in range(v_count)]
        if self.cfg.uses_focus_map:
            expected += ["map0.png", "map1.png"]

        def complete(i: int) -> bool:
            d = os.path.join(output_dir, f"frame_{i:05d}")
            return os.path.isdir(d) and all(
                os.path.exists(os.path.join(d, name)) for name in expected)

        # render_stream keeps the order, and the decode thread appends an
        # index before its frame can produce an output.
        pending_idx: list[int] = []

        def to_render():
            nonlocal skipped
            for i, f in enumerate(frames):
                if resume and complete(i):
                    skipped += 1
                    continue
                pending_idx.append(i)
                yield f() if callable(f) else f

        with concurrent.futures.ThreadPoolExecutor(max_workers=writers) as pool:
            futures = []
            for out in self.render_stream(to_render()):
                views, maps = out if self.cfg.uses_focus_map else (out, None)
                futures.append(pool.submit(
                    writer.write_views,
                    os.path.join(output_dir, f"frame_{pending_idx.pop(0):05d}"),
                    views, maps, progress=False,
                ))
                n += 1
            for f in futures:
                f.result()
        return StreamStats(frames=n + skipped, total_s=time.perf_counter() - t0,
                           skipped=skipped)
