"""Device -> host download of rendered views into pinned memory.

The CUDA form of the JAX package's overlapped fetches (``api.py:98-121``,
``streaming.py:282-286``). ``Downloader.start`` enqueues, on the caller's
current stream, the ``[N, C, H, W] -> [N, H, W, C]`` copy of the views,
then on the downloader's own stream, after an event, the copy of those
bytes (and of the maps, if given) into pinned host memory. A render
enqueued after ``start`` runs while the download moves; ``Pending.wait``
waits for the copy's event and returns the host arrays.

A frame rendered in one pass on one device is downloaded in row bands
(``Downloader.start_bands``) where ``band_count`` gives it more than one:
the maps go as one copy after the estimate, then each band of rows is
blended, copied to HWC on the caller's stream and, after an event, copied
on the side stream into its rows of the one pinned ``[V, H, W, C]`` array
(one 2-D copy for all V views, ``lfi_copy_rows_to_host``) while the next
band blends. The copy of the frame then starts after its first band, not
after its whole blend. A frame whose blend and HWC copy are short against
the fixed cost of a band (``band_count`` is 1: HCI's 512² frames) is
downloaded whole, by ``start``, as are view batches, the stream's frames,
a mesh's gathered views and everything on the CPU.

The host memory comes from PyTorch's caching host allocator (``host_empty``)
and is handed to the caller as it is: the arrays own it, and it returns to
the allocator's cache, for the next download, when the caller drops them.
The alternative, one pinned buffer kept by the Interpolator and copied out
of into a fresh array per call, was measured against it (``chip_smoke.py``
phase 19, PERF.md): the copy out, into memory the host has not touched
yet, costs what pageable ``.cpu()`` costs, some 20 times the pinned copy
of a 64-view 1080p frame on an H100. A fresh 398 MB pinned block, when the
cache holds no free one (every earlier result still alive), costs about
as much as the pageable copy.

Each download counts its bands as ``download bands``
(``profiling.launch_counts``): 1 for a whole-frame download. On a CPU
tensor ``start`` converts at once and ``wait`` returns the arrays.
"""

from __future__ import annotations

import math

import torch

from ..ops import _build, blend_torch
from . import profiling

#: The band count's cost model (``band_count``), measured on an H100
#: (PERF.md): the blend's seconds per staged image, view and pixel (fixed
#: focus, all in focus); the HWC copy's and the device-to-host copy's bytes
#: a second; a band's fixed cost, the host's (its launches, event and 2-D
#: copy, which a frame that the host paces pays in full) and the blend's
#: partial last wave (half a block's time, which grows with the passes);
#: the most bands a frame takes.
BLEND_S_FIXED = 6.1e-14
BLEND_S_ALLFOCUS = 1.55e-13
HWC_BYTES_PER_S = 480e9
COPY_BYTES_PER_S = 55e9
BAND_S = 0.2e-3
BAND_PASS_S = 0.01e-3
MAX_BANDS = 8
#: The largest pitch a 2-D copy takes (``cudaDevAttrMaxPitch``).
MAX_PITCH = 2**31 - 1


def band_count(g: int, passes: int, v: int, c: int, h: int, w: int, *,
               allfocus: bool) -> int:
    """The row bands to render and download a frame of `v` views [c, h, w]
    from `g` images in: 1 downloads it whole.

    The device time that bands can hide is the blend's and the HWC copy's,
    which grow with the staged images (`g` padded to 16) times v * h * w,
    against the copy of v * h * w * c bytes to the host. With n bands the
    frame takes about max(hide, copy) + min(hide, copy) / n + (n - 1) *
    band: the first band's blend and the last band's copy do not overlap,
    and every band but one adds a fixed cost -- its launches, its event
    and its 2-D copy, and the blend's partial last wave, a block's time,
    which grows with the `passes` over the images. n is the whole number
    that makes that least, at most ``MAX_BANDS`` and at most `h`; a frame
    whose hideable time is short against a band's cost gets 1."""
    if h < 2 or h * w * c > MAX_PITCH:
        return 1
    staged = (g + 15) // 16 * 16
    frame = v * h * w * c
    hide = (BLEND_S_ALLFOCUS if allfocus else BLEND_S_FIXED) * staged * v * h * w \
        + frame / HWC_BYTES_PER_S
    overlap = min(hide, frame / COPY_BYTES_PER_S)
    band = BAND_S + passes * BAND_PASS_S
    best = max(1, math.isqrt(int(overlap / band)))
    # the least of overlap / n + (n - 1) * band lies at sqrt(overlap / band)
    n = min((best, best + 1), key=lambda k: overlap / k + (k - 1) * band)
    return max(1, min(n, MAX_BANDS, h))


def row_bands(h: int, n: int) -> list[tuple[int, int]]:
    """[(r0, hb)] of `n` bands (at most `h`) that cover rows [0, h) once,
    in order, as evenly as `h` allows: the first h % n one row taller."""
    n = max(1, min(n, h))
    q, r = divmod(h, n)
    bands, r0 = [], 0
    for i in range(n):
        hb = q + (i < r)
        bands.append((r0, hb))
        r0 += hb
    return bands


def frame_bands(device, g: int, c: int, h: int, w: int, v: int, *,
                allfocus: bool) -> list[tuple[int, int]]:
    """The row bands of a frame rendered in one pass on `device`: those of
    ``band_count`` on CUDA (its passes from the kernel library), else the
    whole frame as one band."""
    if torch.device(device).type != "cuda":
        return row_bands(h, 1)
    passes = _build.load().lfi_blend_grid_passes(g)
    return row_bands(h, band_count(g, passes, v, c, h, w, allfocus=allfocus))


def host_empty(shape, device) -> torch.Tensor:
    """An uninitialised uint8 host tensor for downloads from `device`:
    pinned (from PyTorch's caching host allocator) when it is a CUDA
    device."""
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")


class Pending:
    """A download in flight; ``wait`` returns its host arrays."""

    def __init__(self, held, host, event):
        self._held = held  # device tensors the copy reads, kept until it ends
        self._host = host  # [views] or [views, maps] host tensors
        self._event = event

    def wait(self):
        """-> views [N, H, W, C] uint8, or (views, maps) when the download
        carries maps."""
        with profiling.span("lfi.download.wait"):
            if self._event is not None:
                self._event.synchronize()
            self._held = None
            views, *maps = (t.numpy() for t in self._host)
            return (views, maps[0]) if maps else views


class Downloader:
    """Downloads on a side stream of `device` (module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = None

    def _side(self) -> torch.cuda.Stream:
        """The side stream, made to wait for the work enqueued so far on the
        caller's current stream."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return self._stream

    def start(self, views: torch.Tensor, maps: torch.Tensor | None = None,
              out: torch.Tensor | None = None) -> Pending:
        """Enqueue the download of `views` [N, C, H, W] uint8 (and `maps`),
        into `out` ([N, H, W, C] from ``host_empty``) or a new host tensor."""
        with profiling.span("lfi.download.start"):
            profiling.count("download bands")
            hwc = blend_torch.from_planar(views)
            tensors = [hwc] if maps is None else [hwc, maps.clone()]
            if self.device.type != "cuda":
                if out is not None:
                    tensors[0] = out.copy_(hwc)
                return Pending(None, tensors, None)
            host = [out if out is not None else host_empty(hwc.shape, self.device)]
            host += [host_empty(t.shape, self.device) for t in tensors[1:]]
            with torch.cuda.stream(self._side()):
                for h, t in zip(host, tensors):
                    h.copy_(t, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            return Pending(tensors, host, event)

    def start_bands(self, render, bands: list[tuple[int, int]],
                    maps: torch.Tensor | None = None,
                    out: torch.Tensor | None = None) -> Pending:
        """Render and download a frame in row `bands` ([(r0, hb)] covering
        its rows in order, ``row_bands``): ``render(r0, hb)`` -> the views of
        rows [r0, r0 + hb), [V, C, hb, W] uint8, each called after the last
        band's download is enqueued. `maps` (rendered already) go first, as
        one copy. The views land in `out` ([V, H, W, C] from ``host_empty``)
        or a new host tensor."""
        cuda = self.device.type == "cuda"
        h = sum(hb for _, hb in bands)
        held, host_maps = [], None
        if maps is not None:
            with profiling.span("lfi.download.start"):
                host_maps = host_empty(maps.shape, self.device)
                if cuda:
                    held.append(maps)
                    with torch.cuda.stream(self._side()):
                        host_maps.copy_(maps, non_blocking=True)
                else:
                    host_maps.copy_(maps)
        for r0, hb in bands:
            band = render(r0, hb)
            with profiling.span("lfi.download.start"):
                profiling.count("download bands")
                hwc = blend_torch.from_planar(band)
                del band  # its memory serves the next band, in stream order
                v, _, w, c = hwc.shape
                if out is None:
                    out = host_empty((v, h, w, c), self.device)
                elif (out.shape != (v, h, w, c) or out.dtype != torch.uint8
                      or not out.is_contiguous()):
                    raise ValueError(f"out must be a contiguous [{v}, {h}, {w}, {c}] "
                                     f"uint8 tensor, got {tuple(out.shape)} {out.dtype}")
                if not cuda:
                    out[:, r0:r0 + hb].copy_(hwc)
                    continue
                held.append(hwc)
                with torch.cuda.stream(self._side()):
                    _build.launch("lfi_copy_rows_to_host", self.device,
                                  out.data_ptr() + r0 * w * c, h * w * c,
                                  hwc.data_ptr(), hb * w * c, hb * w * c, v)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(self._stream)
        return Pending(held, [out] if maps is None else [out, host_maps], event)
