"""Device -> host download of rendered views into pinned memory.

The CUDA form of the JAX package's overlapped fetches (``api.py:98-121``,
``streaming.py:282-286``). ``Downloader.start`` enqueues, on the caller's
current stream, the ``[N, C, H, W] -> [N, H, W, C]`` copy of the views,
then on the downloader's own stream, after an event, the copy of those
bytes (and of the maps, if given) into pinned host memory. A render
enqueued after ``start`` runs while the download moves; ``Pending.wait``
waits for the copy's event and returns the host arrays.

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

On a CPU tensor ``start`` converts at once and ``wait`` returns the arrays.
"""

from __future__ import annotations

import torch

from ..ops import blend_torch
from . import profiling


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

    def start(self, views: torch.Tensor, maps: torch.Tensor | None = None,
              out: torch.Tensor | None = None) -> Pending:
        """Enqueue the download of `views` [N, C, H, W] uint8 (and `maps`),
        into `out` ([N, H, W, C] from ``host_empty``) or a new host tensor."""
        with profiling.span("lfi.download.start"):
            hwc = blend_torch.from_planar(views)
            tensors = [hwc] if maps is None else [hwc, maps.clone()]
            if self.device.type != "cuda":
                if out is not None:
                    tensors[0] = out.copy_(hwc)
                return Pending(None, tensors, None)
            host = [out if out is not None else host_empty(hwc.shape, self.device)]
            host += [host_empty(t.shape, self.device) for t in tensors[1:]]
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                for h, t in zip(host, tensors):
                    h.copy_(t, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            return Pending(tensors, host, event)
