"""The benchmark's scenes: seeded parallax-occlusion light fields.

The generator of ``lfinterpolator_tpu_torch/utils/scenes.py``
(``make_occlusion_scene``), made on the device in a few large torch calls
so that a 64-image 1080p scene costs a fraction of a second of set-up: a
smoothed random texture per plane (a background and two nearer layers),
the nearer layers cut by seeded rectangles and ellipses, each layer shifted
per camera by its own disparity (``focus * width / cols`` px a grid cell in
x, ``focus * width / rows`` in y), composited back to front. Pixels by an
occluder's edge are seen by some cameras and hidden from others, which is
what the focus search meets in captured light fields.

The planes lie on the candidate grid of the cell's focus window (candidates
0, 13 and 26 of 32), so the search can lock each exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def plane_foci(focus: float, focus_range: float, steps: int) -> list[float]:
    step = focus_range / (steps - 1)
    return [focus + i * step for i in (0, 13, 26)]


class OcclusionScene:
    """One scene's textures and occluders; ``frame(shift)`` composites the
    cameras with every occluder moved by `shift` = (dy, dx) px."""

    def __init__(self, cols: int, rows: int, h: int, w: int, foci: list[float],
                 n_occluders: list[int], seed: int, device):
        self.cols, self.rows, self.h, self.w = cols, rows, h, w
        self.device = torch.device(device)
        self.dpx = [f * w / cols for f in foci]
        self.dpy = [f * w / rows for f in foci]
        maxp = max((cols - 1) / 2, (rows - 1) / 2)
        self.m = int(np.ceil(maxp * max(self.dpx + self.dpy))) + 8
        hc, wc = h + 2 * self.m, w + 2 * self.m
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng.integers(0, 2 ** 62)))
        t = torch.randint(0, 256, (len(foci), hc, wc, 3), generator=gen,
                          device=self.device, dtype=torch.int16).to(torch.float32)
        t = (t + t.roll(1, 1) + t.roll(1, 2) + t.roll(2, 1)) / 4
        self.textures = t.to(torch.uint8)
        self.shapes = []  # per layer: (cy, cx, ry, rx, is_rectangle)
        for li in range(1, len(foci)):
            layer = []
            for j in range(n_occluders[li - 1]):
                cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
                ry = int(rng.integers(h // 10, h // 6 + 1))
                rx = int(rng.integers(h // 10, h // 5 + 1))
                layer.append((cy, cx, ry, rx, (li + j) % 2 == 0))
            self.shapes.append(layer)

    def _masks(self, shift: tuple[float, float]) -> list[torch.Tensor]:
        m, dev = self.m, self.device
        hc, wc = self.textures.shape[1:3]
        yy = torch.arange(hc, device=dev, dtype=torch.float32)[:, None]
        xx = torch.arange(wc, device=dev, dtype=torch.float32)[None, :]
        masks = []
        for layer in self.shapes:
            mask = torch.zeros((hc, wc), dtype=torch.bool, device=dev)
            for cy, cx, ry, rx, rect in layer:
                cy += m + int(round(shift[0]))
                cx += m + int(round(shift[1]))
                if rect:
                    mask[max(0, cy - ry):cy + ry, max(0, cx - rx):cx + rx] = True
                else:
                    mask |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            masks.append(mask)
        return masks

    def frame(self, shift: tuple[float, float] = (0.0, 0.0)) -> torch.Tensor:
        """-> [cols * rows, H, W, 3] uint8 on the device, flat order
        ``col * rows + row``."""
        masks = self._masks(shift)
        h, w, m = self.h, self.w, self.m
        out = torch.empty((self.cols * self.rows, h, w, 3), dtype=torch.uint8,
                          device=self.device)
        for c in range(self.cols):
            for r in range(self.rows):
                px, py = c - (self.cols - 1) / 2, r - (self.rows - 1) / 2

                def window(arr, li):
                    dx = int(round(px * self.dpx[li])) + m
                    dy = int(round(py * self.dpy[li])) + m
                    return arr[dy:dy + h, dx:dx + w]

                img = window(self.textures[0], 0)
                for li in range(1, len(self.dpx)):
                    img = torch.where(window(masks[li - 1], li)[..., None],
                                      window(self.textures[li], li), img)
                out[c * self.rows + r] = img
        return out
