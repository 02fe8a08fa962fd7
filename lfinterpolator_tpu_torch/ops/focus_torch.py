"""Focus-map estimate and filter in plain PyTorch.

Port of ``lfinterpolator_tpu/ops/focus.py`` (``estimate_focus_map``,
``filter_focus_map``). These are also the plain versions of the
hand-written estimate kernel in ``ops/focus_estimate.py``.

The estimate is the reference's per-pixel disparity search
(``reference.focus_map_estimate``, ``reference.py:166-219``): for each
candidate focus f, in order, the cost of a pixel is the sum over a 3x3
stencil of taps (spacing = radius) of ``max_c(max_k - min_k)`` over the K
focus views, and the first strict minimum wins. A tap of view k reads
``img_k[clamp(ty), clamp(tx)]``; the two tap rules differ in where the
C truncation is evaluated:

  * exact (the default): ``ty = trunc(f32(y) + f*oy_k) + sy`` -- at the
    center pixel, as the oracle does (``focus.py:320-369``);
  * fast (``--fast-focus``): ``ty = trunc(f32(y + sy) + f*oy_k)`` -- at the
    tap (``focus.py:307-318`` via ``blend_xla.trunc_shifted_window``).

Likewise in x. ``f*o`` and the add are two separately rounded f32 ops
(eager torch rounds each op on its own), and the candidate values and their
map bytes come from the host tables (``state.focus_tables``), so no
division runs here. The JAX package's pads, row blocks, slabs, tap dtypes,
select modes, presence masks and FMA/divide barriers were TPU artefacts: a
clamped index replaces the pad.
"""

from __future__ import annotations

import torch

from ..state import FocusTables


def _taps(
    q: torch.Tensor,  # [N] float32 pixel coordinates 0..N-1
    shift: torch.Tensor,  # [K] float32, f * o_k
    s: int,  # stencil offset
    exact: bool,
) -> torch.Tensor:
    """[K, N] int64 clamped tap coordinates of one stencil offset."""
    n = q.shape[0]
    if exact:
        t = torch.trunc(q[None, :] + shift[:, None]) + s
    else:
        t = torch.trunc((q + s)[None, :] + shift[:, None])
    return t.clamp_(0, n - 1).to(torch.int64)


def estimate_focus_map(
    selected: torch.Tensor,  # [K, C, H, W] uint8, the focus views
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y) offsets of those views
    tables: FocusTables,  # candidates [S] f32, candidate_bytes [S] u8
    radius: tuple[int, int],  # (rx, ry)
    exact_taps: bool = True,
) -> torch.Tensor:
    """Disparity-search focus map -> [H, W] uint8 (the winning candidate's
    byte from ``tables.candidate_bytes``)."""
    k, c, h, w = selected.shape
    dev = selected.device
    rx, ry = int(radius[0]), int(radius[1])
    ys = torch.arange(h, device=dev, dtype=torch.float32)
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    ki = torch.arange(k, device=dev)[:, None, None, None]
    ci = torch.arange(c, device=dev)[None, :, None, None]
    candidates = tables.candidates.to(device=dev, dtype=torch.float32)
    offsets = sel_offsets.to(device=dev, dtype=torch.float32)
    best_cost = torch.full((h, w), torch.iinfo(torch.int32).max,
                           dtype=torch.int32, device=dev)
    best_idx = torch.zeros((h, w), dtype=torch.int64, device=dev)
    for i in range(candidates.shape[0]):
        f = candidates[i]
        fy, fx = f * offsets[:, 1], f * offsets[:, 0]  # [K], rounded f32
        cost = torch.zeros((h, w), dtype=torch.int32, device=dev)
        for sy in (-ry, 0, ry):
            rows = _taps(ys, fy, sy, exact_taps)[:, None, :, None]
            for sx in (-rx, 0, rx):
                cols = _taps(xs, fx, sx, exact_taps)[:, None, None, :]
                mn, mx = torch.aminmax(selected[ki, ci, rows, cols], dim=0)
                cost += (mx.to(torch.int32) - mn.to(torch.int32)).amax(dim=0)
        better = cost < best_cost  # strict: the first minimum wins
        best_cost = torch.where(better, cost, best_cost)
        best_idx.masked_fill_(better, i)
    return tables.candidate_bytes.to(dev)[best_idx]


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (C's round, ``geometry.round_half_away``)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def filter_focus_map(focus_map: torch.Tensor, radius: tuple[int, int]) -> torch.Tensor:
    """Box filter of the map via an integral image -> [H, W] uint8.

    Window x in [cx-rx, cx+rx), y in [cy-ry, cy+ry) with clamped taps
    (``reference.focus_map_filter``), the sum divided in f32 by 4*rx*ry and
    rounded half away from zero. A radius of 0 copies the map.
    """
    rx, ry = int(radius[0]), int(radius[1])
    if rx == 0 or ry == 0:
        return focus_map.clone()
    h, w = focus_map.shape
    dev = focus_map.device
    rows = torch.arange(-ry, h + ry, device=dev).clamp_(0, h - 1)
    cols = torch.arange(-rx, w + rx, device=dev).clamp_(0, w - 1)
    padded = focus_map[rows[:, None], cols[None, :]].to(torch.int64)
    ii = torch.nn.functional.pad(padded.cumsum(0).cumsum(1), (1, 0, 1, 0))
    # the window of pixel (y, x) is padded[y : y+2ry, x : x+2rx]
    s = (
        ii[2 * ry : 2 * ry + h, 2 * rx : 2 * rx + w]
        - ii[0:h, 2 * rx : 2 * rx + w]
        - ii[2 * ry : 2 * ry + h, 0:w]
        + ii[0:h, 0:w]
    )
    # A tensor divisor: CUDA torch turns division by a host scalar into a
    # multiply by its reciprocal, which is not correctly rounded.
    divisor = torch.tensor(4 * rx * ry, dtype=torch.float32, device=dev)
    return round_half_away(s.to(torch.float32) / divisor).to(torch.uint8)
