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
select modes and FMA/divide barriers were TPU artefacts: a clamped index
replaces the pad.

``estimate_pyramid`` is the approximate coarse-to-fine estimate
(``--focus-pyramid``): a half-resolution sweep, then a full-resolution
search restricted, block by block, to the candidates near the coarse
result (``presence_from_coarse``, ``estimate_presence``). Its block grain
comes from ``estimate_geometry``.
"""

from __future__ import annotations

import torch

from ..state import FocusTables
from .estimate_geometry import Pyramid


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
    present: torch.Tensor | None = None,  # [S, H, W] bool
) -> torch.Tensor:
    """Disparity-search focus map -> [H, W] uint8 (the winning candidate's
    byte from ``tables.candidate_bytes``).

    `present` restricts each pixel's search to its present candidates: a
    candidate that is not present never updates the pixel's best
    (``focus.py:377-385``); a pixel with none keeps candidate 0."""
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
        if present is not None:
            better &= present[i]
        best_cost = torch.where(better, cost, best_cost)
        best_idx.masked_fill_(better, i)
    return tables.candidate_bytes.to(dev)[best_idx]


def presence_from_coarse(coarse: torch.Tensor, plan: Pyramid, steps: int) -> torch.Tensor:
    """[HC, WC] uint8 coarse map -> [NB, N_WC, CC] int32 presence words.

    Port of ``estimate_pallas._presence_from_coarse`` (``:1183-1229``).
    Block (b, j) covers full-resolution rows [b*tb, +tb) and columns
    [j*wco, +wco); its coarse witnesses are the edge-padded window of
    (tb/scale + 2) x (wco/scale + 2) coarse pixels at stride (tb/scale,
    wco/scale), whose min and max candidate index, widened by `refine` each
    way, become bits (one per candidate, ``sc`` to a word). The pooling runs
    on exact small integers in float32.
    """
    hc, wcc = coarse.shape
    tbc, wcoc = plan.tb // plan.scale, plan.wco // plan.scale
    dev = coarse.device
    # byte -> nearest candidate index (the inverse of the byte encode)
    si = (coarse.to(torch.int32) * (steps - 1) * 2 + 255) // 510
    rows = torch.arange(-1, plan.nb * tbc + 1, device=dev).clamp_(0, hc - 1)
    cols = torch.arange(-1, plan.n_wc * wcoc + 1, device=dev).clamp_(0, wcc - 1)
    sip = si[rows[:, None], cols[None, :]].to(torch.float32)[None, None]
    win, stride = (tbc + 2, wcoc + 2), (tbc, wcoc)
    mx = torch.nn.functional.max_pool2d(sip, win, stride)[0, 0].to(torch.int32)
    mn = -torch.nn.functional.max_pool2d(-sip, win, stride)[0, 0].to(torch.int32)
    smin = (mn - plan.refine).clamp_(0, steps - 1)
    smax = (mx + plan.refine).clamp_(0, steps - 1)
    sidx = torch.arange(steps, device=dev, dtype=torch.int32)
    inr = (sidx >= smin[..., None]) & (sidx <= smax[..., None])
    bits = inr.reshape(plan.nb, plan.n_wc, steps // plan.sc, plan.sc).to(torch.int32)
    shifts = torch.arange(plan.sc, device=dev, dtype=torch.int32)
    return (bits << shifts).sum(dim=-1, dtype=torch.int32)


def expand_presence(
    pres: torch.Tensor, plan: Pyramid, steps: int, h: int, w: int
) -> torch.Tensor:
    """[NB, N_WC, CC] int32 presence words -> [S, H, W] bool per-pixel mask."""
    i = torch.arange(steps, device=pres.device)
    bits = (pres[:, :, i // plan.sc] >> (i % plan.sc).to(torch.int32)) & 1
    mask = bits.permute(2, 0, 1).bool()  # [S, NB, N_WC]
    mask = mask.repeat_interleave(plan.tb, dim=1).repeat_interleave(plan.wco, dim=2)
    return mask[:, :h, :w]


def estimate_presence(
    selected: torch.Tensor,  # [K, C, H, W] uint8
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    tables: FocusTables,
    radius: tuple[int, int],
    pres: torch.Tensor,  # [NB, N_WC, CC] int32 presence words
    plan: Pyramid,
) -> torch.Tensor:
    """The exact-taps estimate over each block's present candidates only
    -> [H, W] uint8: the pyramid's refine pass."""
    steps = tables.candidates.shape[0]
    present = expand_presence(pres, plan, steps, *selected.shape[2:])
    return estimate_focus_map(selected, sel_offsets, tables, radius, True, present)


def estimate_pyramid(
    selected: torch.Tensor,  # [K, C, H, W] uint8
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    tables: FocusTables,
    radius: tuple[int, int],
    plan: Pyramid,
) -> torch.Tensor:
    """Coarse-to-fine exact-taps estimate -> [H, W] uint8.

    Port of ``estimate_pallas.estimate_fused_pyramid`` (``:1251-1313``): the
    full candidate sweep on every `scale`-th row and column (offsets divided
    by `scale`, radius ``plan.radius_c``), the presence words from its map,
    then the full-resolution search over each block's present candidates
    only. Approximate by design: a pixel whose best candidate lies outside
    its block's range gets the best present one.
    """
    s = plan.scale
    coarse = estimate_focus_map(selected[:, :, ::s, ::s], sel_offsets / s,
                                tables, plan.radius_c, True)
    pres = presence_from_coarse(coarse, plan, tables.candidates.shape[0])
    return estimate_presence(selected, sel_offsets, tables, radius, pres, plan)


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
