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
division runs here. The JAX package's pads, slabs, tap dtypes, select
modes and FMA/divide barriers were TPU artefacts: a clamped index replaces
the pad.

Row blocks: the estimates and ``cheby_map`` take ``row_start`` and
``row_count`` (one rank's rows of a multi-GPU render, ``parallel/mesh.py``)
and compute only those rows of the map, with the frame's coordinates and
clamps, so a block equals the same rows of the whole-frame map. The exact
rule's clean flags are the frame's, sliced to the block: flags computed for
the block alone would describe rows 0..hb, not the block's rows.
``filter_focus_map_block`` filters a block of rows of the full map.

``estimate_pyramid`` is the approximate coarse-to-fine estimate
(``--focus-pyramid``): a half-resolution sweep, then a full-resolution
search restricted, block by block, to the candidates near the coarse
result (``presence_from_coarse``, ``estimate_presence``). Its block grain
comes from ``estimate_geometry``.
"""

from __future__ import annotations

import torch

from .blend_torch import row_block
from .estimate_geometry import FocusTables, Pyramid


def _taps(
    q: torch.Tensor,  # [N] float32 pixel coordinates
    shift: torch.Tensor,  # [K] float32, f * o_k
    s: int,  # stencil offset
    exact: bool,
    n: int,  # the frame's size along this axis: taps clamp to [0, n)
) -> torch.Tensor:
    """[K, N] int64 clamped tap coordinates of one stencil offset."""
    if exact:
        t = torch.trunc(q[None, :] + shift[:, None]) + s
    else:
        t = torch.trunc((q + s)[None, :] + shift[:, None])
    return t.clamp_(0, n - 1).to(torch.int64)


def candidate_cost(
    selected: torch.Tensor,  # [K, C, H, W] uint8
    offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    f: torch.Tensor,  # 0-d float32, the candidate
    radius: tuple[int, int],  # (rx, ry)
    exact_taps: bool,
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """[hb, W] int32 cost of one candidate on a block of rows: the sum over
    the 3x3 stencil of ``max_c(max_k - min_k)`` at the taps of the chosen
    rule."""
    k, c, h, w = selected.shape
    r0, hb = row_block(h, row_start, row_count)
    dev = selected.device
    rx, ry = int(radius[0]), int(radius[1])
    ys = torch.arange(r0, r0 + hb, device=dev, dtype=torch.float32)
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    ki = torch.arange(k, device=dev)[:, None, None, None]
    ci = torch.arange(c, device=dev)[None, :, None, None]
    fy, fx = f * offsets[:, 1], f * offsets[:, 0]  # [K], rounded f32
    cost = torch.zeros((hb, w), dtype=torch.int32, device=dev)
    for sy in (-ry, 0, ry):
        rows = _taps(ys, fy, sy, exact_taps, h)[:, None, :, None]
        for sx in (-rx, 0, rx):
            cols = _taps(xs, fx, sx, exact_taps, w)[:, None, None, :]
            mn, mx = torch.aminmax(selected[ki, ci, rows, cols], dim=0)
            cost += (mx.to(torch.int32) - mn.to(torch.int32)).amax(dim=0)
    return cost


def _argmin_bytes(costs, tables: FocusTables, shape, dev, present=None) -> torch.Tensor:
    """The strict first minimum over `costs` (an iterable of [H, W] int32,
    one per candidate, in order) -> [H, W] uint8 map bytes. A candidate that
    is not `present` ([S, H, W] bool) never updates a pixel's best."""
    best_cost = torch.full(shape, torch.iinfo(torch.int32).max,
                           dtype=torch.int32, device=dev)
    best_idx = torch.zeros(shape, dtype=torch.int64, device=dev)
    for i, cost in enumerate(costs):
        better = cost < best_cost  # strict: the first minimum wins
        if present is not None:
            better &= present[i]
        best_cost = torch.where(better, cost, best_cost)
        best_idx.masked_fill_(better, i)
    return tables.candidate_bytes.to(dev)[best_idx]


def estimate_focus_map(
    selected: torch.Tensor,  # [K, C, H, W] uint8, the focus views
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y) offsets of those views
    tables: FocusTables,  # candidates [S] f32, candidate_bytes [S] u8
    radius: tuple[int, int],  # (rx, ry)
    exact_taps: bool = True,
    present: torch.Tensor | None = None,  # [S, hb, W] bool
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """Disparity-search focus map of a block of rows (module docstring;
    the defaults: the frame) -> [hb, W] uint8, the winning candidate's byte
    from ``tables.candidate_bytes``.

    `present` restricts each pixel's search to its present candidates: a
    candidate that is not present never updates the pixel's best
    (``focus.py:377-385``); a pixel with none keeps candidate 0."""
    dev = selected.device
    r0, hb = row_block(selected.shape[2], row_start, row_count)
    candidates = tables.candidates.to(device=dev, dtype=torch.float32)
    offsets = sel_offsets.to(device=dev, dtype=torch.float32)
    costs = (candidate_cost(selected, offsets, f, radius, exact_taps, r0, hb)
             for f in candidates)
    return _argmin_bytes(costs, tables, (hb, selected.shape[3]), dev, present)


# The hoisted formulation, which the estimate kernel runs: one min/max pass
# over the views per candidate instead of one per stencil tap.
#
# The fast rule evaluates the truncation at the tap, so a tap's row depends
# on y + sy only and its column on x + sx only:
#   cost_f(y, x) = sum over (sy, sx) of D_f(y + sy, x + sx)
#   D_f(q) = max_c(max_k - min_k) img_k[c, clamp(trunc(q_y + f*oy_k)),
#                                         clamp(trunc(q_x + f*ox_k))]
# on q in [-ry, H + ry) x [-rx, W + rx). The exact rule truncates at the
# center: trunc(y + f*oy_k) + sy against the hoisted trunc((y + sy) + f*oy_k).
# The two differ (by 1) only where the coordinate changes sign between
# center and tap, or where an f32 rounding flips the truncation: a property
# of (candidate, view, row, sy), and of (candidate, view, column, sx). A
# row or column where no view and no stencil offset differs is "clean"; a
# pixel whose row and column are both clean for a candidate takes its cost
# from D_f, every other (candidate, pixel) pair from the nine-tap sum.

#: clean_flags holds at most this many f32 elements in one temporary.
_FLAG_ELEMENTS = 1 << 21


def cheby_map(
    selected: torch.Tensor,  # [K, C, H, W] uint8
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    f: torch.Tensor,  # 0-d float32, the candidate
    radius: tuple[int, int],  # (rx, ry)
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """D_f on the extended domain of a block of rows -> [hb + 2*ry,
    W + 2*rx] uint8; element [qy - r0 + ry, qx + rx] is the Chebyshev spread
    at pixel (qy, qx) of the frame."""
    k, c, h, w = selected.shape
    r0, hb = row_block(h, row_start, row_count)
    dev = selected.device
    rx, ry = int(radius[0]), int(radius[1])
    f = torch.as_tensor(f, dtype=torch.float32, device=dev)
    offsets = sel_offsets.to(device=dev, dtype=torch.float32)

    def coords(lo: int, n: int, r: int, size: int, shift: torch.Tensor) -> torch.Tensor:
        q = torch.arange(lo - r, lo + n + r, device=dev, dtype=torch.float32)
        t = torch.trunc(q[None, :] + shift[:, None])
        return t.clamp_(0, size - 1).to(torch.int64)

    rows = coords(r0, hb, ry, h, f * offsets[:, 1])[:, None, :, None]
    cols = coords(0, w, rx, w, f * offsets[:, 0])[:, None, None, :]
    ki = torch.arange(k, device=dev)[:, None, None, None]
    ci = torch.arange(c, device=dev)[None, :, None, None]
    mn, mx = torch.aminmax(selected[ki, ci, rows, cols], dim=0)
    return (mx.to(torch.int32) - mn.to(torch.int32)).amax(dim=0).to(torch.uint8)


def hoisted_cost(d: torch.Tensor, h: int, w: int, radius: tuple[int, int]) -> torch.Tensor:
    """[H, W] int32: the nine slices of one candidate's `cheby_map`, summed."""
    rx, ry = int(radius[0]), int(radius[1])
    d = d.to(torch.int32)
    cost = torch.zeros((h, w), dtype=torch.int32, device=d.device)
    for y0 in (0, ry, 2 * ry):
        for x0 in (0, rx, 2 * rx):
            cost += d[y0:y0 + h, x0:x0 + w]
    return cost


def _clean(n: int, r: int, shift: torch.Tensor) -> torch.Tensor:
    """[S, n] bool: position q is clean for candidate i when
    trunc(f32(q) + shift[i, k]) + s == trunc(f32(q + s) + shift[i, k]) for
    every view k and s in (-r, r) (s = 0 holds trivially)."""
    steps, k = shift.shape
    dev = shift.device
    clean = torch.ones((steps, n), dtype=torch.bool, device=dev)
    if r == 0:
        return clean
    q = torch.arange(n, device=dev, dtype=torch.float32)
    chunk = max(1, _FLAG_ELEMENTS // max(1, k * n))
    for i in range(0, steps, chunk):
        sh = shift[i:i + chunk, :, None]  # [chunk, K, 1]
        center = torch.trunc(q + sh)
        for s in (-r, r):
            tap = torch.trunc((q + s) + sh)
            clean[i:i + chunk] &= (center + s == tap).all(dim=1)
    return clean


def clean_flags(
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    tables: FocusTables,
    radius: tuple[int, int],  # (rx, ry)
    h: int,
    w: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (row_clean [S, H], col_clean [S, W]) bool: where the exact tap
    rule reads what the hoisted one reads, for every view and stencil
    offset. Eager ops, each rounded on its own, as the coordinates are."""
    dev = sel_offsets.device
    candidates = tables.candidates.to(device=dev, dtype=torch.float32)
    offsets = sel_offsets.to(dtype=torch.float32)
    shift_y = candidates[:, None] * offsets[None, :, 1]  # [S, K], rounded f32
    shift_x = candidates[:, None] * offsets[None, :, 0]
    return (_clean(h, int(radius[1]), shift_y), _clean(w, int(radius[0]), shift_x))


def slow_share(row_clean: torch.Tensor, col_clean: torch.Tensor) -> float:
    """The share of (candidate, pixel) pairs whose row or column is dirty:
    those take the nine-tap sum under the exact rule."""
    clean = row_clean.float().mean(dim=1) * col_clean.float().mean(dim=1)  # [S]
    return 1.0 - float(clean.mean())


def estimate_hoisted(
    selected: torch.Tensor,  # [K, C, H, W] uint8
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    tables: FocusTables,
    radius: tuple[int, int],
    exact_taps: bool = True,
    row_start: int = 0,
    row_count: int | None = None,
    flags: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """``estimate_focus_map`` by the hoisted formulation -> [hb, W] uint8,
    bit-equal to it for both tap rules and any block of rows: the plain
    statement of what the estimate kernels compute.

    The exact rule takes the frame's ``clean_flags`` sliced to the block,
    or the caller's `flags` (row_clean [S, hb], col_clean [S, W]) in their
    place: for tests, which show what wrong flags do."""
    h, w = selected.shape[2:]
    r0, hb = row_block(h, row_start, row_count)
    dev = selected.device
    candidates = tables.candidates.to(device=dev, dtype=torch.float32)
    offsets = sel_offsets.to(device=dev, dtype=torch.float32)
    if exact_taps:
        if flags is None:
            row_clean, col_clean = clean_flags(offsets, tables, radius, h, w)
            row_clean = row_clean[:, r0:r0 + hb]
        else:
            row_clean, col_clean = flags

    def costs():
        for i, f in enumerate(candidates):
            d = cheby_map(selected, offsets, f, radius, r0, hb)
            cost = hoisted_cost(d, hb, w, radius)
            if exact_taps:
                clean = row_clean[i][:, None] & col_clean[i][None, :]
                if not bool(clean.all()):
                    cost = torch.where(clean, cost, candidate_cost(
                        selected, offsets, f, radius, True, r0, hb))
            yield cost

    return _argmin_bytes(costs(), tables, (hb, w), dev)


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
    return filter_focus_map_block(focus_map, radius, 0, focus_map.shape[0])


def filter_focus_map_block(
    focus_map: torch.Tensor,  # [H, W] uint8, the FULL map
    radius: tuple[int, int],
    row_start: int,
    row_count: int,
) -> torch.Tensor:
    """Rows [row_start, row_start + row_count) of ``filter_focus_map`` of
    the full map -> [row_count, W] uint8, bit-equal to the whole-frame
    filter followed by a slice (``focus.filter_focus_map_block``,
    ``focus.py:424-450``). The window crosses the block's edges by ry rows,
    so a rank of a multi-GPU render gathers the full map first; only the
    block's window of it, rows [r0 - ry, r0 + hb + ry) clamped, is summed."""
    rx, ry = int(radius[0]), int(radius[1])
    h, w = focus_map.shape
    r0, hb = row_block(h, row_start, row_count)
    if rx == 0 or ry == 0:
        return focus_map[r0:r0 + hb].clone()
    dev = focus_map.device
    rows = torch.arange(r0 - ry, r0 + hb + ry, device=dev).clamp_(0, h - 1)
    cols = torch.arange(-rx, w + rx, device=dev).clamp_(0, w - 1)
    padded = focus_map[rows[:, None], cols[None, :]].to(torch.int64)
    ii = torch.nn.functional.pad(padded.cumsum(0).cumsum(1), (1, 0, 1, 0))
    # the window of block row y (frame row r0 + y) is padded[y : y+2ry, x : x+2rx]
    s = (
        ii[2 * ry : 2 * ry + hb, 2 * rx : 2 * rx + w]
        - ii[0:hb, 2 * rx : 2 * rx + w]
        - ii[2 * ry : 2 * ry + hb, 0:w]
        + ii[0:hb, 0:w]
    )
    # A tensor divisor: CUDA torch turns division by a host scalar into a
    # multiply by its reciprocal, which is not correctly rounded.
    divisor = torch.tensor(4 * rx * ry, dtype=torch.float32, device=dev)
    return round_half_away(s.to(torch.float32) / divisor).to(torch.uint8)
