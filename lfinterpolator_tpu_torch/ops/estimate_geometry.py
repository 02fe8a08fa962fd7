"""Host arithmetic that fixes the output of the coarse-to-fine estimate.

Jax-free copies of the JAX package's host functions that decide what
``--focus-pyramid`` computes:

  * ``shift_pad_bound`` (``lfinterpolator_tpu/ops/focus.py:51-76``);
  * ``chunk_spans``, ``_wchunks``, ``_cfg_candidates``, ``_pick_cfg`` and
    ``_cfg_for`` for the exact tap rule, ``_coarse_params`` and
    ``supports_pyramid`` (``lfinterpolator_tpu/ops/estimate_pallas.py:72-220,
    1140-1174``).

``estimate_pallas`` imports jax at module level, so the port copies the
arithmetic instead of importing it; ``tests/test_torch_pyramid.py`` holds
each copy equal to its original over a sweep of geometries.

The ``(tb, wco, sc)`` grain these functions pick -- band height, lane-chunk
width and candidate chunk -- was VMEM tuning on the TPU, but the presence
table of the pyramid's refine pass is built per ``tb x wco`` block and per
``sc``-candidate chunk, so the grain decides which pixels skip which
candidates: it is part of the pyramid's *output*. The port reproduces it to
keep its maps bit-equal to the JAX package's. It has nothing to do with the
CUDA launch geometry of the estimate kernel (``csrc/focus_estimate.cu``,
32 x 8 pixel blocks), which only requires ``tb`` to be a multiple of 8 and
``wco`` of 32 -- always true here (``tb`` steps by 8, ``wco`` by 128).

``FocusTables`` and ``Pyramid`` are the two host plans that the estimate
and the per-pixel blend read; ``state.focus_tables`` fills the first.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import numpy as np

if TYPE_CHECKING:
    import torch


def align(x: int, m: int) -> int:
    return -(-x // m) * m


def shift_pad_bound(
    offsets, focus: float, focus_range: float, radius: tuple[int, int],
    h: int, w: int, bucket: int = 64,
) -> tuple[int, int]:
    """(px, py): a bound on |shift| + radius over the candidate range,
    rounded up to `bucket` and capped at the image size + radius."""
    offsets = np.asarray(offsets)
    cands = [float(focus), float(focus) + float(focus_range)]
    mx = max(abs(f) * float(np.abs(offsets[:, 0]).max()) for f in cands)
    my = max(abs(f) * float(np.abs(offsets[:, 1]).max()) for f in cands)
    px = min(int(np.ceil(mx)), w + int(radius[0]) + 2) + int(radius[0]) + 2
    py = min(int(np.ceil(my)), h + int(radius[1]) + 2) + int(radius[1]) + 2
    return align(px, bucket), align(py, bucket)


def chunk_spans(
    offsets, focus: float, focus_range: float, steps: int, sc: int,
) -> tuple[int, int]:
    """(row, col) bounds on the shift span within one `sc`-candidate chunk,
    rounded up to 8."""
    off = np.asarray(offsets)
    step = abs(float(focus_range)) / max(steps - 1, 1)
    span = step * max(sc - 1, 1)
    sy = int(np.ceil(span * float(np.abs(off[:, 1]).max()))) + 4
    sx = int(np.ceil(span * float(np.abs(off[:, 0]).max()))) + 4
    return align(sy, 8), align(sx, 8)


def _wchunks(w128: int) -> list[int]:
    """Lane-chunk widths, widest first: 128-multiple divisors >= 256."""
    seen = []
    for n in (1, 2, 3, 4, 5, 6, 8, 10, 12, 15):
        if w128 % n == 0 and w128 // n % 128 == 0 and w128 // n >= 256:
            if w128 // n not in seen:
                seen.append(w128 // n)
    return seen or [w128]


def _cfg_candidates(
    h8: int, w128: int, steps: int, ry: int, rx: int,
    span_y: int, span_x: int, tb_max: int,
):
    """(tb, tbw, wl, cc, sc, wco) in the exact kernel's preference order
    (``_cfg_candidates(..., tile_tb_first=True)``)."""
    tbs = sorted(range(tb_max, 7, -8), key=lambda t: (t % 32 != 0, -t))
    pairs = [(tb, wco) for tb in tbs for wco in _wchunks(w128)]
    for amp_cap in (4, 10**9):
        for sc in (4, 2, 1):
            if steps % sc:
                continue
            cc = steps // sc
            for tb, wco in pairs:
                wl = align(wco + span_x + 2 * rx + 140, 128)
                if wl > 8 * 3968:
                    continue
                waste = -(-h8 // tb) * tb - h8
                if waste * 8 > h8:
                    continue
                tbw = align(tb + span_y + 2 * ry + 16, 32)
                cap = amp_cap * tb
                if tb % 32 == 0:
                    cap += amp_cap * tb // 4
                if tbw > cap:
                    continue
                yield tb, tbw, wl, cc, sc, wco


def _pick_cfg(
    h8: int, w128: int, k: int, steps: int, ry: int, rx: int,
    span_y: int, span_x: int, budget: int = 13 * 1024 * 1024,
):
    for tb, tbw, wl, cc, sc, wco in _cfg_candidates(
        h8, w128, steps, ry, rx, span_y, span_x, 40
    ):
        need = k * tbw * wl + (18 + 9 * sc + 8) * tb * wl + 10 * tb * wl
        if need <= budget:
            return tb, tbw, wl, cc, sc, wco
    return None


def cfg_for(
    h_out: int, w: int, k: int, steps: int, radius: tuple[int, int],
    span_y: int, span_x: int,
):
    """The exact-taps (tb, tbw, wl, cc, sc, wco) for this geometry, or None
    where the JAX package has no fused exact estimate for it."""
    h8 = align(h_out, 8)
    if w < 256 or h8 < 8 or k < 1 or steps < 2:
        return None
    return _pick_cfg(
        h8, align(w, 128), k, steps, int(radius[1]), int(radius[0]),
        span_y, span_x,
    )


def coarse_params(
    radius: tuple[int, int], px: int, py: int, span_y: int, span_x: int,
    scale: int,
):
    """(radius_c, px_c, py_c, span_y_c, span_x_c) of the 1/scale pass."""
    rx_c = max(1, int(radius[0]) // scale)
    ry_c = max(1, int(radius[1]) // scale)
    px_c = align(max(-(-int(px) // scale), rx_c + 2), 64)
    py_c = align(max(-(-int(py) // scale), ry_c + 2), 64)
    sy_c = align(-(-int(span_y) // scale), 8)
    sx_c = align(-(-int(span_x) // scale), 8)
    return (rx_c, ry_c), px_c, py_c, sy_c, sx_c


def supports_pyramid(
    h: int, w: int, k: int, steps: int, radius: tuple[int, int],
    span_y: int, span_x: int, px: int, py: int, scale: int = 2,
) -> bool:
    """Whether the JAX package runs the pyramid for this geometry: both the
    full-resolution refine and the 1/scale coarse pass have a config (the
    coarse frame must still be >= 256 px wide)."""
    if scale < 2 or steps < 2:
        return False
    if cfg_for(h, w, k, steps, radius, span_y, span_x) is None:
        return False
    radius_c, _, _, sy_c, sx_c = coarse_params(
        radius, px, py, span_y, span_x, scale
    )
    return cfg_for(-(-h // scale), -(-w // scale), k, steps, radius_c,
                   sy_c, sx_c) is not None


class FocusTables(NamedTuple):
    """The host tables of the focus search and the per-pixel decode."""

    candidates: np.ndarray | torch.Tensor  # [S] float32 candidate focus values
    candidate_bytes: np.ndarray | torch.Tensor  # [S] uint8 map byte of each
    decode: np.ndarray | torch.Tensor  # [256] float32 focus value of each byte


class Pyramid(NamedTuple):
    """Everything the coarse-to-fine estimate needs beyond the estimate's
    own arguments: the coarse pass's radius and the presence grain."""

    scale: int  # the coarse pass runs on every scale-th row and column
    refine: int  # candidates each side of a block's coarse range
    radius_c: tuple[int, int]  # (rx, ry) of the coarse pass
    tb: int  # presence block height (rows)
    wco: int  # presence block width (columns)
    sc: int  # candidates per presence word
    nb: int  # presence blocks down the frame
    n_wc: int  # presence blocks across the frame


def pyramid_plan(
    h: int, w: int, k: int, steps: int, radius: tuple[int, int],
    spans: tuple[int, int], pad: tuple[int, int], scale: int = 2,
    refine: int = 1,
) -> Pyramid | None:
    """The pyramid for this geometry, or None where the JAX package runs the
    exact sweep instead (``focus.py:192-201``). `pad` is the effective
    (px, py), ``max(shift_pad_bound, radius + 1)``."""
    span_y, span_x = int(spans[0]), int(spans[1])
    if not supports_pyramid(h, w, k, steps, radius, span_y, span_x,
                            int(pad[0]), int(pad[1]), scale):
        return None
    tb, _, _, _, sc, wco = cfg_for(h, w, k, steps, radius, span_y, span_x)
    radius_c = coarse_params(radius, pad[0], pad[1], span_y, span_x, scale)[0]
    return Pyramid(
        scale=scale, refine=refine, radius_c=radius_c, tb=tb, wco=wco, sc=sc,
        nb=-(-align(h, 8) // tb), n_wc=align(w, 128) // wco,
    )
