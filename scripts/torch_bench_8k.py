#!/usr/bin/env python
"""A 64-view 8K all-focus render on one card, end to end, under the card's
real memory budget: the PyTorch port's counterpart of ``scripts/bench_8k.py``.

An 8x8 grid of 4320x7680 images (a seeded three-band scene, the same bytes
as the original's), 64 views, K = 32 focus views, 32 candidates, focus 0.0,
range 0.04, trajectory 0,0,1,1, through ``Interpolator.interpolate``. No
``LFI_HBM_BYTES``: ``core/capacity.plan_render`` sizes the render against
the card's free memory, and the script prints the arm it picks (one pass or
view batches) and its bytes beside ``torch.cuda.max_memory_allocated()``.

Per method it times a first whole call, an instrumented call (the estimate,
with its box filter, and the blend by CUDA events around
``pipeline.compute_focus_maps`` and ``pipeline.blend_all_focus``, the download by the host clock around the
Interpolator's download) and a steady whole call, after the upload (the
Interpolator's construction: the planar copy on the host and the copy to
the card). Then it checks a band of 16 rows from row 2160 against the
oracle's expressions (``ops/reference.py``), evaluated on the band's pixels
only, at their absolute coordinates, reading the full images:

  map0   bit-equal to ``focus_map_estimate`` at those rows;
  map1   bit-equal to ``focus_map_filter`` of the card's map0 at those rows;
  views  all 64, the near-tie rule (``blend_torch.check_bytes``) against the
         exact float64 sums of ``blend_allfocus``'s per-pixel selection, for
         both methods (both blend on the tensor-core kernel on the card).

The band keeps absolute rows because ``trunc(f32(y) + f32(f*o))`` rounds
differently at y = 2160 than at y = 0; a crop re-based to row 0 would be
another function. The whole-frame oracle at 8K would take hours.

Ends with one ``RESULT {json}`` line. ``--device cpu`` runs the plain path
(at 8K that takes hours: it is there for ``--size``).

Usage: torch_bench_8k.py [--method TEN|STD|both] [--no-verify]
                         [--size HxW] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import resource
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

H, W = 4320, 7680
COLS = ROWS = 8
VIEWS, FOCUS_VIEWS, STEPS = 64, 32, 32
FOCUS, FRANGE = 0.0, 0.04
TRAJ = "0,0,1,1"
SEED = 8
BAND_ROWS = 16
PHASES = ("estimate", "blend", "download")  # what timed_phases times


def build_scene(h: int = H, w: int = W) -> np.ndarray:
    """Structured three-band light field, host-side ([G, h, w, 4] u8).

    The same bytes as ``scripts/bench_8k.build_scene`` at (h, w): three
    depth bands whose texture shifts 33.6, 14.4 and 0 px per grid cell
    (focus 0.035, 0.015 and 0.0 at 7680 wide), seed 8. The per-cell copies
    read a pixel-interleaved copy of the texture, so each is a plain slice,
    and run on a thread pool."""
    rng = np.random.default_rng(SEED)
    m = 128
    tex = rng.integers(0, 256, (3, h + 2 * m, w + 2 * m), dtype=np.uint8)
    t = tex.astype(np.float32)
    t = (t + np.roll(t, 1, 1) + np.roll(t, 1, 2) + np.roll(t, 2, 1)) / 4
    tex = np.ascontiguousarray(t.astype(np.uint8).transpose(1, 2, 0))
    del t
    band = h // 3
    shifts = (33.6, 14.4, 0.0)  # near, mid, far
    out = np.empty((COLS * ROWS, h, w, 4), np.uint8)

    def fill(cell: int) -> None:
        c, r = divmod(cell, ROWS)
        px_, py_ = c - (COLS - 1) / 2, r - (ROWS - 1) / 2
        out[cell, ..., 3] = 255
        y0 = 0
        for s, h_band in zip(shifts, (band, band, h - 2 * band)):
            dx = int(round(px_ * s)) + m
            dy = int(round(py_ * s)) + m
            out[cell, y0:y0 + h_band, :, :3] = tex[dy + y0:dy + y0 + h_band, dx:dx + w]
            y0 += h_band

    # the cells are disjoint; NumPy's copies release the GIL
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(COLS * ROWS)))
    return out


def band_rows(h: int) -> int:
    """The first row of the checked band: mid-frame, 2160 at 8K."""
    return min(2160, h // 2)


def oracle_band_map0(images, offsets, ids, radius, r0, rc):
    """``reference.focus_map_estimate``'s expressions on rows r0..r0+rc-1
    only, at their absolute coordinates, reading the full images.

    Evaluated otherwise than the oracle, with every value as it is there:
    a tap's row depends on the row alone and its column on the column alone
    (``trunc(f32(q) + f32(f*o))`` for each axis), so each view's taps are a
    row gather then a column gather of a contiguous RGB copy of the rows
    the band can reach; the running per-channel min and max stay uint8
    (the oracle's float32 min and max of uint8 values are those values)
    until their difference is taken in float32. ``tests/test_torch_scripts.py``
    holds the band to the oracle's own rows."""
    from lfinterpolator_tpu_torch.core import geometry

    h, w = images.shape[1:3]
    rx, ry = int(radius[0]), int(radius[1])
    ys = np.arange(r0, r0 + rc, dtype=np.float32)
    xs = np.arange(w, dtype=np.float32)
    best_cost = np.full((rc, w), np.finfo(np.float32).max, dtype=np.float32)
    best_focus = np.zeros((rc, w), dtype=np.float32)
    stencil = [(sx, sy) for sx in (-rx, 0, rx) for sy in (-ry, 0, ry)]
    candidates = geometry.focus_candidates(FOCUS, FRANGE, STEPS)
    rows = {}  # view -> (first row, the rows its taps can reach as contiguous RGB)
    for vid in ids:
        reach = np.concatenate([np.trunc(ys + np.float32(f) * offsets[vid, 1])
                                for f in candidates])
        lo = int(np.clip(reach.min() - ry, 0, h - 1))
        hi = int(np.clip(reach.max() + ry, 0, h - 1))
        rows[vid] = lo, np.ascontiguousarray(images[vid, lo:hi + 1, :, :3])
    for f in candidates:
        mins = np.full((9, rc, w, 3), 255, dtype=np.uint8)
        maxs = np.zeros((9, rc, w, 3), dtype=np.uint8)
        for vid in ids:
            cx0 = np.trunc(xs + np.float32(f) * offsets[vid, 0]).astype(np.int64)
            cy0 = np.trunc(ys + np.float32(f) * offsets[vid, 1]).astype(np.int64)
            lo, img = rows[vid]
            for i, (sx, sy) in enumerate(stencil):
                px = img.take(np.clip(cy0 + sy, 0, h - 1) - lo, axis=0).take(
                    np.clip(cx0 + sx, 0, w - 1), axis=1)
                np.minimum(mins[i], px, out=mins[i])
                np.maximum(maxs[i], px, out=maxs[i])
        cost = np.zeros((rc, w), dtype=np.float32)
        for i in range(9):
            cost += np.max(maxs[i].astype(np.float32) - mins[i].astype(np.float32), axis=-1)
        better = cost < best_cost
        best_cost = np.where(better, cost, best_cost)
        best_focus = np.where(better, np.float32(f), best_focus)
    normalized = (best_focus - np.float32(FOCUS)) / np.float32(FRANGE)
    return geometry.round_half_away(normalized * np.float32(255)).astype(np.uint8)


def oracle_band_filter(map0, frad, r0, rc):
    """``reference.focus_map_filter``'s expressions on rows r0..r0+rc-1 of
    the full map `map0`."""
    from lfinterpolator_tpu_torch.core import geometry

    rx, ry = int(frad[0]), int(frad[1])
    if rx == 0 or ry == 0:
        return map0[r0:r0 + rc].copy()
    h, w = map0.shape
    acc = np.zeros((rc, w), dtype=np.float32)
    yy, xx = np.meshgrid(np.arange(r0, r0 + rc), np.arange(w), indexing="ij")
    for dx in range(-rx, rx):
        for dy in range(-ry, ry):
            acc += map0[np.clip(yy + dy, 0, h - 1), np.clip(xx + dx, 0, w - 1)].astype(np.float32)
    acc /= np.float32(4 * rx * ry)
    return geometry.round_half_away(acc).astype(np.uint8)


def oracle_band_selected(images, offsets, fmap, r0, rc):
    """``reference.blend_allfocus``'s per-pixel selection on rows
    r0..r0+rc-1: every image at its pixel's focus, [G, rc, w, 3] u8."""
    from lfinterpolator_tpu_torch.ops import reference

    g_count, h, w = images.shape[:3]
    fv = reference.focus_values_from_map(fmap[r0:r0 + rc], FOCUS, FRANGE)
    yy, xx = np.meshgrid(np.arange(r0, r0 + rc), np.arange(w), indexing="ij")
    out = np.empty((g_count, rc, w, 3), np.uint8)
    for g in range(g_count):
        cx = np.trunc(xx.astype(np.float32) + fv * offsets[g, 0]).astype(np.int64)
        cy = np.trunc(yy.astype(np.float32) + fv * offsets[g, 1]).astype(np.int64)
        out[g] = images[g, :, :, :3][np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)]
    return out


def verify_band(images, views, maps, method, config=None) -> dict:
    """The band check of the module docstring on one render's host views
    [V, h, w, 3] and maps [2, h, w]. -> {"ok", "rows", "map0_maxdiff",
    "map1_maxdiff", "views": the near-tie counts or the first error}."""
    import torch

    from lfinterpolator_tpu_torch import RenderConfig, state
    from lfinterpolator_tpu_torch.ops import blend_torch

    h, w = images.shape[1:3]
    cfg = config or RenderConfig(view_count=VIEWS, focus_map_views=FOCUS_VIEWS,
                                 focus_steps=STEPS)
    p = state.allfocus_params(TRAJ, cols=COLS, rows=ROWS, height=h, width=w,
                              config=dataclasses.replace(cfg, focus=FOCUS,
                                                         focus_range=FRANGE))
    r0, rc = band_rows(h), BAND_ROWS
    want0 = oracle_band_map0(images, p.offsets, p.focus_ids, p.radius, r0, rc)
    d_map0 = int(np.abs(want0.astype(int) - maps[0, r0:r0 + rc].astype(int)).max())
    want1 = oracle_band_filter(maps[0], p.filter_radius, r0, rc)
    d_map1 = int(np.abs(want1.astype(int) - maps[1, r0:r0 + rc].astype(int)).max())
    fmap = maps[1] if method == "STD" else maps[0]
    selected = torch.from_numpy(oracle_band_selected(images, p.offsets, fmap, r0, rc))
    sums = blend_torch.exact_sums(selected, torch.from_numpy(p.weights))
    try:
        rule = blend_torch.check_bytes(torch.from_numpy(np.ascontiguousarray(
            views[:, r0:r0 + rc])), sums)
    except AssertionError as e:
        rule = {"error": str(e)}
    return {"ok": d_map0 == 0 and d_map1 == 0 and "error" not in rule,
            "rows": [r0, r0 + rc], "map0_maxdiff": d_map0, "map1_maxdiff": d_map1,
            "views": rule}


@contextlib.contextmanager
def timed_phases(interp, device):
    """Time the estimate and the blend (``profiling.Timer``: CUDA events on
    the card) and the download (host clock, after a synchronize) of the
    Interpolator's calls inside the block; yields {phase: seconds}. Inside
    the block a frame renders whole, not in the row bands whose downloads
    overlap the blend (``utils/transfer.py``), so the phases run one after
    another."""
    import torch

    from lfinterpolator_tpu_torch.models import pipeline
    from lfinterpolator_tpu_torch.utils import profiling, transfer

    times: dict[str, float] = {}
    phase = {"compute_focus_maps": "estimate", "blend_all_focus": "blend"}
    saved = [(name, getattr(pipeline, name)) for name in phase]

    def timed(name, fn):
        name = phase[name]

        def run(*a, **k):
            with profiling.Timer(device) as t:
                out = fn(*a, **k)
            times[name] = times.get(name, 0.0) + t.elapsed_s
            return out
        return run

    def to_host(*a):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = download(*a)
        times["download"] = times.get("download", 0.0) + time.perf_counter() - t0
        return out

    download, bands = interp._to_host, transfer.frame_bands
    for name, fn in saved:
        setattr(pipeline, name, timed(name, fn))
    interp._to_host = to_host
    transfer.frame_bands = lambda device, g, c, h, w, v, allfocus: transfer.row_bands(h, 1)
    try:
        yield times
    finally:
        for name, fn in saved:
            setattr(pipeline, name, fn)
        del interp._to_host
        transfer.frame_bands = bands


def host_peak_gib() -> float:
    """The process's peak resident memory (ru_maxrss), GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def render_method(interp, method, device, verify_images=None, log=print) -> dict:
    """Plan, first call, instrumented call, steady call and (given the
    host images) the band check of one method; frees its results."""
    import torch

    from lfinterpolator_tpu_torch.core import capacity
    from lfinterpolator_tpu_torch.utils import profiling

    g, c, h, w = interp.images.shape
    plan = capacity.plan_render(g, c, h, w, VIEWS, method=method, focus_views=FOCUS_VIEWS,
                                device=device)
    stack = interp.images.numel()
    arm = f"view batches of {plan.view_batch}" if plan.batched else "one pass"
    log(f"[{method}] plan: {arm}, {plan.bytes_unbatched / 1e9:.3f} GB beyond the "
        f"{stack / 1e9:.3f} GB stack, budget {plan.budget / 1e9:.3f} GB")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def call():
        t0 = time.perf_counter()
        res = interp.interpolate(TRAJ, focus=FOCUS, focus_range=FRANGE, method=method,
                                 progress=False)
        return res, time.perf_counter() - t0

    launches0 = profiling.launch_counts()
    res, first_s = call()
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    del res
    with timed_phases(interp, device) as phases:
        res, instrumented_s = call()
    del res
    if set(phases) != set(PHASES):  # the API reached the estimate or blend otherwise
        raise RuntimeError(f"the instrumented call timed {sorted(phases)}, not {list(PHASES)}")
    res, steady_s = call()
    launches = dict(profiling.launch_counts() - launches0)
    rec = {
        "plan": {"arm": arm, "view_batch": plan.view_batch,
                 "bytes_planned": plan.bytes_unbatched, "stack_bytes": stack,
                 "budget_bytes": plan.budget},
        "max_memory_allocated": peak,
        "first_call_s": first_s, "instrumented_call_s": instrumented_s,
        "steady_call_s": steady_s,
        "phases_ms": {k: v * 1e3 for k, v in phases.items()},
        "launches": launches,
    }
    log(f"[{method}] first call {first_s:.3f} s, steady {steady_s:.3f} s; instrumented "
        f"{instrumented_s:.3f} s: " + ", ".join(f"{k} {v:.3f} ms"
                                                for k, v in rec["phases_ms"].items())
        + (f"; max_memory_allocated {peak / 1e9:.3f} GB against {(stack + plan.bytes_unbatched) / 1e9:.3f} GB planned with the stack"
           if cuda else "") + f"; launches {launches}")
    if verify_images is not None:
        t0 = time.perf_counter()
        rec["verify"] = verify_band(verify_images, res.views, res.maps, method)
        rec["verify"]["seconds"] = time.perf_counter() - t0
        log(f"[{method}] band check: {json.dumps(rec['verify'])}")
    del res
    rec["host_peak_rss_gib"] = host_peak_gib()
    return rec


def run(methods, *, size=(H, W), device="cuda", verify=True, log=print) -> dict:
    """Build the scene, upload it once, render and check each method; ->
    the RESULT payload."""
    import torch

    from lfinterpolator_tpu_torch import RenderConfig
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.io import LightField
    from lfinterpolator_tpu_torch.utils import devices, profiling

    device = devices.resolve(device, "the 8K render")
    card = profiling.card_line(device)
    log(card)
    h, w = size
    t0 = time.perf_counter()
    images = build_scene(h, w)
    scene_s = time.perf_counter() - t0
    log(f"scene built: {images.nbytes / 2**30:.2f} GiB host, {scene_s:.1f} s")
    cfg = RenderConfig(view_count=VIEWS, focus_map_views=FOCUS_VIEWS, focus_steps=STEPS)
    t0 = time.perf_counter()
    interp = Interpolator(LightField(images=images, cols=COLS, rows=ROWS), config=cfg,
                          device=device, progress=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    upload_s = time.perf_counter() - t0
    gib = interp.images.numel() / 2**30
    log(f"upload: {gib:.2f} GiB planar in {upload_s:.2f} s (host planar copy and the "
        f"copy to the card)")
    results = {}
    for method in methods:
        results[method] = render_method(interp, method, device,
                                        images if verify else None, log=log)
    del interp, images
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "config": f"{COLS}x{ROWS} grid, {w}x{h}, {VIEWS} views, K={FOCUS_VIEWS}, "
                  f"steps={STEPS}, focus {FOCUS} range {FRANGE}",
        "device": card,
        "scene_s": scene_s, "upload_gib": gib, "upload_s": upload_s,
        "host_peak_rss_gib": host_peak_gib(),
        "methods": results,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="both", choices=["TEN", "STD", "both"])
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--size", default=f"{H}x{W}", help="HxW (default the 8K frame)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    h, w = (int(x) for x in args.size.lower().split("x"))
    methods = ["TEN", "STD"] if args.method == "both" else [args.method]
    result = run(methods, size=(h, w), device=args.device, verify=not args.no_verify,
                 log=lambda m: print(m, flush=True))
    print("RESULT " + json.dumps(result), flush=True)
    return 0 if all(r.get("verify", {"ok": True})["ok"] for r in result["methods"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
