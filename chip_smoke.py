"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's fixed-focus and all-in-focus renders
(lfinterpolator_tpu_torch) at the headline size -- an 8x8 grid of
1080x1920 images, 64 views; all in focus with K = 32 focus views, 32
candidates, stencil radius (20, 10) -- through the kernel wrappers, the
Interpolator API and the CLI. Phases, in order; any failure raises and the
script exits non-zero:

  1. card name and power limit (nvidia-smi), torch/CUDA versions, codec;
  2. build the CUDA kernels from lfinterpolator_tpu_torch/csrc/ (one nvcc
     per source, in parallel) and print ptxas's report of each kernel;
  3. shift_blend against its plain PyTorch version at full size
     (torch.equal) for focus 0.1, -0.35 and 5.0 (the last pushes shifts
     past the image), and both timed with CUDA events;
  4. shift_blend against a sequential NumPy oracle on a 4x4/48x64 scene
     (bit-equal);
  5. Interpolator end to end on a seeded 8x8/1080p light field: TEN (the
     kernel) and STD (plain ops) bit-equal, two views checked against the
     oracle, kernel launches counted;
  6. the fixed-focus CLI in a subprocess on that grid at a quarter of the
     resolution, written as PNGs: 64 PNGs that decode equal to the API's
     render of the same grid;
  7. focus_estimate, both tap rules, against its plain version at full
     size on a seeded random stack (focus 0.1, range 0.3; torch.equal),
     both timed;
  8. allfocus_blend against its plain version at full size, on phase 7's
     raw map and its filtered map (torch.equal), both timed;
  9. both new kernels against sequential NumPy oracles written here, on a
     4x4/48x64 scene (bit-equal);
 10. the all-in-focus Interpolator on phase 5's light field (focus 0.1,
     range 0.3): TEN, STD and TEN with the fast tap rule, each timed,
     each kernel's launches counted, views and maps equal to the plain
     pipeline on the same tensors, map0 not constant;
 11. the all-in-focus CLI (-r 0.3) at full size: 64 PNGs, map0.png and
     map1.png that decode equal to phase 10's TEN render;
 12. the kernels line, then the last line: {"ok": true, "device": {...}}.

Exits 1 at once when no CUDA device is present. Needs one GPU, no network.
Imports only the port (lfinterpolator_tpu_torch), never jax.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAJECTORY = "0,0,1,1"
EFFECT = 3.0
COLS = ROWS = 8
H, W = 1080, 1920
VIEWS = 64
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def phase1_environment(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from lfinterpolator_tpu_torch import io

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"codec {io.codec_name()}")
    return smi


def phase2_build() -> None:
    from lfinterpolator_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load()
    log(f"[2] built {_build.LIB_PATH} from {len(_build.sources())} sources "
        f"in {time.perf_counter() - t0:.2f} s")
    log(_build.build_log.strip())


def weights_and_shifts(cols, rows, h, w, focus):
    from lfinterpolator_tpu_torch.state import render_params

    return render_params(TRAJECTORY, cols=cols, rows=rows, height=h, width=w,
                         focus=focus, effect=EFFECT, views=VIEWS)


def oracle(np, images, wm, fo):
    """[G, H, W, >=3] u8 x [V, G] x [G, 2] (dx, dy) -> [V, H, W, 3] u8.

    The fixed-focus blend summed in f32 in ascending g, each product and
    each sum rounded on its own, then rounded half to even and clipped:
    the semantics of the reference's STD kernel, written out here without
    torch so that it is independent of the code under test."""
    g_count, h, w = images.shape[:3]
    acc = np.zeros((wm.shape[0], h, w, 3), dtype=np.float32)
    for g in range(g_count):
        ys = np.clip(np.arange(h) + int(fo[g, 1]), 0, h - 1)
        xs = np.clip(np.arange(w) + int(fo[g, 0]), 0, w - 1)
        px = images[g][np.ix_(ys, xs)][..., :3].astype(np.float32)
        acc += wm[:, g].astype(np.float32)[:, None, None, None] * px[None]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def event_ms(torch, fn, runs: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def phase3_kernel_vs_plain(torch, np, stack, smi) -> dict:
    from lfinterpolator_tpu_torch.ops import shift_blend
    from lfinterpolator_tpu_torch.state import to_device_state

    max_err = 0
    timing = None
    for focus in (0.1, -0.35, 5.0):
        wm, fo = weights_and_shifts(COLS, ROWS, H, W, focus)
        images, weights, shifts = to_device_state(stack, wm, fo, "cuda")
        got = shift_blend.shift_blend(images, weights, shifts)
        want = shift_blend.shift_blend_reference(images, weights, shifts)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"kernel != plain version at focus {focus}: "
                f"{int((got != want).sum())} bytes differ, max {err}"
            )
        log(f"[3] focus {focus}: kernel == plain on {got.numel()} bytes "
            f"(shift range dx {fo[:, 0].min()}..{fo[:, 0].max()})")
        del got, want
        if focus == 0.1:
            ms = event_ms(torch, lambda: shift_blend.shift_blend(images, weights, shifts))
            plain_ms = event_ms(
                torch, lambda: shift_blend.shift_blend_reference(images, weights, shifts)
            )
            timing = (ms, plain_ms)
            log(f"[3] 8x8/1080p/64v: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                f"({smi})")
        del images
        torch.cuda.empty_cache()
    log(f"[3] launches so far {shift_blend.launches}")
    return {"max_abs_err": max_err, "ms": timing[0], "plain_ms": timing[1]}


def phase4_oracle(torch, np) -> int:
    from lfinterpolator_tpu_torch.ops import shift_blend
    from lfinterpolator_tpu_torch.state import to_device_state

    rng = np.random.default_rng(SEED + 1)
    stack = rng.integers(0, 256, (16, 48, 64, 4), dtype=np.uint8)
    worst = 0
    for focus in (0.37, -2.0):
        wm, fo = weights_and_shifts(4, 4, 48, 64, focus)
        got = shift_blend.shift_blend(*to_device_state(stack, wm, fo, "cuda"))
        got = got.permute(0, 2, 3, 1).cpu().numpy()
        want = oracle(np, stack, wm, fo)
        worst = max(worst, int(np.abs(got.astype(int) - want).max()))
        if not np.array_equal(got, want):
            raise AssertionError(f"kernel != oracle at focus {focus}: max {worst}")
    log("[4] kernel == NumPy oracle on 4x4/48x64/64v")
    return worst


def seeded_light_field(np):
    """The tests' textured-plane scene (tests/conftest.py) at 8x8/1080p."""
    from lfinterpolator_tpu_torch.io import LightField

    rng = np.random.default_rng(SEED + 2)
    t = rng.integers(0, 256, size=(H * 2, W * 2, 3), dtype=np.uint8).astype(np.float32)
    t = (t + np.roll(t, 1, 0) + np.roll(t, 1, 1) + np.roll(t, 2, 0)) / 4.0
    texture = t.astype(np.uint8)
    del t
    images = np.empty((COLS * ROWS, H, W, 4), dtype=np.uint8)
    for c in range(COLS):
        for r in range(ROWS):
            images[c * ROWS + r, :, :, :3] = texture[r * 2 : r * 2 + H, c * 2 : c * 2 + W]
            images[c * ROWS + r, :, :, 3] = 255
    return LightField(images=images, cols=COLS, rows=ROWS)


def phase5_api(torch, np, lf, smi) -> tuple:
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.ops import shift_blend

    interp = Interpolator(lf, device="cuda", progress=False)
    shift_blend.launches = 0  # count only the main path's launches
    ten = interp.interpolate(TRAJECTORY, focus=0.1, method="TEN",
                             benchmark_runs=20, progress=False)
    launches = shift_blend.launches
    if launches < 1:
        raise AssertionError("the TEN render launched the kernel no time")
    std = interp.interpolate(TRAJECTORY, focus=0.1, method="STD",
                             benchmark_runs=20, progress=False)
    if shift_blend.launches != launches:
        raise AssertionError("the STD render launched the kernel")
    del interp
    torch.cuda.empty_cache()
    for name, res in (("TEN", ten), ("STD", std)):
        if res.views.shape != (VIEWS, H, W, 3) or res.views.dtype != np.uint8:
            raise AssertionError(f"{name} views {res.views.shape} {res.views.dtype}")
        log(f"[5] {name}: {res.avg_ms:.3f} ms/frame, "
            f"{res.megapixels_per_s / 1e3:.3f} output GP/s over 20 runs ({smi})")
    if not np.array_equal(ten.views, std.views):
        raise AssertionError(
            f"TEN != STD: {int((ten.views != std.views).sum())} bytes differ"
        )
    # Two views (first and last) against the oracle at full size.
    wm, fo = weights_and_shifts(COLS, ROWS, H, W, 0.1)
    pick = [0, VIEWS - 1]
    want = oracle(np, lf.images, wm[pick], fo)
    if not np.array_equal(ten.views[pick], want):
        raise AssertionError("TEN views 0 and 63 != the NumPy oracle")
    log(f"[5] TEN == STD on {ten.views.size} bytes; views 0 and {VIEWS - 1} "
        f"== oracle; kernel launches in the TEN render: {launches}")
    return ten, std, launches


def run_cli(np, tag, images, flags, views, maps=None) -> None:
    """Write `images` ([G, h, w, 4] u8, the COLSxROWS grid) as PNGs, run the
    CLI on them with `flags` in a subprocess, and check that its PNGs
    decode equal to `views` (and `maps`, as map0.png/map1.png)."""
    from concurrent.futures import ThreadPoolExecutor

    from lfinterpolator_tpu_torch import io

    work = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    scene, out = os.path.join(work, "scene"), os.path.join(work, "out")
    os.makedirs(scene)
    h, w = images.shape[1:3]
    t0 = time.perf_counter()

    def write(i):
        c, r = divmod(i, ROWS)
        io.encode_png(os.path.join(scene, f"{c:02d}_{r:02d}.png"), images[i])

    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
        list(ex.map(write, range(COLS * ROWS)))
    log(f"[{tag}] wrote the {COLS}x{ROWS} grid at {w}x{h} as PNGs "
        f"({io.codec_name()} codec) in {time.perf_counter() - t0:.1f} s")
    cmd = [sys.executable, "-m", "lfinterpolator_tpu_torch.cli", "-i", scene,
           "-o", out, "-t", TRAJECTORY, *flags, "--json"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"CLI exit {proc.returncode}: {proc.stderr[-4000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[{tag}] CLI {' '.join(flags)} in {time.perf_counter() - t0:.1f} s: {summary}")
    want = {f"{i:02d}.png": views[i] for i in range(VIEWS)}
    if maps is not None:
        want.update({f"map{i}.png": np.repeat(maps[i][..., None], 3, axis=-1)
                     for i in range(2)})
    names = sorted(n for n in os.listdir(out) if n.endswith(".png"))
    if names != sorted(want) or summary["files_written"] != len(want):
        raise AssertionError(f"CLI wrote {names[:4]}... ({len(names)} files)")
    for name in names:
        back = io.decode(os.path.join(out, name))
        if not np.array_equal(back[..., :3], want[name]) or (back[..., 3] != 255).any():
            raise AssertionError(f"CLI file {name} != the API render")
    log(f"[{tag}] {len(names)} PNGs decode equal to the API render")
    shutil.rmtree(work, ignore_errors=True)


def phase6_cli(torch, np, lf) -> None:
    """The fixed-focus CLI on phase 5's grid at a quarter of the resolution
    (the full-size CLI run is phase 11's, all in focus)."""
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.io import LightField

    small = LightField(np.ascontiguousarray(lf.images[:, ::4, ::4]), COLS, ROWS)
    ten = Interpolator(small, device="cuda", progress=False).interpolate(
        TRAJECTORY, focus=0.1, method="TEN", progress=False)
    torch.cuda.empty_cache()
    run_cli(np, 6, small.images, ["-m", "TEN", "-f", "0.1"], ten.views)


def allfocus_setup(focus, focus_range, cols, rows, h, w, exact=True,
                   focus_views=32):
    """An all-focus render's host params and its device tensors."""
    from lfinterpolator_tpu_torch import RenderConfig, state

    cfg = RenderConfig(focus=focus, focus_range=focus_range, exact_focus_taps=exact,
                       focus_map_views=focus_views)
    p = state.allfocus_params(TRAJECTORY, cols=cols, rows=rows, height=h,
                              width=w, config=cfg)
    return p, *state.upload_allfocus(p, "cuda")


def phase7_estimate_vs_plain(torch, np, stack, smi) -> tuple:
    from lfinterpolator_tpu_torch.ops import focus_estimate
    from lfinterpolator_tpu_torch.state import upload_images

    images = upload_images(stack, "cuda")
    p, weights, offsets, ids, tables = allfocus_setup(0.1, 0.3, COLS, ROWS, H, W)
    selected, sel_offsets = images[ids], offsets[ids]
    log(f"[7] K={len(ids)} focus views, {len(p.tables.candidates)} candidates, "
        f"radius {p.radius}, filter radius {p.filter_radius}")
    stats, maps = {}, {}
    for rule, exact in (("exact", True), ("fast", False)):
        args = (selected, sel_offsets, tables, p.radius, exact)
        got = focus_estimate.focus_estimate(*args)
        want = focus_estimate.focus_estimate_reference(*args)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(
                f"focus_estimate ({rule}) != plain version: "
                f"{int((got != want).sum())} bytes differ, max {err}"
            )
        ms = event_ms(torch, lambda: focus_estimate.focus_estimate(*args), runs=5)
        plain_ms = event_ms(
            torch, lambda: focus_estimate.focus_estimate_reference(*args), runs=2)
        stats[rule] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        maps[rule] = got
        log(f"[7] {rule}: kernel == plain on {got.numel()} map bytes "
            f"({len(torch.unique(got))} distinct); kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms ({smi})")
    del selected
    return stats, (p, images, weights, offsets, tables, maps["exact"])


def phase8_allfocus_vs_plain(torch, smi, state7) -> dict:
    from lfinterpolator_tpu_torch.ops import allfocus_blend, focus_torch

    p, images, weights, offsets, tables, map0 = state7
    map1 = focus_torch.filter_focus_map(map0, p.filter_radius)
    max_err, timing = 0, None
    for name, fmap in (("raw map0", map0), ("filtered map1", map1)):
        args = (images, weights, offsets, fmap, tables.decode)
        got = allfocus_blend.allfocus_blend(*args)
        want = allfocus_blend.allfocus_blend_reference(*args)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"allfocus_blend != plain version on the {name}: "
                f"{int((got != want).sum())} bytes differ, max {err}"
            )
        log(f"[8] {name} ({len(torch.unique(fmap))} distinct bytes): kernel == "
            f"plain on {got.numel()} bytes")
        del got, want
        if timing is None:
            ms = event_ms(torch, lambda: allfocus_blend.allfocus_blend(*args))
            plain_ms = event_ms(
                torch, lambda: allfocus_blend.allfocus_blend_reference(*args), runs=3)
            timing = (ms, plain_ms)
            log(f"[8] 8x8/1080p/64v: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                f"({smi})")
    return {"max_abs_err": max_err, "ms": timing[0], "plain_ms": timing[1]}


def oracle_estimate(np, views, offsets, cands, cand_bytes, radius):
    """[K, H, W, 3] u8 views, [K, 2] (x, y) offsets -> [H, W] u8 map.

    The exact-tap disparity search written out sequentially: per candidate
    f, taps at clip(trunc(f32(q) + f32(f*o)) + s), cost the sum over the
    3x3 taps of max_c(max_k - min_k), first strict minimum wins."""
    k, h, w = views.shape[:3]
    rx, ry = radius
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    best = np.full((h, w), np.iinfo(np.int64).max)
    best_i = np.zeros((h, w), dtype=np.int64)
    for i, f in enumerate(cands):
        lo = np.full((9, h, w, 3), 255, dtype=np.int64)
        hi = np.zeros((9, h, w, 3), dtype=np.int64)
        for v in range(k):
            cy = np.trunc(ys + f * offsets[v, 1]).astype(np.int64)
            cx = np.trunc(xs + f * offsets[v, 0]).astype(np.int64)
            for t, (sy, sx) in enumerate((a, b) for a in (-ry, 0, ry) for b in (-rx, 0, rx)):
                px = views[v][np.clip(cy + sy, 0, h - 1), np.clip(cx + sx, 0, w - 1)]
                lo[t] = np.minimum(lo[t], px)
                hi[t] = np.maximum(hi[t], px)
        cost = (hi - lo).max(axis=-1).sum(axis=0)
        better = cost < best
        best = np.where(better, cost, best)
        best_i = np.where(better, i, best_i)
    return cand_bytes[best_i]


def oracle_allfocus(np, images, wm, offsets, fmap, decode):
    """[G, H, W, >=3] u8 -> [V, H, W, 3] u8: each image read at
    clip(trunc(f32(q) + f32(f*o))) with f = decode[map], summed in f32 in
    ascending g, rounded half to even, clipped."""
    g_count, h, w = images.shape[:3]
    f = decode[fmap]
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    acc = np.zeros((wm.shape[0], h, w, 3), dtype=np.float32)
    for g in range(g_count):
        cy = np.clip(np.trunc(ys + f * offsets[g, 1]).astype(np.int64), 0, h - 1)
        cx = np.clip(np.trunc(xs + f * offsets[g, 0]).astype(np.int64), 0, w - 1)
        px = images[g][cy, cx][..., :3].astype(np.float32)
        acc += wm[:, g].astype(np.float32)[:, None, None, None] * px[None]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def phase9_new_kernels_vs_oracle(torch, np) -> None:
    from lfinterpolator_tpu_torch.ops import allfocus_blend, focus_estimate, focus_torch
    from lfinterpolator_tpu_torch.state import upload_images

    rng = np.random.default_rng(SEED + 3)
    stack = rng.integers(0, 256, (16, 48, 64, 4), dtype=np.uint8)
    images = upload_images(stack, "cuda")
    for focus, focus_range in ((0.1, 0.3), (-0.8, 1.6)):
        p, weights, offsets, ids, tables = allfocus_setup(
            focus, focus_range, 4, 4, 48, 64, focus_views=8)
        map0 = focus_estimate.focus_estimate(
            images[ids], offsets[ids], tables, p.radius, True)
        want = oracle_estimate(np, stack[p.focus_ids, ..., :3], p.offsets[p.focus_ids],
                               p.tables.candidates, p.tables.candidate_bytes, p.radius)
        if not np.array_equal(map0.cpu().numpy(), want):
            raise AssertionError(f"focus_estimate != oracle at focus {focus}")
        for fmap in (map0, focus_torch.filter_focus_map(map0, (2, 2))):
            got = allfocus_blend.allfocus_blend(images, weights, offsets, fmap,
                                                tables.decode)
            want = oracle_allfocus(np, stack, p.weights, p.offsets,
                                   fmap.cpu().numpy(), p.tables.decode)
            if not np.array_equal(got.permute(0, 2, 3, 1).cpu().numpy(), want):
                raise AssertionError(f"allfocus_blend != oracle at focus {focus}")
    log("[9] focus_estimate (exact) and allfocus_blend == NumPy oracles on "
        "4x4/48x64, K=8, 32 candidates, 64v")


def phase10_allfocus_api(torch, np, lf, smi) -> tuple:
    from lfinterpolator_tpu_torch import RenderConfig
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.ops import (
        allfocus_blend, blend_torch, focus_estimate, focus_torch)

    interps = {exact: Interpolator(lf, device="cuda", progress=False,
                                   config=RenderConfig(exact_focus_taps=exact))
               for exact in (True, False)}
    runs = (("TEN", "TEN", True), ("STD", "STD", True), ("TEN fast", "TEN", False))
    # count only the main path's launches
    focus_estimate.launches.update(exact=0, fast=0)
    allfocus_blend.launches = 0
    results = {
        name: interps[exact].interpolate(TRAJECTORY, focus=0.1, focus_range=0.3,
                                         method=method, benchmark_runs=5,
                                         progress=False)
        for name, method, exact in runs
    }
    launches = {"focus_estimate_exact": focus_estimate.launches["exact"],
                "focus_estimate_fast": focus_estimate.launches["fast"],
                "allfocus_blend": allfocus_blend.launches}
    log(f"[10] kernel launches in the all-focus renders: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the all-focus path never ran: {launches}")
    for name, method, exact in runs:
        res = results[name]
        if res.views.shape != (VIEWS, H, W, 3) or res.maps.shape != (2, H, W):
            raise AssertionError(f"{name}: views {res.views.shape}, maps {res.maps.shape}")
        distinct = [len(np.unique(m)) for m in res.maps]
        if distinct[0] < 2:
            raise AssertionError(f"{name}: map0 is constant, the check proves nothing")
        # the plain pipeline on the same CUDA tensors
        images = interps[exact].images
        p, weights, offsets, ids, tables = allfocus_setup(
            0.1, 0.3, COLS, ROWS, H, W, exact)
        map0 = focus_torch.estimate_focus_map(images[ids], offsets[ids], tables,
                                              p.radius, exact)
        map1 = focus_torch.filter_focus_map(map0, p.filter_radius)
        if not (np.array_equal(res.maps[0], map0.cpu().numpy())
                and np.array_equal(res.maps[1], map1.cpu().numpy())):
            raise AssertionError(f"{name}: maps != the plain pipeline's")
        views = blend_torch.render_allfocus(
            images, weights, offsets, map1 if method == "STD" else map0,
            tables.decode)
        if not np.array_equal(res.views, blend_torch.from_planar(views).cpu().numpy()):
            raise AssertionError(f"{name}: views != the plain pipeline's")
        del views
        log(f"[10] {name}: {res.avg_ms:.3f} ms/frame (estimate, filter, blend), "
            f"{res.megapixels_per_s / 1e3:.3f} output GP/s over 5 runs ({smi}); "
            f"distinct bytes map0 {distinct[0]}, map1 {distinct[1]}; views and "
            "maps == the plain pipeline")
    del interps
    torch.cuda.empty_cache()
    return results["TEN"], launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    import lfinterpolator_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    smi = phase1_environment(torch)
    phase2_build()
    rng = np.random.default_rng(SEED)
    stack = rng.integers(0, 256, (COLS * ROWS, H, W, 3), dtype=np.uint8)
    k3 = phase3_kernel_vs_plain(torch, np, stack, smi)
    phase4_oracle(torch, np)
    lf = seeded_light_field(np)
    ten, std, launches = phase5_api(torch, np, lf, smi)
    del ten, std
    phase6_cli(torch, np, lf)
    est, state7 = phase7_estimate_vs_plain(torch, np, stack, smi)
    k8 = phase8_allfocus_vs_plain(torch, smi, state7)
    del state7, stack
    torch.cuda.empty_cache()
    phase9_new_kernels_vs_oracle(torch, np)
    af_ten, af_launches = phase10_allfocus_api(torch, np, lf, smi)
    run_cli(np, 11, lf.images, ["-m", "TEN", "-f", "0.1", "-r", "0.3"],
            af_ten.views, af_ten.maps)
    jax_mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    if jax_mods:
        raise AssertionError(f"the port imported jax: {jax_mods[:5]}")
    src = "lfinterpolator_tpu_torch/csrc/"
    kernels = [
        {"name": "shift_blend", "route": "cuda", "source": src + "shift_blend.cu",
         "replaces": "lfinterpolator_tpu/ops/shift_pallas.py:277 "
                     "(_pshift_kernel), lfinterpolator_tpu/ops/blend_pallas.py:217 "
                     "(_blend_tiled_kernel), lfinterpolator_tpu/ops/blend_pallas.py:165 "
                     "(_blend_kernel)",
         "launches": launches, **k3},
        {"name": "allfocus_blend", "route": "cuda", "source": src + "allfocus_blend.cu",
         "replaces": "lfinterpolator_tpu/ops/allfocus_pallas.py:102 (_af_kernel), "
                     "lfinterpolator_tpu/ops/blend_pallas.py:217 (_blend_tiled_kernel)",
         "launches": af_launches["allfocus_blend"], **k8},
        {"name": "focus_estimate_exact", "route": "cuda",
         "source": src + "focus_estimate.cu",
         "replaces": "lfinterpolator_tpu/ops/estimate_pallas.py:271 (_est_kernel)",
         "launches": af_launches["focus_estimate_exact"], **est["exact"]},
        {"name": "focus_estimate_fast", "route": "cuda",
         "source": src + "focus_estimate.cu",
         "replaces": "lfinterpolator_tpu/ops/estimate_pallas.py:587 (_est_fast_kernel)",
         "launches": af_launches["focus_estimate_fast"], **est["fast"]},
    ]
    log(f"[12] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
