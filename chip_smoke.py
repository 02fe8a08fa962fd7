"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's fixed-focus render (lfinterpolator_tpu_torch) at the
headline size -- an 8x8 grid of 1080x1920 images, 64 views -- through the
kernel wrapper, the Interpolator API and the CLI. Phases, in order; any
failure raises and the script exits non-zero:

  1. card name and power limit (nvidia-smi), torch/CUDA versions, codec;
  2. build the CUDA kernel from lfinterpolator_tpu_torch/csrc/;
  3. kernel against its plain PyTorch version at full size (torch.equal)
     for focus 0.1, -0.35 and 5.0 (the last pushes shifts past the image),
     and both timed with CUDA events;
  4. kernel against a sequential NumPy oracle on a 4x4/48x64 scene
     (bit-equal);
  5. Interpolator end to end on a seeded 8x8/1080p light field: TEN (the
     kernel) and STD (plain ops) bit-equal, two views checked against the
     oracle, kernel launches counted;
  6. the CLI in a subprocess on the same grid written as PNGs: 64 PNGs
     that decode equal to phase 5's render;
  7. the last line: {"ok": true, "device": {...}}.

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
    log(f"[2] built {_build.LIB_PATH} in {time.perf_counter() - t0:.2f} s")
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


def phase3_kernel_vs_plain(torch, np, smi) -> dict:
    from lfinterpolator_tpu_torch.ops import shift_blend
    from lfinterpolator_tpu_torch.state import to_device_state

    rng = np.random.default_rng(SEED)
    stack = rng.integers(0, 256, (COLS * ROWS, H, W, 3), dtype=np.uint8)
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


def phase6_cli(np, lf, ten_views) -> None:
    from lfinterpolator_tpu_torch import io

    work = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    scene, out = os.path.join(work, "scene"), os.path.join(work, "out")
    os.makedirs(scene)
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()

    def write(i):
        c, r = divmod(i, ROWS)
        io.encode_png(os.path.join(scene, f"{c:02d}_{r:02d}.png"), lf.images[i])

    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
        list(ex.map(write, range(COLS * ROWS)))
    log(f"[6] wrote the {COLS}x{ROWS} grid at {W}x{H} as PNGs "
        f"({io.codec_name()} codec) in {time.perf_counter() - t0:.1f} s")
    cmd = [sys.executable, "-m", "lfinterpolator_tpu_torch.cli", "-i", scene,
           "-o", out, "-t", TRAJECTORY, "-m", "TEN", "-f", "0.1", "--json"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"CLI exit {proc.returncode}: {proc.stderr[-4000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[6] CLI in {time.perf_counter() - t0:.1f} s: {summary}")
    names = sorted(n for n in os.listdir(out) if n.endswith(".png"))
    if names != [f"{i:02d}.png" for i in range(VIEWS)]:
        raise AssertionError(f"CLI wrote {names[:4]}... ({len(names)} files)")
    for i, name in enumerate(names):
        back = io.decode(os.path.join(out, name))
        if not np.array_equal(back[..., :3], ten_views[i]) or (back[..., 3] != 255).any():
            raise AssertionError(f"CLI view {name} != the API render")
    log(f"[6] {len(names)} PNGs decode equal to phase 5's TEN render")
    shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    import lfinterpolator_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase1_environment(torch)
    phase2_build()
    k3 = phase3_kernel_vs_plain(torch, np, smi)
    phase4_oracle(torch, np)
    lf = seeded_light_field(np)
    ten, std, launches = phase5_api(torch, np, lf, smi)
    del std
    phase6_cli(np, lf, ten.views)
    jax_mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    if jax_mods:
        raise AssertionError(f"the port imported jax: {jax_mods[:5]}")
    kernels = [{
        "name": "shift_blend",
        "route": "cuda",
        "source": "lfinterpolator_tpu_torch/csrc/shift_blend.cu",
        "replaces": "lfinterpolator_tpu/ops/shift_pallas.py:277 "
                    "(_pshift_kernel), lfinterpolator_tpu/ops/blend_pallas.py:217 "
                    "(_blend_tiled_kernel), lfinterpolator_tpu/ops/blend_pallas.py:165 "
                    "(_blend_kernel)",
        "launches": launches,
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
