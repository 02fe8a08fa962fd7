#!/usr/bin/env python
"""The port's scripts at the sizes users run them, one after the other on
one card: the runs whose numbers PERF.md keeps for slice 6.

  1. torch_bench_8k.py --method both (8x8 at 4320x7680, 64 views, K = 32);
  2. torch_validate_batching.py (1080x1920, 4x4);
  3. torch_map_refresh_quality.py at 1080x1920, 4x4, 16 frames, --refresh
     4,8, at 2 and at 30 px/frame;
  4. torch_render_video.py on a seeded 8x8 tree of 1080x1920 frames (a
     textured plane panning 8 px a frame; 4 frames): fixed focus TEN at
     0.1, and all in focus (-r 0.3) at map refresh 1 and 4;
  5. torch_quality_gate.py on both scenes at 192x256 and on the plane at
     192x512 (the pyramid row).

Each run is a subprocess; its whole output goes to OUT/<run>.log and its
last line (the script's JSON or RESULT line) to this script's output, with
its wall time. Exit 1 if any run failed.

Usage: torch_card_runs.py [--out build/card_runs]
"""

import argparse
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

VIDEO_FRAMES = 4


def write_tree(root: str, frames: int, cols=8, rows=8, h=1080, w=1920, seed=5) -> None:
    """A seeded video light field: frame t is a smoothed random texture seen
    by a cols x rows grid (2 px between cameras), panned 8 px per frame."""
    from lfinterpolator_tpu_torch import io

    rng = np.random.default_rng(seed)
    t = rng.integers(0, 256, (h + 2 * rows, w + 2 * cols + 8 * frames, 3)).astype(np.float32)
    tex = ((t + np.roll(t, 1, 0) + np.roll(t, 1, 1) + np.roll(t, 2, 0)) / 4).astype(np.uint8)
    del t
    jobs = []
    for f in range(frames):
        d = os.path.join(root, f"frame{f:03d}")
        os.makedirs(d, exist_ok=True)
        for c in range(cols):
            for r in range(rows):
                img = np.full((h, w, 4), 255, np.uint8)
                img[..., :3] = tex[2 * r:2 * r + h, 8 * f + 2 * c:8 * f + 2 * c + w]
                jobs.append((os.path.join(d, f"{c}_{r}.png"), img))
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        list(pool.map(lambda job: io.encode_png(*job), jobs))


def run(name: str, argv: list, out: str) -> bool:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    with open(os.path.join(out, f"{name}.log"), "w") as f:
        f.write(f"$ {' '.join(argv)}\n{proc.stdout}\n--- stderr ---\n{proc.stderr}")
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"[{name}] exit {proc.returncode} in {wall:.1f} s: {last}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-3000:], flush=True)
    return proc.returncode == 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "card_runs"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    from lfinterpolator_tpu_torch.utils import profiling

    print(profiling.card_line("cuda"), flush=True)
    s = "scripts/"
    ok = run("bench_8k", [s + "torch_bench_8k.py", "--method", "both"], args.out)
    ok &= run("validate_batching", [s + "torch_validate_batching.py"], args.out)
    for speed in ("2", "30"):
        ok &= run(f"map_refresh_speed{speed}", [
            s + "torch_map_refresh_quality.py", "--size", "1080x1920", "--grid", "4x4",
            "--frames", "16", "--refresh", "4,8", "--speed", speed], args.out)
    tree = os.path.join(ROOT, "build", "video_tree")
    t0 = time.perf_counter()
    write_tree(tree, VIDEO_FRAMES)
    print(f"[video] wrote {VIDEO_FRAMES} frames of 8x8 1080x1920 PNGs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    base = [s + "torch_render_video.py", "-i", tree, "-t", "0,0,1,1", "-m", "TEN",
            "-f", "0.1"]
    for name, extra in (("video_fixed", []),
                        ("video_allfocus_refresh1", ["-r", "0.3"]),
                        ("video_allfocus_refresh4", ["-r", "0.3", "--map-refresh", "4"])):
        ok &= run(name, base + ["-o", os.path.join(ROOT, "build", name), *extra], args.out)
        shutil.rmtree(os.path.join(ROOT, "build", name), ignore_errors=True)
    shutil.rmtree(tree, ignore_errors=True)
    for name, extra in (("gate_plane", ["--scene", "plane"]),
                        ("gate_occlusion", ["--scene", "occlusion"]),
                        ("gate_pyramid", ["--scene", "plane", "--size", "192x512"])):
        ok &= run(name, [s + "torch_quality_gate.py", *extra], args.out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
