#!/usr/bin/env python
"""Temporal quality of --map-refresh N (the stream's stale-map reuse), on
the PyTorch port.

Port of ``scripts/map_refresh_quality.py``. ``focus_map_refresh = N``
re-estimates the focus maps every Nth streamed frame and blends the frames
in between with the latest maps -- an approximation whose error depends on
how fast the depth structure moves. An animated parallax-occlusion scene
(``utils/scenes.py``, occluders drifting ``--speed`` px/frame over the
background; focus 0.1, range 0.3, TEN) is streamed through the port's
``StreamingRenderer`` once at refresh 1 (a map per frame, the reference)
and once at each N, and every stale frame is scored against the per-frame
one (PSNR over all its views). Refresh frames (t % N == 0) are bit-identical
by construction: they are checked so and left out of the scores.

Prints one strict JSON line (no NaN or Infinity): per N the stale frames,
those identical to the per-frame render, and the mean and min dB over the
others (null when there are none), plus each stream's frames per second
(host clock, the frames already in host memory). N must be at least 2.

Usage: torch_map_refresh_quality.py [--size HxW] [--grid CxR] [--frames F]
    [--speed PX] [--refresh N,N,...] [--views V] [--steps S] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

FOCUS, FRANGE = 0.1, 0.3
TRAJECTORY = "0,0,1,1"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", default="96x128")
    p.add_argument("--grid", default="4x4")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--speed", type=float, default=2.0,
                   help="occluder drift in px/frame (depth-edge motion)")
    p.add_argument("--refresh", default="4,8")
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu (the plain "
                        "PyTorch path)")
    return p.parse_args(argv)


def run(args) -> dict:
    """Stream the scene at refresh 1 and at each N; -> the JSON payload."""
    import torch

    from lfinterpolator_tpu_torch import RenderConfig, StreamingRenderer
    from lfinterpolator_tpu_torch.utils import devices, metrics, profiling
    from lfinterpolator_tpu_torch.utils.scenes import make_occlusion_scene, occlusion_foci

    device = devices.resolve(args.device, "the map-refresh harness")
    h, w = (int(x) for x in args.size.lower().split("x"))
    cols, rows = (int(x) for x in args.grid.lower().split("x"))
    refreshes = [int(x) for x in args.refresh.split(",")]
    foci = occlusion_foci(FOCUS, FRANGE, args.steps)
    frames = [make_occlusion_scene(cols, rows, h, w, plane_foci=foci, seed=21,
                                   occluder_shift=(0.0, args.speed * t))
              for t in range(args.frames)]

    def stream(n: int):
        sr = StreamingRenderer(cols, rows, w, h, TRAJECTORY, device=device, config=RenderConfig(
            method="TEN", focus=FOCUS, focus_range=FRANGE, view_count=args.views,
            focus_steps=args.steps, focus_map_views=min(32, cols * rows),
            focus_map_refresh=n))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        views = [v for v, _ in sr.render_stream(frames)]
        return views, len(frames) / (time.perf_counter() - t0)

    exact, fps1 = stream(1)
    result = {
        "scene": {"size": f"{h}x{w}", "grid": f"{cols}x{rows}",
                  "frames": args.frames, "speed_px_per_frame": args.speed},
        "device": profiling.card_line(device),
        "refresh": {},
        "fps": {"1": fps1},
    }
    for n in refreshes:
        stale, fps = stream(n)
        result["fps"][str(n)] = fps
        scores = []
        for t in range(args.frames):
            if t % n == 0:  # bit-identical by construction
                if not np.array_equal(stale[t], exact[t]):
                    raise AssertionError(f"refresh {n}: refresh frame {t} differs from "
                                         "the per-frame render")
                continue
            scores.append(metrics.psnr(stale[t], exact[t]))
        finite = [s for s in scores if np.isfinite(s)]
        result["refresh"][str(n)] = {
            "stale_frames": len(scores),
            # stale frames whose maps happen to still be exact (slow motion)
            "identical_frames": len(scores) - len(finite),
            "mean_db": round(float(np.mean(finite)), 2) if finite else None,
            "min_db": round(float(np.min(finite)), 2) if finite else None,
        }
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    bad = [x for x in args.refresh.split(",") if not x.strip().isdigit() or int(x) < 2]
    if bad:
        print(f"--refresh takes integers >= 2 (N = 1 is the per-frame reference), got "
              f"{','.join(bad)}", file=sys.stderr)
        return 1
    print(json.dumps(run(args), allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
