#!/usr/bin/env python
"""Render a video light field with the PyTorch port: a directory of
per-frame camera grids.

Port of ``scripts/render_video.py``, with ``--device``.

Input layout:   ROOT/<frame>/<col_row.ext>   (frames sorted by name)
Output layout:  OUT/frame_%05d/00.png..NN.png

Drives ``lfinterpolator_tpu_torch.streaming.StreamingRenderer.render_to_dir``:
frames are decoded in the stream's decode thread into pinned buffers, the
upload of frame t+1 and the download of frame t-1 overlap the render of
frame t, and PNG writes run in a background pool. ``--resume`` skips
frames whose output directory is already complete (writes are atomic),
without decoding them.

Prints the original's two lines, then one JSON line: frames, rendered,
skipped, seconds, fps, and the seconds spent decoding input PNGs (summed
over the decode thread) and encoding output PNGs (summed over the writer
pool's threads).

Usage: torch_render_video.py -i ROOT -o OUT -t 0,0,1,1 [-m TEN_WM] [-f 0.2]
       [-s 3] [-a 1] [-r 0.3] [--map-refresh N] [--resume] [--limit N]
       [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-i", dest="input", required=True)
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("-t", dest="trajectory", required=True)
    p.add_argument("-m", dest="method", default="TEN_WM")
    p.add_argument("-f", dest="focus", type=float, default=0.0)
    p.add_argument("-s", dest="effect", type=float, default=3.0)
    p.add_argument("-a", dest="aspect", type=float, default=1.0)
    p.add_argument("-r", dest="focus_range", type=float, default=0.0,
                   help="focus range; >0 renders all-in-focus per frame")
    p.add_argument("--focus-views", type=int, default=32,
                   help="views used by the focus search")
    p.add_argument("--fast-focus", action="store_true",
                   help="faster, approximate focus estimation (the fast tap rule)")
    p.add_argument(
        "--map-refresh", type=int, default=1, metavar="N",
        help="re-estimate the focus maps every N frames and reuse them in "
             "between (video depth changes slowly). N > 1 is approximate: the "
             "frames in between blend with stale maps; PERF.md holds the dB of "
             "N = 4 and 8 at 1080p (scripts/torch_map_refresh_quality.py)",
    )
    p.add_argument("--resume", action="store_true")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu (the plain "
                        "PyTorch path)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from lfinterpolator_tpu_torch.core.config import RenderConfig
    from lfinterpolator_tpu_torch.io import loader, writer
    from lfinterpolator_tpu_torch.streaming import StreamingRenderer
    from lfinterpolator_tpu_torch.utils import devices

    device = devices.resolve(args.device, "the video render")
    frame_dirs = sorted(
        os.path.join(args.input, d)
        for d in os.listdir(args.input)
        if os.path.isdir(os.path.join(args.input, d))
    )
    if not frame_dirs:
        print(f"No frame directories under {args.input}", file=sys.stderr)
        return 1
    if args.limit:
        frame_dirs = frame_dirs[: args.limit]

    seconds = {"decode": 0.0, "encode": 0.0}
    lock = threading.Lock()

    def timed(key, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        with lock:
            seconds[key] += time.perf_counter() - t0
        return out

    first = timed("decode", loader.load_light_field, frame_dirs[0], progress=False)
    print(
        f"{len(frame_dirs)} frames, {first.cols}x{first.rows} grid of "
        f"{first.width}x{first.height} images"
    )

    def _load(d):
        lf = timed("decode", loader.load_light_field, d, progress=False)
        if (lf.cols, lf.rows, lf.width, lf.height) != (
            first.cols, first.rows, first.width, first.height
        ):
            raise ValueError(f"Frame {d} geometry differs from frame 0")
        return lf.images

    def frames():
        # thunks: with --resume, complete frames are skipped without decoding
        yield first.images
        for d in frame_dirs[1:]:
            yield lambda d=d: _load(d)

    renderer = StreamingRenderer(
        first.cols, first.rows, first.width, first.height, args.trajectory,
        config=RenderConfig(
            method=args.method, focus=args.focus,
            focus_range=args.focus_range, effect=args.effect,
            aspect=args.aspect, focus_map_views=args.focus_views,
            exact_focus_taps=not args.fast_focus,
            focus_map_refresh=args.map_refresh,
        ),
        device=device,
    )
    # the stream's writer pool calls writer.write_views; time each call
    write_views = writer.write_views
    writer.write_views = lambda *a, **k: timed("encode", write_views, *a, **k)
    try:
        stats = renderer.render_to_dir(frames(), args.output, resume=args.resume)
    finally:
        writer.write_views = write_views
    print(
        f"{stats.frames} frames ({stats.rendered} rendered, "
        f"{stats.skipped} skipped) in {stats.total_s:.1f}s "
        f"({stats.fps:.2f} fps)"
    )
    print(json.dumps({
        "frames": stats.frames, "rendered": stats.rendered, "skipped": stats.skipped,
        "total_s": stats.total_s, "fps": stats.fps,
        "decode_s": seconds["decode"], "encode_s": seconds["encode"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
