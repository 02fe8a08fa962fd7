"""Command-line interface of the port: the reference's flag surface.

Same flags as ``lfinterpolator_tpu.cli`` (``build_parser`` is the port's own
copy of that parser), plus ``--device`` (default ``cuda``). Runs the fixed-focus render, and with
``-r > 0`` the all-in-focus one (``--focus-views``, ``--fast-focus``,
``--focus-pyramid``), which also writes ``map0.png``/``map1.png``; the
quilt flags add ``quilt.png`` (``--quilt``, ``--quilt-tile HxW``,
``--quilt-reference``) or write only it (``--quilt-only``):

    python -m lfinterpolator_tpu_torch.cli -i scene/ -o out/ -t 0,0,1,1 -m TEN -f 0.1
    python -m lfinterpolator_tpu_torch.cli -i scene/ -o out/ -t 0,0,1,1 -m TEN -f 0.1 -r 0.3
    python -m lfinterpolator_tpu_torch.cli -i scene/ -o out/ -t 0,0,1,1 -m TEN -f 0.1 --quilt-only
"""

from __future__ import annotations

import argparse
import json
import sys

HELP_TEXT = """Usage:
Example: lfi-interpolate-torch -i /MyAmazingMachine/thoseImages -t 0.0,0.0,1.0,1.0 -o ./outputs -m STD
-o - output path
-i - folder with lf grid images - named as column_row.extension, e.g. 01_12.jpg
-t - trajectory of the camera in normalized coordinates of the grid format: startCol,startRow,endCol,endRow
-s - the amount of the spatial 3D effect - affects how much are views close to the virtual one prioritized (default=3.0)
-a - aspect ratio of the spacing of the capturing cameras in the grid (horizontal/vertical space) (default=1)
-m - interpolation method:
     STD - PyTorch ops
     TEN_WM (alias TEN) - hand-written Hopper kernel
The following arguments are normalized offsets of the images in shift & sum
-f - focusing value (default=0)
-r - focusing range (will be added to the focusing value) - will produce all-focused result if used
-b - number of timed benchmark repetitions of the render step (default=0)
--focus-views - views used by the focus search (default=32)
--fast-focus - evaluate the focus search's tap truncation at each tap, not at the center pixel
--focus-pyramid - approximate coarse-to-fine focus search: a half-resolution sweep, then a full-resolution search over each block's nearby candidates (exact taps; the exact sweep runs where the geometry does not take it)
--quilt - also write quilt.png, a 5x9 montage of the first 45 views
--quilt-only - write only quilt.png; a fixed-focus TEN render blends just the 45 placed views, straight into the canvas
--quilt-tile HxW - resize the quilt's tiles to HxW (default: the views' size)
--quilt-reference - write the quilt with 1080x1920 tiles, as scripts/viewsToQuilt.sh does; implies --quilt
--json - print a machine-readable summary line
--device - torch device to render on: cuda (default) or cpu (plain PyTorch path)
"""


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's parser (``lfinterpolator_tpu/cli.py:47-110``): the
    same flags, destinations and defaults, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="lfi-interpolate-torch", add_help=False, usage=argparse.SUPPRESS
    )
    p.add_argument("-h", "--help", action="store_true", dest="help")
    p.add_argument("-i", dest="input")
    p.add_argument("-t", dest="trajectory")
    p.add_argument("-o", dest="output")
    p.add_argument("-m", dest="method")
    p.add_argument("-f", dest="focus", type=float, default=0.0)
    p.add_argument("-r", dest="range", type=float, default=0.0)
    p.add_argument("-s", dest="effect", type=float, default=3.0)
    p.add_argument("-a", dest="aspect", type=float, default=1.0)
    p.add_argument("-b", "--bench-runs", dest="bench_runs", type=int, default=0)
    p.add_argument("--focus-views", dest="focus_views", type=int, default=32)
    p.add_argument("--fast-focus", action="store_true")
    p.add_argument("--focus-pyramid", action="store_true")
    p.add_argument("--reference-order", action="store_true")
    p.add_argument("--quilt", action="store_true")
    p.add_argument("--quilt-only", action="store_true")
    p.add_argument("--quilt-tile", dest="quilt_tile", metavar="HxW", default=None)
    p.add_argument("--quilt-reference", action="store_true")
    p.add_argument("--json", action="store_true", dest="json_out")
    p.add_argument("--no-progress", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.help:
        print(HELP_TEXT)
        return 0
    if not (args.input and args.trajectory and args.output and args.method):
        print("Missing required parameters. Use -h for help.", file=sys.stderr)
        return 1

    # Deferred so `-h` stays instant (no torch import).
    from .core import geometry
    from .core.config import RenderConfig

    progress = not args.no_progress and not args.json_out
    # Validate the quilt geometry BEFORE the render: a bad --quilt-tile
    # fails in milliseconds, not after the load.
    quilt_tile = (1080, 1920) if args.quilt_reference else None
    if args.quilt_tile:
        try:
            th, tw = (int(x) for x in args.quilt_tile.split("x"))
            if th <= 0 or tw <= 0:
                raise ValueError(args.quilt_tile)
        except ValueError:
            print(f"Bad --quilt-tile {args.quilt_tile!r}; expected "
                  "HxW with positive sizes, e.g. 1080x1920", file=sys.stderr)
            return 1
        quilt_tile = (th, tw)
    try:
        # Validate everything BEFORE the (slow) grid load + device upload.
        config = RenderConfig(
            method=args.method, effect=args.effect, aspect=args.aspect,
            focus_map_views=args.focus_views,
            exact_focus_taps=not args.fast_focus,
            focus_pyramid=args.focus_pyramid,
        )
        config.validate()
        geometry.parse_trajectory(args.trajectory, (2, 2))  # format check

        from .api import Interpolator
        from .io import load_light_field

        source = (
            load_light_field(args.input, progress=progress, reference_order=True)
            if args.reference_order
            else args.input
        )
        interp = Interpolator(
            source, config=config, progress=progress, device=args.device
        )
        if args.quilt_only:
            qres = interp.render_quilt(
                args.trajectory,
                focus=args.focus,
                focus_range=args.range,
                tile_size=quilt_tile,
                benchmark_runs=args.bench_runs,
                progress=progress,
            )
            written = [qres.save(f"{args.output}/quilt.png")]
            if args.json_out:
                print(
                    json.dumps(
                        {
                            "quilt": [
                                int(qres.quilt.shape[1]),
                                int(qres.quilt.shape[0]),
                            ],
                            "method": qres.config.method,
                            "fused": qres.fused,
                            "avg_ms": qres.avg_ms,
                            "files_written": len(written),
                        }
                    )
                )
            return 0
        result = interp.interpolate(
            args.trajectory,
            focus=args.focus,
            focus_range=args.range,
            benchmark_runs=args.bench_runs,
            progress=progress,
        )
        written = result.save(args.output, progress=progress)
        if args.quilt or args.quilt_reference or args.quilt_tile:
            if result.views.shape[0] >= 45:
                written.append(result.save_quilt(
                    f"{args.output}/quilt.png", tile_size=quilt_tile
                ))
            else:
                print("Quilt skipped: needs >= 45 views", file=sys.stderr)
        if args.json_out:
            print(
                json.dumps(
                    {
                        "views": int(result.views.shape[0]),
                        "resolution": [
                            int(result.views.shape[2]),
                            int(result.views.shape[1]),
                        ],
                        "method": result.config.method,
                        "avg_ms": result.avg_ms,
                        "megapixels_per_s": result.megapixels_per_s,
                        "files_written": len(written),
                    }
                )
            )
    except (ValueError, FileNotFoundError, NotADirectoryError, RuntimeError) as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `lfi-interpolate-torch -h | head`
        sys.exit(0)
