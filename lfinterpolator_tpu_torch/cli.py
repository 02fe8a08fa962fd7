"""Command-line interface of the port: the reference's flag surface.

Same flags as ``lfinterpolator_tpu.cli`` (its ``build_parser`` is reused),
plus ``--device`` (default ``cuda``). Runs the fixed-focus render, and with
``-r > 0`` the all-in-focus one (``--focus-views``, ``--fast-focus``),
which also writes ``map0.png``/``map1.png``:

    python -m lfinterpolator_tpu_torch.cli -i scene/ -o out/ -t 0,0,1,1 -m TEN -f 0.1
    python -m lfinterpolator_tpu_torch.cli -i scene/ -o out/ -t 0,0,1,1 -m TEN -f 0.1 -r 0.3

Flags of parts not yet ported (``--focus-pyramid`` with ``-r > 0``, the
``--quilt*`` family) exit 1 with a one-line message naming the ROADMAP
slice that brings them.
"""

from __future__ import annotations

import json
import sys

from lfinterpolator_tpu import cli as _jax_cli

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
--device - torch device to render on: cuda (default) or cpu (plain PyTorch path)
"""


def build_parser():
    p = _jax_cli.build_parser()
    p.prog = "lfi-interpolate-torch"
    p.add_argument("--device", default="cuda")
    return p


def _not_ported(args) -> str | None:
    """The one-line message for a requested part not yet ported, or None."""
    if args.range > 0 and args.focus_pyramid:
        return ("Coarse-to-fine focus estimation (--focus-pyramid) is not yet "
                "ported (ROADMAP slice 2b)")
    if args.quilt or args.quilt_only or args.quilt_tile or args.quilt_reference:
        return "Quilt output (--quilt*) is not yet ported (ROADMAP slice 3)"
    return None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.help:
        print(HELP_TEXT)
        return 0
    if not (args.input and args.trajectory and args.output and args.method):
        print("Missing required parameters. Use -h for help.", file=sys.stderr)
        return 1

    # Deferred so `-h` stays instant (no torch import).
    from lfinterpolator_tpu.core import geometry
    from lfinterpolator_tpu.core.config import RenderConfig

    progress = not args.no_progress and not args.json_out
    try:
        # Validate everything BEFORE the (slow) grid load + device upload.
        config = RenderConfig(
            method=args.method, effect=args.effect, aspect=args.aspect,
            focus_map_views=args.focus_views,
            exact_focus_taps=not args.fast_focus,
        )
        config.validate()
        geometry.parse_trajectory(args.trajectory, (2, 2))  # format check
        message = _not_ported(args)
        if message:
            print(message, file=sys.stderr)
            return 1

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
        result = interp.interpolate(
            args.trajectory,
            focus=args.focus,
            focus_range=args.range,
            benchmark_runs=args.bench_runs,
            progress=progress,
        )
        written = result.save(args.output, progress=progress)
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
