#!/usr/bin/env python
"""Assemble a directory of views into a Looking Glass quilt with the
PyTorch port (reference: scripts/viewsToQuilt.sh -- 5x9 montage of
1920x1080 tiles).

Port of ``scripts/views_to_quilt.py``, with ``--device``: the tiles are
resized (``--tile WxH``, ``ops/quilt_torch.resize_tiles``) and copied into
the canvas (``ops/quilt.assemble_quilt``; the tile-copy kernel on the card)
on that device.

Usage: torch_views_to_quilt.py VIEW_DIR [OUT.png] [--cols 5] [--rows 9]
       [--tile WxH] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("view_dir")
    p.add_argument("out", nargs="?", default=None)
    p.add_argument("--cols", type=int, default=5)
    p.add_argument("--rows", type=int, default=9)
    p.add_argument("--tile", default=None, help="WxH per-tile resize (e.g. 1920x1080)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu (the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)

    import torch

    from lfinterpolator_tpu_torch.io import codec, writer
    from lfinterpolator_tpu_torch.ops import quilt, quilt_torch
    from lfinterpolator_tpu_torch.utils import devices

    device = devices.resolve(args.device, "the quilt")
    names = sorted(
        n for n in os.listdir(args.view_dir)
        if n.lower().endswith(".png") and not n.startswith(("map", "quilt"))
    )
    need = args.cols * args.rows
    if len(names) < need:
        print(f"Need {need} views, found {len(names)}", file=sys.stderr)
        return 1
    views = np.stack(
        [codec.decode(os.path.join(args.view_dir, n))[:, :, :3] for n in names[:need]]
    )
    tile_size = None
    if args.tile:
        w, h = (int(x) for x in args.tile.lower().split("x"))
        tile_size = (h, w)
    q = quilt.assemble_quilt(
        torch.from_numpy(np.ascontiguousarray(np.transpose(views, (0, 3, 1, 2)))).to(device),
        cols=args.cols, rows=args.rows, tile_size=tile_size,
    )
    out = args.out or os.path.join(args.view_dir, "quilt.png")
    writer.write_quilt(out, quilt_torch.to_hwc(q).cpu().numpy())
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
