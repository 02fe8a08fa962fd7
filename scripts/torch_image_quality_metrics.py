#!/usr/bin/env python
"""PSNR/SSIM/VMAF of one image pair, with the PyTorch port's codec and
metrics (reference: scripts/imageQualityMetrics.sh).

Port of ``scripts/image_quality_metrics.py``, with ``--device`` as every
script of the port takes it: the metrics are the port's NumPy copy
(``utils/metrics.py``) and run on the host either way; ``--device cuda``
(the default) refuses to run without a card, as the port's entry points do.

Usage: torch_image_quality_metrics.py INPUT REFERENCE [--device cuda|cpu]
Prints: "<psnr_db> <ssim> [<vmaf>]" (ffmpeg-style one-liner). VMAF shells
out to an ffmpeg with libvmaf and is omitted from the line when none is
available.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("input")
    p.add_argument("reference")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from lfinterpolator_tpu_torch.io import codec
    from lfinterpolator_tpu_torch.utils import devices, metrics

    devices.resolve(args.device, "the image metrics")
    a = codec.decode(args.input)[:, :, :3]
    b = codec.decode(args.reference)[:, :, :3]
    line = f"{metrics.psnr(a, b):.6f} {metrics.ssim(a, b):.6f}"
    score = metrics.vmaf(args.input, args.reference)
    if score is not None:
        line += f" {score:.6f}"
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
