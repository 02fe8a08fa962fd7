#!/usr/bin/env python
"""PSNR/SSIM (+VMAF when an ffmpeg with libvmaf is available) for every
same-named image in two directories, with the PyTorch port's codec and
metrics (reference: scripts/compareDirs.sh).

Port of ``scripts/compare_dirs.py``, with ``--device`` as every script of
the port takes it: the metrics are the port's NumPy copy
(``utils/metrics.py``) and run on the host either way; ``--device cuda``
(the default) refuses to run without a card, as the port's entry points do.

Usage: torch_compare_dirs.py DIR_A DIR_B [--json] [--device cuda|cpu]
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dir_a")
    p.add_argument("dir_b")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from lfinterpolator_tpu_torch.io import codec
    from lfinterpolator_tpu_torch.utils import devices, metrics

    devices.resolve(args.device, "the image metrics")
    dir_a, dir_b = args.dir_a, args.dir_b
    names = sorted(set(os.listdir(dir_a)) & set(os.listdir(dir_b)))
    names = [n for n in names if n.lower().endswith((".png", ".jpg", ".jpeg"))]
    if not names:
        print("No matching image filenames.", file=sys.stderr)
        return 1
    use_vmaf = metrics.vmaf_available()
    results = {}
    for n in names:
        pa, pb = os.path.join(dir_a, n), os.path.join(dir_b, n)
        a = codec.decode(pa)[:, :, :3]
        b = codec.decode(pb)[:, :, :3]
        results[n] = metrics.compare_images(a, b)
        if use_vmaf:
            score = metrics.vmaf(pa, pb)
            if score is not None:
                results[n]["vmaf"] = score
        if not args.as_json:
            line = f"{n} {results[n]['psnr']:.4f} {results[n]['ssim']:.6f}"
            if "vmaf" in results[n]:
                line += f" {results[n]['vmaf']:.4f}"
            print(line)
    if args.as_json:
        def enc(v):  # identical pairs give inf PSNR; keep the JSON valid
            return v if math.isfinite(v) else "inf"

        avg_psnr = sum(r["psnr"] for r in results.values()) / len(results)
        avg_ssim = sum(r["ssim"] for r in results.values()) / len(results)
        payload = {
            "files": {n: {k: enc(v) for k, v in r.items()} for n, r in results.items()},
            "avg_psnr": enc(avg_psnr),
            "avg_ssim": enc(avg_ssim),
        }
        vmafs = [r["vmaf"] for r in results.values() if "vmaf" in r]
        if vmafs:
            payload["avg_vmaf"] = enc(sum(vmafs) / len(vmafs))
        print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
