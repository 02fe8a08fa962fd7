#!/usr/bin/env python3
"""The control of the benchmark's check: the plain reference put in the
program's place, a precision below the configuration's, held to the same
comparison as a run's answers. It has to come out as not correct.

    python3 lfibench/control.py --workload <cell> --seeds 1,2,3 [--rehearse]

The configurations state fp16 weights (the original stores each weight as
IEEE half) over u8 pixels with float32 sums, and float32 coordinates and
filter means, so the control rounds the weights to fp8 (e4m3), the step
below fp16, and computes the coordinates and the filter's mean in bfloat16,
the step below float32 (the search's min/max and sums are integers).
For each seed it draws the same answers a run of the cell keeps (the same
frames of the same traffic) and prints one line: the numbers it compared,
summed over those answers, beside the cell's limits. The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lfibench import run as harness  # noqa: E402


def readings(workload: str, seed: int, rehearse: bool = False,
             weights: str = "float8_e4m3fn", arithmetic: str = "bfloat16") -> dict:
    """-> {number: the control's total over the answers a run of `seed`
    keeps}."""
    import torch
    from lfibench.reference import render

    bench, cell, config, mix, gen, device = harness.open_cell(workload, rehearse)
    run = harness.Run(config, mix, seed % 2 ** 63, bench["run_seconds"], device)
    gen.make_scenes(run)
    call = gen.inputs(run)
    totals: dict[str, int] = {}
    for i in sorted(run.samples):
        a = call(i)
        planar = (torch.from_numpy(run.scenes[a["frame"]]).to(device)
                  .permute(0, 3, 1, 2).contiguous())
        ref = render.render(config, planar, a["trajectory"], a["focus"], a["focus_range"])
        low = render.render(config, planar, a["trajectory"], a["focus"], a["focus_range"],
                            weights_dtype=getattr(torch, weights),
                            fdt=getattr(torch, arithmetic))
        for k, v in render.compare(ref, render.blend_bytes(low), low.get("maps")).items():
            totals[k] = totals.get(k, 0) + v
    return totals


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--weights", default="float8_e4m3fn")
    p.add_argument("--arithmetic", default="bfloat16")
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    limits = harness.load_json(os.path.join(
        harness.BENCH_DIR, "traffic",
        f"{harness.open_cell(args.workload, args.rehearse)[1]['traffic']}.json"))["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(args.workload, seed, args.rehearse, args.weights, args.arithmetic)
        print(json.dumps({"workload": args.workload, "seed": seed, "weights": args.weights,
                          "arithmetic": args.arithmetic,
                          "control": got, "limits": limits,
                          "fails": any(got[k] > limits[k] for k in limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
