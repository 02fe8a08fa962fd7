"""Quick check and timing of the port's focus-estimate kernels on one NVIDIA GPU.

    python3 scripts/torch_focus_check.py [--no-time]

Builds lfinterpolator_tpu_torch/csrc/, prints ptxas's report of the two
estimate kernels (they must not spill), then:

  * small scenes (odd sizes, every row and column dirty, a frame narrower
    than the radius, radius 0, K = 1 and 256, 2 and 256 candidates, several
    chunks of candidates): the map pass against focus_torch.cheby_map, both
    tap rules against the plain estimate, the exact rule with every flag
    cleared (the nine-tap loop alone) against the flagged kernel, and the
    presence-predicated instantiation against its plain version; all
    torch.equal;
  * the headline estimate (8x8 grid, 1080x1920, K = 32 views, 32 candidates,
    radius (20, 10)) on a seeded random stack: both rules against the plain
    version (torch.equal), then CUDA-event times of the whole estimate
    (exact, fast, predicated at density ~0.5), of its parts
    (focus_estimate.pass_times: RGBx copy, clean flags, map pass, argmin
    pass, the nine-tap loop alone) and the share of (candidate, pixel)
    pairs on the nine-tap loop, at focus 0.1 and at the focus of a small
    sweep where that share is largest.

A shorter loop than chip_smoke.py while working on the kernels; exits
non-zero on the first failure.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lfinterpolator_tpu_torch import RenderConfig, state  # noqa: E402
from lfinterpolator_tpu_torch.ops import _build, focus_estimate, focus_torch  # noqa: E402
from lfinterpolator_tpu_torch.ops.estimate_geometry import FocusTables, Pyramid  # noqa: E402
from lfinterpolator_tpu_torch.state import focus_tables  # noqa: E402
from lfinterpolator_tpu_torch.utils.profiling import event_ms  # noqa: E402

DEV = "cuda"
H, W = 1080, 1920


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)


def tables_on(focus, frange, steps):
    return FocusTables(*(t(a) for a in focus_tables(focus, frange, steps)))


def equal(name, got, want):
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} of {got.numel()} bytes differ")


def check_small():
    # (K, H, W, steps, focus, range, (rx, ry), offset reach in pixels)
    cases = [
        (5, 37, 53, 6, 0.1, 0.4, (4, 2), 20),
        (8, 48, 64, 8, -0.4, 0.6, (4, 2), 30),
        (6, 24, 40, 5, 1.5, 2.0, (6, 3), 40),  # taps far past every border
        (12, 24, 40, 5, 1.0, 0.5, (6, 3), 40),  # views every few pixels: all dirty
        (3, 9, 7, 4, 0.2, 0.5, (10, 12), 8),  # narrower than the radius, 2 chunks
        (4, 20, 30, 5, 0.1, 0.3, (0, 0), 20),
        (1, 21, 33, 4, 0.2, 0.3, (2, 2), 20),
        (256, 6, 10, 3, 0.2, 0.5, (2, 2), 10),
        (3, 33, 70, 2, -0.1, 0.6, (3, 1), 25),
        (2, 17, 45, 256, 0.0, 2.0, (30, 4), 30),  # 256 candidates in chunks
        (32, 33, 47, 33, 0.1, 0.3, (2, 2), 60),
    ]
    for n, (k, h, w, steps, focus, frange, radius, reach) in enumerate(cases):
        rng = np.random.default_rng(n)
        selected = t(rng.integers(0, 256, (k, 3, h, w), dtype=np.uint8))
        offsets = t(((rng.random((k, 2)) - 0.5) * 2 * reach).astype(np.float32))
        tables = tables_on(focus, frange, steps)
        args = (selected, offsets, tables, radius)
        name = f"K={k} {h}x{w} S={steps} radius {radius}"
        equal(f"rgbx {name}", focus_estimate.rgbx(selected),
              focus_estimate.rgbx_reference(selected))
        maps = focus_estimate.cheby_maps(*args)
        want = torch.stack([focus_torch.cheby_map(selected, offsets, f, radius)
                            for f in tables.candidates])
        equal(f"cheby_maps {name}", maps, want)
        for exact in (True, False):
            equal(f"focus_estimate {name} exact={exact}",
                  focus_estimate.focus_estimate(*args, exact),
                  focus_torch.estimate_focus_map(*args, exact))
        rows, cols = focus_torch.clean_flags(offsets, tables, radius, h, w)
        dirty = (torch.zeros_like(rows), torch.zeros_like(cols))
        equal(f"nine-tap loop alone {name}",
              focus_estimate.focus_estimate_flagged(*args, dirty),
              focus_estimate.focus_estimate(*args))
        share = focus_torch.slow_share(rows, cols)
        chunk = focus_estimate.map_chunk(h, w, radius, steps)
        # the predicated instantiation on an 8 x 32 grain, random words
        sc = 4 if steps % 4 == 0 else 1
        plan = Pyramid(scale=2, refine=1, radius_c=(1, 1), tb=8, wco=32, sc=sc,
                       nb=-(-h // 8), n_wc=-(-w // 32))
        pres = t(rng.integers(0, 2**sc, (plan.nb, plan.n_wc, -(-steps // sc)),
                              dtype=np.int32))
        equal(f"predicated {name}",
              focus_estimate.focus_estimate(*args, True, pres, plan),
              focus_torch.estimate_presence(*args, pres, plan))
        print(f"{name}: maps, both rules, the nine-tap loop alone and the predicated "
              f"estimate == plain (slow share {share:.3f}, {chunk} candidates a chunk)",
              flush=True)


def headline(focus, frange=0.3):
    p = state.allfocus_params("0,0,1,1", cols=8, rows=8, height=H, width=W,
                              config=RenderConfig(focus=focus, focus_range=frange,
                                                  focus_pyramid=True))
    _, offsets, ids, tables = state.upload_allfocus(p, DEV)
    return p, offsets[ids], tables


def slow_share(p) -> float:
    """The share of (candidate, pixel) pairs on the nine-tap loop, on the CPU."""
    tables = FocusTables(*(torch.from_numpy(a) for a in p.tables))
    return focus_torch.slow_share(*focus_torch.clean_flags(
        torch.from_numpy(p.offsets[p.focus_ids]), tables, p.radius, H, W))


def time_headline(smi):
    rng = np.random.default_rng(0)
    selected = t(rng.integers(0, 256, (32, 3, H, W), dtype=np.uint8))
    sweep = {f: slow_share(headline(f)[0]) for f in (-0.6, -0.3, -0.15, 0.0, 0.1, 0.3)}
    worst = max(sweep, key=sweep.get)
    print("slow share by focus (range 0.3): "
          + ", ".join(f"{f}: {s:.4f}" for f, s in sweep.items()), flush=True)
    for focus in (0.1, worst):
        p, offsets, tables = headline(focus)
        args = (selected, offsets, tables, p.radius)
        for exact in (True, False):
            equal(f"headline focus {focus} exact={exact}",
                  focus_estimate.focus_estimate(*args, exact),
                  focus_torch.estimate_focus_map(*args, exact))
        plan = p.pyramid
        pres = t(rng.integers(0, 2**plan.sc, (plan.nb, plan.n_wc, 32 // plan.sc),
                              dtype=np.int32))
        equal(f"headline focus {focus} predicated",
              focus_estimate.focus_estimate(*args, True, pres, plan),
              focus_torch.estimate_presence(*args, pres, plan))
        for _ in range(2):
            whole = {
                "exact": event_ms(lambda: focus_estimate.focus_estimate(*args, True), runs=5),
                "fast": event_ms(lambda: focus_estimate.focus_estimate(*args, False), runs=5),
                "predicated (density ~0.5)": event_ms(
                    lambda: focus_estimate.focus_estimate(*args, True, pres, plan), runs=5),
            }
            parts = focus_estimate.pass_times(*args, True)
            fast = focus_estimate.pass_times(*args, False)
            print(f"headline K=32 S=32 radius {p.radius} focus {focus} ({smi}): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in whole.items())
                  + f"; parts (exact) {parts}; parts (fast) {fast}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_focus_check: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(force=True)
    lines = _build.build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and ("cheby_map" in line or "argmin" in line):
            print("\n".join(lines[i:i + 4]))
    spills = {k: v for k, v in _build.spills().items() if "cheby_map" in k or "argmin" in k}
    print(f"spill bytes {spills}", flush=True)
    if len(spills) != 4 or any(_build.spills().values()):
        raise AssertionError(f"an estimate kernel spills (or is missing): {spills}")
    check_small()
    if "--no-time" not in sys.argv[1:]:
        time_headline(smi)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
