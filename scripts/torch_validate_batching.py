#!/usr/bin/env python
"""Validate the port's view-batched render arm against the one-pass render,
byte for byte, on the card (or the CPU).

Port of ``scripts/validate_batching.py``. The port's capacity plan
(``core/capacity.plan_render``) has two arms: everything in one pass, or
view batches, each downloaded while the next renders. For fixed-focus TEN
and all-in-focus TEN and STD, the script finds by ``plan_render`` the
largest ``LFI_HBM_BYTES`` budget that still forces view batches, renders
under it and requires the views (and the maps) to be ``np.array_equal`` to
the unbatched render. The original's other arms (dropping the resident
stack, the row-blocked select and estimate) existed for the TPU's operands
and are not arms of the port; the script names them and moves on.

Last line: ``{"batched_arm_failures": n}``; exit 1 when n > 0.

Usage: torch_validate_batching.py [--size HxW] [--grid CxR] [--skip-fixed]
                                  [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

FOCUS, FRANGE = 0.1, 0.2
TRAJECTORY = "0,0,1,1"
TPU_ONLY = {
    "fixed": ["drop"],
    "allfocus": ["drop", "rowblk", "rowblk+est", "rowblk+est-xla", "drop+est"],
}


def largest_batched_budget(g, c, h, w, v, method, focus_views):
    """-> (the largest budget under which ``plan_render`` picks view
    batches, its plan). The arm is monotone in the budget: one pass at and
    above a threshold, view batches below it, a ValueError far below."""
    from lfinterpolator_tpu_torch.core import capacity

    def plan(b):
        return capacity.plan_render(g, c, h, w, v, method=method,
                                    focus_views=focus_views, budget=b)

    lo, hi = 1, 2 * plan(1 << 62).bytes_unbatched + (1 << 30)  # hi: one pass
    while hi - lo > 1:  # invariant: plan(hi) is one pass, plan(lo) is not
        mid = (lo + hi) // 2
        try:
            one_pass = not plan(mid).batched
        except ValueError:
            one_pass = False
        lo, hi = (lo, mid) if one_pass else (mid, hi)
    return lo, plan(lo)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--grid", default="4x4")
    ap.add_argument("--skip-fixed", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    from lfinterpolator_tpu_torch import RenderConfig
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.io import LightField
    from lfinterpolator_tpu_torch.utils import devices, profiling

    device = devices.resolve(args.device, "the batching check")
    print(profiling.card_line(device), flush=True)
    h, w = (int(x) for x in args.size.split("x"))
    cols, rows = (int(x) for x in args.grid.split("x"))
    g, v, k = cols * rows, 64, 8
    rng = np.random.default_rng(11)
    lf = LightField(images=rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8),
                    cols=cols, rows=rows)
    failures = 0

    def render(interp, budget, **kw):
        if budget is not None:
            os.environ["LFI_HBM_BYTES"] = str(budget)
        try:
            t0 = time.perf_counter()
            out = interp.interpolate(TRAJECTORY, progress=False, **kw)
            return out, time.perf_counter() - t0
        finally:
            os.environ.pop("LFI_HBM_BYTES", None)

    cases = [] if args.skip_fixed else [("fixed", "TEN", 0, {"focus": FOCUS})]
    cases += [("allfocus", m, k, {"focus": FOCUS, "focus_range": FRANGE})
              for m in ("TEN", "STD")]
    for kind, method, focus_views, kw in cases:
        tag = f"[{'fixed' if kind == 'fixed' else 'af'} {method}]"
        interp = Interpolator(lf, device=device, progress=False,
                              config=RenderConfig(method=method, view_count=v,
                                                  focus_map_views=k))
        ref, t = render(interp, None, **kw)
        print(f"{tag} unbatched {t:.2f}s", flush=True)
        budget, plan = largest_batched_budget(g, 3, h, w, v, method, focus_views)
        out, t = render(interp, budget, **kw)
        ok_v = np.array_equal(out.views, ref.views)
        ok_m = ref.maps is None or np.array_equal(out.maps, ref.maps)
        batches = -(-v // plan.view_batch)
        print(f"{tag} view batches: LFI_HBM_BYTES={budget} vb={plan.view_batch} "
              f"({batches} batches) {t:.2f}s views_eq={ok_v}"
              + ("" if kind == "fixed" else f" maps_eq={ok_m}"), flush=True)
        failures += 0 if (ok_v and ok_m) else 1
        for arm in TPU_ONLY[kind]:
            print(f"{tag} {arm}: not an arm of the port (TPU only)", flush=True)
        del interp, ref, out
    print(json.dumps({"batched_arm_failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
