#!/usr/bin/env python
"""Quality gate of the PyTorch port: PSNR of every render path against the
NumPy oracle.

Port of ``scripts/quality_gate.py``: the same scenes (a textured plane, or
the parallax-occlusion scene of ``utils/scenes.py``), the same parameters
(16 views, focus 0.1, range 0.4, 32 candidates, K = min(32, G) focus views,
filter radius = stencil radius // 10) and the same 45 dB threshold, rendered
through the port's entry points on a ``LightField`` (``Interpolator``,
``render_quilt``, ``StreamingRenderer``) and held against the port's copy of
the oracle (``ops/reference.py``):

  fixed/{STD,TEN}          fixed focus            reference.blend_fixed       gated
  allfocus/{STD,TEN}       all in focus           reference.blend_allfocus on
                                                  the oracle's map1 (STD) or
                                                  map0 (TEN)                  gated
  allfocus-fast/{STD,TEN}  --fast-focus           the same oracle renders     informational
  quilt/TEN                render_quilt (fused),  the 5x9 montage of
                           45 views               blend_fixed's 45 views      gated
  stream/{fixed,allfocus}  one StreamingRenderer  the fixed and the TEN
                           frame (TEN)            all-focus oracle renders    gated
  pyramid/TEN              --focus-pyramid        blend_allfocus on the
                                                  oracle's exact map0         informational

The pyramid row runs only where the pyramid does (a width of at least 512;
below it the exact sweep runs and the row would repeat allfocus/TEN).

Prints one JSON line: ``psnr_db`` by row ("inf" for identical renders),
``threshold_db``, ``pass`` (every gated row at or above the threshold), and
what the rows need to be read: the informational rows and why, whether the
port's maps equal the oracle's, the share of the pyramid's map bytes that
differ from the exact sweep, the kernel launches of the run
(``launches``) and of its streamed frames alone (``stream_launches``). Exit
0 only when the gate passes.

Usage: torch_quality_gate.py [--size HxW] [--grid CxR] [--threshold-db 45]
                             [--scene plane|occlusion] [--device cuda|cpu]
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

TRAJECTORY = "0,0,1,1"
VIEWS, FOCUS, FRANGE, STEPS = 16, 0.1, 0.4, 32
QUILT_COLS, QUILT_ROWS = 5, 9
PYRAMID_MIN_WIDTH = 512
INFORMATIONAL = {
    "allfocus-fast/STD": "the fast tap rule (--fast-focus) is a documented "
                         "approximation of the exact estimate; the JAX package "
                         "read 44.3 dB on the plane scene (PARITY.md:421)",
    "allfocus-fast/TEN": "as allfocus-fast/STD",
    "pyramid/TEN": "--focus-pyramid is a documented approximate mode: a pixel "
                   "whose best candidate lies outside its block's coarse "
                   "window takes the best one scanned",
}


def make_scene(rng, cols, rows, h, w):
    """Textured plane with per-camera disparity (structured, not noise)."""
    tex = rng.integers(0, 256, size=(h * 2, w * 2, 3), dtype=np.uint8)
    t = tex.astype(np.float32)
    t = (t + np.roll(t, 1, 0) + np.roll(t, 1, 1) + np.roll(t, 2, 0)) / 4.0
    tex = t.astype(np.uint8)
    images = np.zeros((cols * rows, h, w, 4), dtype=np.uint8)
    for c in range(cols):
        for r in range(rows):
            images[c * rows + r, :, :, :3] = tex[r * 2 : r * 2 + h, c * 2 : c * 2 + w]
            images[c * rows + r, :, :, 3] = 255
    return images


def scene_images(scene: str, cols: int, rows: int, h: int, w: int) -> np.ndarray:
    """The gate's scene, seeded as the original builds it."""
    rng = np.random.default_rng(99)
    if scene == "occlusion":
        from lfinterpolator_tpu_torch.utils.scenes import (
            make_occlusion_scene, occlusion_foci,
        )

        # layer foci on the gate sweep's candidate grid
        return make_occlusion_scene(
            cols, rows, h, w, plane_foci=occlusion_foci(FOCUS, FRANGE, STEPS), seed=99,
        )
    return make_scene(rng, cols, rows, h, w)


def quilt_montage(views: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """[cols*rows, h, w, 3] -> [rows*h, cols*w, 3], view i at cell
    (i // cols, i % cols)."""
    _, h, w, c = views.shape
    return (views[:cols * rows].reshape(rows, cols, h, w, c).transpose(0, 2, 1, 3, 4)
            .reshape(rows * h, cols * w, c))


def run_gate(size=(192, 256), grid=(6, 6), scene="plane", device="cuda",
             threshold_db=45.0) -> dict:
    """Render every row and score it; -> the JSON payload (module docstring)."""
    from lfinterpolator_tpu_torch import RenderConfig, StreamingRenderer, state
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.core import geometry
    from lfinterpolator_tpu_torch.io import LightField
    from lfinterpolator_tpu_torch.ops import reference as oracle
    from lfinterpolator_tpu_torch.utils import devices, metrics, profiling

    device = devices.resolve(device, "the quality gate")
    h, w = size
    cols, rows = grid
    images = scene_images(scene, cols, rows, h, w)
    lf = LightField(images=images, cols=cols, rows=rows)
    k = min(32, cols * rows)
    cfg = RenderConfig(view_count=VIEWS, focus_map_views=k, focus_steps=STEPS)

    se = geometry.parse_trajectory(TRAJECTORY, (cols, rows))
    wm = geometry.quantize_weights_f16(geometry.weight_matrix(se, cols, rows, 3.0, VIEWS))
    offsets = geometry.compute_offsets(cols, rows, w, h, 1.0, geometry.trajectory_center(se))
    radius = geometry.block_radius(w, h)
    frad = (radius[0] // 10, radius[1] // 10)
    ids = geometry.select_focus_views(se, cols, rows, k)
    fo = geometry.focused_offsets(offsets, FOCUS)

    def render(config=cfg, **kw):
        interp = Interpolator(lf, config=config, device=device, progress=False)
        return interp.interpolate(TRAJECTORY, focus=FOCUS, progress=False, **kw)

    profiling.reset_launch_counts()
    results, maps_exact = {}, {}

    # fixed focus, both methods
    want_fixed = oracle.blend_fixed(images, wm, fo)
    for method in ("STD", "TEN"):
        results[f"fixed/{method}"] = metrics.psnr(render(method=method).views, want_fixed)

    # all in focus, both methods, exact and fast tap rule (oracle maps + blends)
    map0 = oracle.focus_map_estimate(images, offsets, ids, FOCUS, FRANGE, radius, steps=STEPS)
    map1 = oracle.focus_map_filter(map0, frad)
    want = {"STD": oracle.blend_allfocus(images, wm, offsets, map1, FOCUS, FRANGE),
            "TEN": oracle.blend_allfocus(images, wm, offsets, map0, FOCUS, FRANGE)}
    for prefix, exact in (("allfocus", True), ("allfocus-fast", False)):
        for method in ("STD", "TEN"):
            res = render(dataclasses.replace(cfg, exact_focus_taps=exact),
                         method=method, focus_range=FRANGE)
            results[f"{prefix}/{method}"] = metrics.psnr(res.views, want[method])
            if exact:
                maps_exact[method] = bool(np.array_equal(res.maps[0], map0)
                                          and np.array_equal(res.maps[1], map1))

    # the fused quilt of its own 45-row weight matrix
    n = QUILT_COLS * QUILT_ROWS
    q = Interpolator(lf, config=dataclasses.replace(cfg, view_count=n), device=device,
                     progress=False).render_quilt(
        TRAJECTORY, focus=FOCUS, method="TEN", cols=QUILT_COLS, rows=QUILT_ROWS,
        progress=False)
    if not q.fused:
        raise AssertionError("render_quilt took the two-stage route for a fixed TEN quilt")
    wm_quilt = geometry.quantize_weights_f16(geometry.weight_matrix(se, cols, rows, 3.0, n))
    results["quilt/TEN"] = metrics.psnr(
        q.quilt, quilt_montage(oracle.blend_fixed(images, wm_quilt, fo), QUILT_COLS, QUILT_ROWS))

    # one streamed frame, fixed and all in focus, their launches counted apart
    before = profiling.launch_counts()
    for name, extra, want_stream in (("fixed", {}, want_fixed),
                                     ("allfocus", {"focus_range": FRANGE}, want["TEN"])):
        sr = StreamingRenderer(cols, rows, w, h, TRAJECTORY, device=device,
                               config=dataclasses.replace(cfg, method="TEN", focus=FOCUS,
                                                          **extra))
        out = next(iter(sr.render_stream([images])))
        views = out[0] if extra else out
        results[f"stream/{name}"] = metrics.psnr(views, want_stream)
    stream_launches = profiling.launch_counts() - before

    # the coarse-to-fine estimate, where the geometry runs it
    payload_extra = {}
    pyr_cfg = dataclasses.replace(cfg, focus_pyramid=True)
    pyramid = state.allfocus_params(TRAJECTORY, cols=cols, rows=rows, height=h, width=w,
                                    config=dataclasses.replace(pyr_cfg, focus=FOCUS,
                                                               focus_range=FRANGE)).pyramid
    if pyramid is not None:
        res = render(pyr_cfg, method="TEN", focus_range=FRANGE)
        results["pyramid/TEN"] = metrics.psnr(res.views, want["TEN"])
        payload_extra["pyramid_map_bytes_differ"] = float(np.mean(res.maps[0] != map0))
    else:
        payload_extra["pyramid_not_run"] = (
            f"the pyramid needs a width of at least {PYRAMID_MIN_WIDTH}; at {w} the "
            "exact sweep runs, which allfocus/TEN gates")

    gated = [k_ for k_ in results if k_ not in INFORMATIONAL]
    ok = all(results[k_] >= threshold_db for k_ in gated)
    return {
        "psnr_db": {k_: (round(v, 2) if np.isfinite(v) else "inf")
                    for k_, v in results.items()},
        "threshold_db": threshold_db,
        "pass": ok,
        "scene": scene,
        "size": f"{h}x{w}",
        "grid": f"{cols}x{rows}",
        "device": profiling.card_line(device),
        "gated": gated,
        "informational": {k_: INFORMATIONAL[k_] for k_ in results if k_ in INFORMATIONAL},
        "maps_equal_oracle": maps_exact,
        **payload_extra,
        "launches": profiling.launch_counts(),
        "stream_launches": stream_launches,
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", default="192x256")
    p.add_argument("--grid", default="6x6")
    p.add_argument("--threshold-db", type=float, default=45.0)
    p.add_argument(
        "--scene", choices=("plane", "occlusion"), default="plane",
        help="'plane': textured plane with per-camera disparity; "
             "'occlusion': parallax-occlusion scene (foreground occluders "
             "at distinct disparities over a background plane, "
             "utils/scenes.py) -- the content class the reference's real "
             "captured scenes exercise",
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu (the plain "
                        "PyTorch path)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    h, w = (int(x) for x in args.size.lower().split("x"))
    cols, rows = (int(x) for x in args.grid.lower().split("x"))
    payload = run_gate((h, w), (cols, rows), args.scene, args.device, args.threshold_db)
    print(json.dumps(payload))
    return 0 if payload["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
