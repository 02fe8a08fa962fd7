"""Closed-loop quilts for a Looking Glass display, by one caller:
``Interpolator.render_quilt`` on a light field loaded once, each call asked
for when the last returned.

Mix parameters:
  draws                 the calls drawn from the seed, cycled in order: each
                        a horizontal sweep ``0,y,1,y`` across the whole grid
                        at a height y uniform in ``sweep_height_uniform`` (a
                        Looking Glass display shows horizontal parallax
                        only), at a fixed focus uniform in ``focus_uniform``
  samples               answers kept for the check
  allfocus              false: every quilt is at fixed focus (``step_mfu``
                        reads it to take the fixed blend's bound)

Each call renders the configuration's ``views`` at one focus and returns
them as one quilt of ``quilt`` cols x rows native tiles, a host array
[rows * H, cols * W, 3]. A frame's latency runs from the call to its return
with that array; the caller drops each quilt before the next call, except
the sampled ones, which it keeps as they came. Only once the window has
closed does it cut each kept quilt into its views for the check
(``untile``).
"""

from __future__ import annotations

import time

import numpy as np


def untile(canvas: np.ndarray, cols: int, rows: int, h: int, w: int) -> np.ndarray:
    """A quilt [rows * h, cols * w, C] -> its views [cols * rows, h, w, C]:
    view i at tile (i // cols, i % cols), tile rows top to bottom and tiles
    left to right in a row, the order in which ImageMagick's ``montage``
    (the reference tool's scripts/viewsToQuilt.sh) places its inputs. A
    canvas of another shape gives no views, which the check counts as
    wrong."""
    if canvas.ndim != 3 or canvas.shape[:2] != (rows * h, cols * w):
        return np.zeros((0, h, w, 3), np.uint8)
    return np.stack([canvas[r * h:(r + 1) * h, c * w:(c + 1) * w]
                     for r in range(rows) for c in range(cols)])


def _draws(run) -> list[tuple[str, float]]:
    mix = run.mix
    out = []
    for _ in range(int(mix["draws"])):
        y = run.rng.uniform(*mix["sweep_height_uniform"])
        focus = round(float(run.rng.uniform(*mix["focus_uniform"])), 6)
        out.append((f"0,{y:.6f},1,{y:.6f}", focus))
    return out


def make_scenes(run) -> None:
    run.make_scenes([(0.0, 0.0)])


def inputs(run):
    """-> the inputs of the i-th call, as its answer records them (the
    draws of this seed, the same as ``setup`` makes)."""
    draws = _draws(run)
    return lambda i: dict(zip(("trajectory", "focus"), draws[i % len(draws)]),
                          focus_range=0.0, frame=0)


def _quilt(run, interp, c) -> np.ndarray:
    q = run.config["quilt"]
    return interp.render_quilt(c["trajectory"], focus=c["focus"], method=run.config["method"],
                               cols=q["cols"], rows=q["rows"], progress=False).quilt


def setup(run):
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.io import LightField

    cfg = run.config
    lf = LightField(images=run.scenes[0], cols=cfg["cols"], rows=cfg["rows"])
    interp = Interpolator(lf, config=run.render_config(), progress=False, device=run.device)
    call = inputs(run)
    for i in range(3):
        _quilt(run, interp, call(i))
    return interp, call


def window(run, state) -> None:
    interp, call = state
    run.start()
    i = 0
    while run.elapsed() < run.seconds:
        run.trace_step()
        c = call(i)
        canvas = None
        with run.span("lfibench.call"):
            t0 = time.perf_counter()
            try:
                canvas = _quilt(run, interp, c)
            except (RuntimeError, ValueError) as e:
                run.fail(e)
            t1 = time.perf_counter()
        if canvas is not None:
            run.frame(t0, t1)
            if run.keep(i):
                run.answers.append({**c, "canvas": canvas})
        del canvas
        i += 1
    run.attempted = i
    cfg = run.config
    for ans in run.answers:
        ans["views"] = untile(ans.pop("canvas"), cfg["quilt"]["cols"], cfg["quilt"]["rows"],
                              cfg["height"], cfg["width"])
