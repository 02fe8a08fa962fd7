"""Closed-loop calls of the API by one caller: ``Interpolator.interpolate``
on a light field loaded once, each call asked for when the last returned.

Mix parameters:
  draws         the calls drawn from the seed, cycled in order: each a
                trajectory with both endpoints uniform in [0, 1]^2 (so the
                center, the offsets and the focus views change from call to
                call) and a focus
  allfocus      true: every call renders all in focus over the
                configuration's focus window; false: fixed focus, drawn
                uniform in ``focus_uniform``
  samples       answers kept for the check

A frame's latency runs from the call to its return with host arrays (the
views, and all in focus the two maps); the caller drops each result before
the next call.
"""

from __future__ import annotations

import time


def _draws(run) -> list[tuple[str, float, float]]:
    mix, window = run.mix, run.config["allfocus"]
    out = []
    for _ in range(int(mix["draws"])):
        traj = ",".join(f"{x:.6f}" for x in run.rng.uniform(0.0, 1.0, 4))
        if mix["allfocus"]:
            out.append((traj, float(window["focus"]), float(window["focus_range"])))
        else:
            lo, hi = mix["focus_uniform"]
            out.append((traj, round(float(run.rng.uniform(lo, hi)), 6), 0.0))
    return out


def make_scenes(run) -> None:
    run.make_scenes([(0.0, 0.0)])


def inputs(run):
    """-> the inputs of the i-th call, as its answer records them (the
    draws of this seed, the same as ``setup`` makes)."""
    draws = _draws(run)
    return lambda i: dict(zip(("trajectory", "focus", "focus_range"), draws[i % len(draws)]),
                          frame=0)


def setup(run):
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.io import LightField

    cfg = run.config
    lf = LightField(images=run.scenes[0], cols=cfg["cols"], rows=cfg["rows"])
    interp = Interpolator(lf, config=run.render_config(), progress=False, device=run.device)
    call = inputs(run)
    for i in range(3):
        c = call(i)
        interp.interpolate(c["trajectory"], focus=c["focus"], focus_range=c["focus_range"],
                           method=cfg["method"], progress=False)
    h, w = cfg["height"], cfg["width"]
    shapes = [(cfg["views"], h, w, 3)] + ([(2, h, w)] if run.mix["allfocus"] else [])
    run.prewarm_pinned(shapes, len(run.samples) + 1)
    return interp, call


def window(run, state) -> None:
    interp, call = state
    method = run.config["method"]
    run.start()
    i = 0
    while run.elapsed() < run.seconds:
        run.trace_step()
        c = call(i)
        res = None
        with run.span("lfibench.call"):
            t0 = time.perf_counter()
            try:
                res = interp.interpolate(c["trajectory"], focus=c["focus"],
                                         focus_range=c["focus_range"], method=method,
                                         progress=False)
            except (RuntimeError, ValueError) as e:
                run.fail(e)
            t1 = time.perf_counter()
        if res is not None:
            run.frame(t0, t1)
            if run.keep(i):
                run.answers.append({**c, "views": res.views, "maps": res.maps})
        del res
        i += 1
    run.attempted = i
