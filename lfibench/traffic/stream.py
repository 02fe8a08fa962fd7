"""A video through ``StreamingRenderer.render_stream``: one renderer of the
configuration's grid, fed frames from a pool of host frames in a cycle
for as long as the window lasts; the stream then drains.

Mix parameters:
  trajectory, focus, prefetch   the renderer's (fixed focus)
  occluder_shifts_px            the pool: the seed's scene with every
                                occluder moved right by each shift, as a
                                video of drifting occluders would show it;
                                pageable host frames, as a decoder gives them
  samples                       answers kept for the check

A frame's latency runs from the moment the traffic hands it to the stream
to the moment its views are yielded. The consumer drops the views.
"""

from __future__ import annotations

import time


def make_scenes(run) -> None:
    run.make_scenes([(0.0, float(s)) for s in run.mix["occluder_shifts_px"]])


def inputs(run):
    """-> the inputs of the i-th frame, as its answer records them."""
    mix, n = run.mix, len(run.mix["occluder_shifts_px"])
    return lambda i: {"frame": i % n, "trajectory": mix["trajectory"],
                      "focus": float(mix["focus"]), "focus_range": 0.0}


def setup(run):
    from lfinterpolator_tpu_torch.streaming import StreamingRenderer

    cfg, mix = run.config, run.mix
    renderer = StreamingRenderer(
        cfg["cols"], cfg["rows"], cfg["width"], cfg["height"], mix["trajectory"],
        config=run.render_config(focus=mix["focus"]), prefetch=int(mix["prefetch"]),
        device=run.device)
    pool = run.scenes
    for _ in renderer.render_stream(pool[i % len(pool)] for i in range(2 * len(pool))):
        pass
    run.prewarm_pinned([(cfg["views"], cfg["height"], cfg["width"], 3)],
                       len(run.samples) + int(mix["prefetch"]) + 2)
    return renderer


def window(run, renderer) -> None:
    pool, frame_inputs = run.scenes, inputs(run)
    handed: list[float] = []

    def frames():
        i = 0
        while run.elapsed() < run.seconds:
            with run.span("lfibench.feed"):
                frame = pool[i % len(pool)]
                handed.append(time.perf_counter())
            yield frame
            i += 1

    run.start()
    j = 0
    try:
        for views in renderer.render_stream(frames()):
            t = time.perf_counter()
            with run.span("lfibench.consume"):
                run.frame(handed[j], t)
                if run.keep(j):
                    run.answers.append({**frame_inputs(j), "views": views, "maps": None})
                del views
            run.trace_step()
            j += 1
    except RuntimeError as e:
        run.fail(e)
    run.attempted = len(handed)
    run.failed = len(handed) - j
