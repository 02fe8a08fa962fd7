"""A light-field video all in focus through ``StreamingRenderer.render_stream``:
one renderer of the configuration's grid, every frame estimated (map
refresh 1), fed frames from a pool of host frames in a cycle for as long
as the window lasts; the stream then drains.

Mix parameters:
  trajectory, prefetch          the renderer's
  focus_map_refresh             1: every frame's maps are its own
  allfocus                      true: each frame is rendered all in focus
                                over the configuration's focus window
                                (``step_mfu`` counts the estimate)
  occluder_shifts_px            the pool: the seed's scene with every
                                occluder moved right by each shift, as a
                                video of drifting occluders would show it;
                                pageable host frames, as a decoder gives them
  samples                       answers kept for the check, each with the
                                frame's views and maps

A frame's latency runs from the moment the traffic hands it to the stream
to the moment its views and maps are yielded. The consumer drops them,
except the sampled ones, which it keeps as they came.
"""

from __future__ import annotations

import time

# the pool of the fixed-focus stream: one scene per occluder shift
from lfibench.traffic.stream import make_scenes  # noqa: F401


def inputs(run):
    """-> the inputs of the i-th frame, as its answer records them."""
    mix, window = run.mix, run.config["allfocus"]
    n = len(mix["occluder_shifts_px"])
    return lambda i: {"frame": i % n, "trajectory": mix["trajectory"],
                      "focus": float(window["focus"]),
                      "focus_range": float(window["focus_range"])}


def setup(run):
    from lfinterpolator_tpu_torch.streaming import StreamingRenderer

    cfg, mix, window = run.config, run.mix, run.config["allfocus"]
    renderer = StreamingRenderer(
        cfg["cols"], cfg["rows"], cfg["width"], cfg["height"], mix["trajectory"],
        config=run.render_config(focus=window["focus"], focus_range=window["focus_range"],
                                 focus_map_refresh=int(mix["focus_map_refresh"])),
        prefetch=int(mix["prefetch"]), device=run.device)
    pool = run.scenes
    for _ in renderer.render_stream(pool[i % len(pool)] for i in range(2 * len(pool))):
        pass
    h, w = cfg["height"], cfg["width"]
    run.prewarm_pinned([(cfg["views"], h, w, 3), (2, h, w)],
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
        for views, maps in renderer.render_stream(frames()):
            t = time.perf_counter()
            with run.span("lfibench.consume"):
                run.frame(handed[j], t)
                if run.keep(j):
                    run.answers.append({**frame_inputs(j), "views": views, "maps": maps})
                del views, maps
            run.trace_step()
            j += 1
    except RuntimeError as e:
        run.fail(e)
    run.attempted = len(handed)
    run.failed = len(handed) - j
