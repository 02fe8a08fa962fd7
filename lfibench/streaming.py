"""The light-field video in the benchmark: what the stream's per-layer
metrics read of ``StreamingRenderer.render_stream`` in a traced run.

The program marks the stream's parts with ``lfi.stream.*`` spans
(``lfinterpolator_tpu_torch/streaming.py``): ``lfi.stream.feed`` on its
decode thread (a host frame into its pinned buffer), ``lfi.stream.take``
(the wait for that frame and its planar copy's enqueue), ``lfi.stream.frame``
(the render and the download's start) and ``lfi.stream.drain`` (the wait
for the oldest frame's download) on the render loop's. A reader takes the
spans of one name that start inside the traced sub-window, on whatever
thread, and divides their host time by the frames completed in the
sub-window. Where the trace holds no such span (a program without them) or
no frame, it reads None, not 0.
"""

from __future__ import annotations


def per_frame_ms(trace, name: str) -> float | None:
    """The host time of the spans named `name` that start inside the
    sub-window, over the frames completed in it, in ms; None without a
    frame or without such a span."""
    if trace is None or not trace.frames:
        return None
    durs = [float(e["dur"]) for e in trace.spans(name) if trace.t0 <= float(e["ts"]) < trace.t1]
    return sum(durs) / trace.frames / 1e3 if durs else None
