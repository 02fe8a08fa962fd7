"""The Looking Glass quilt in the benchmark: the least time of its fused
blend, and what the quilt's per-layer metrics read of a ``render_quilt``
call in a traced run.

A quilt call is an ``lfi.render_quilt`` event of the program that starts
inside the traced sub-window; its children are the other ``lfi.*`` events
of its thread that start inside it, as ``spans.py`` finds the children of
an ``lfi.interpolate`` call. Where the trace holds no such call, or no
span of the name asked for, a function returns None.
"""

from __future__ import annotations

import bisect
from types import SimpleNamespace

from lfibench import roofline, spans, tracing

CALL = "lfi.render_quilt"


def blend_counts(g: int, cols: int, rows: int, c: int, h: int, w: int) -> tuple[int, int]:
    """(bytes, multiply-adds) of one fused quilt blend of `cols` x `rows`
    native tiles: the u8 stack [G, C, H, W] read and the canvas [C, rows *
    H, cols * W] written once, the float32 weights of the placed views
    [cols * rows, G] and the int32 shifts [G, 2]; a multiply-add per placed
    view, image and canvas byte. The same counts as a fixed blend of
    cols * rows views (``roofline.blend_counts``): the canvas holds the
    views' bytes, each once."""
    return roofline.blend_counts(g, cols * rows, c, h, w)


def blend_bound_s(g: int, cols: int, rows: int, c: int, h: int, w: int) -> float:
    nbytes, macs = blend_counts(g, cols, rows, c, h, w)
    return roofline.bound_s(nbytes, 2 * macs, roofline.FP16_TENSOR_FLOPS)


def calls(trace) -> list[tuple[dict, list[dict]]]:
    """-> [(call, its children)] for each ``lfi.render_quilt`` event that
    starts inside the sub-window."""
    evs = spans.program_spans(trace)
    starts = [float(e["ts"]) for e in evs]
    out = []
    for k, c in enumerate(evs):
        if c["name"] != CALL or not trace.t0 <= starts[k] < trace.t1:
            continue
        inside = evs[bisect.bisect_left(starts, starts[k]):
                     bisect.bisect_left(starts, spans._end(c))]
        out.append((c, [e for e in inside
                        if e is not c and spans._thread(e) == spans._thread(c)]))
    return out


def per_call_ms(trace, name: str) -> float | None:
    """The host time of the spans named `name` inside the quilt calls, over
    the calls, in ms; None without a call or without such a span."""
    cs = calls(trace) if trace is not None else []
    durs = [float(e["dur"]) for _, kids in cs for e in kids if e["name"] == name]
    return sum(durs) / len(cs) / 1e3 if durs else None


def kernel_ms_per_frame(trace, name: str, kernel: str) -> float | None:
    """Device time of the kernels named `kernel` launched inside the spans
    named `name` (``spans.device_ms_per_frame`` over those kernels alone),
    over the frames completed in the sub-window, in ms; None without such a
    span, such a kernel or frames."""
    if trace is None:
        return None
    only = SimpleNamespace(frames=trace.frames, host=trace.host, device=[
        e for e in trace.device if e.get("cat") == "kernel" and tracing._name(e) == kernel])
    return spans.device_ms_per_frame(only, name) or None
