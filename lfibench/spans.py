"""The program's own spans in a traced run, and what the per-layer metrics
of the API, the download and the estimate read from them.

The program marks its layers with ``lfi.*`` regions
(``lfinterpolator_tpu_torch/utils/profiling.span``), which the profiler
holds as ``user_annotation`` events on the clock of the kernels and copies.
A call is an ``lfi.interpolate`` event that starts inside the traced
sub-window; its children are the other ``lfi.*`` events of its thread that
start inside it (they nest by time). Idle time is taken after the device's
events are put on the host's clock (``clock_lead``). Where the trace holds
no call, or no span of the name asked for, a function returns None: a
program without spans reads as nothing, not as 0.

    python3 lfibench/spans.py [lfibench/out/trace.json]

prints the sub-window's idle time of the device, in seconds, summed by the
innermost ``lfi.*`` span the calling thread was in (``idle_by_span``).
"""

from __future__ import annotations

import bisect
import json
import os
import sys

CALL = "lfi.interpolate"
PREFIX = "lfi."
#: ``idle_by_span``'s keys for idle time in no span of the program, and
#: inside a call but in none of its children.
OUTSIDE, SELF = "outside lfi.interpolate", "lfi.interpolate (self)"
LAUNCHES = ("cuda_runtime", "cuda_driver")
#: About the stretch of device time over which ``clock_lead`` takes one
#: reading: each holds many calls, some launched on an idle device.
ALIGN_BIN_US = 100_000.0


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e["dur"])


def _thread(e: dict) -> tuple:
    return e.get("pid"), e.get("tid")


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs, ys) -> float:
    """The length common to two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def program_spans(trace) -> list[dict]:
    """Every ``lfi.*`` region of the trace, in order of start."""
    return sorted((e for e in trace.host if e.get("cat") == "user_annotation"
                   and e["name"].startswith(PREFIX)), key=lambda e: float(e["ts"]))


def calls(trace) -> list[tuple[dict, list[dict]]]:
    """-> [(call, its children)] for each ``lfi.interpolate`` event that
    starts inside the sub-window."""
    evs = program_spans(trace)
    starts = [float(e["ts"]) for e in evs]
    out = []
    for k, c in enumerate(evs):
        if c["name"] != CALL or not trace.t0 <= starts[k] < trace.t1:
            continue
        inside = evs[bisect.bisect_left(starts, starts[k]):bisect.bisect_left(starts, _end(c))]
        out.append((c, [e for e in inside if e is not c and _thread(e) == _thread(c)]))
    return out


def per_call_ms(trace, name: str) -> float | None:
    """The host time of the spans named `name` inside the calls, over the
    calls, in ms; None without a call or without such a span."""
    cs = calls(trace) if trace is not None else []
    durs = [float(e["dur"]) for _, kids in cs for e in kids if e["name"] == name]
    return sum(durs) / len(cs) / 1e3 if durs else None


def self_ms(trace) -> float | None:
    """A call's duration less what its children cover, over the calls, in
    ms; None without a call."""
    cs = calls(trace) if trace is not None else []
    if not cs:
        return None
    total = 0.0
    for c, kids in cs:
        covered = _union((float(e["ts"]), min(_end(e), _end(c))) for e in kids)
        total += float(c["dur"]) - sum(b - a for a, b in covered)
    return total / len(cs) / 1e3


def device_ms_per_frame(trace, name: str) -> float | None:
    """Device time of the kernels launched inside the spans named `name`
    (a launch on the span's thread while it is open, tied to its kernel by
    the trace's ``correlation`` argument), over the frames completed in
    the sub-window, in ms; None without such a span or without frames."""
    if trace is None or not trace.frames:
        return None
    spans = [e for e in program_spans(trace) if e["name"] == name]
    if not spans:
        return None
    open_: dict[tuple, list[tuple[float, float]]] = {}
    for e in spans:
        open_.setdefault(_thread(e), []).append((float(e["ts"]), _end(e)))
    open_ = {th: _union(iv) for th, iv in open_.items()}
    ids = set()
    for e in trace.host:
        if e.get("cat") not in LAUNCHES or "correlation" not in e.get("args", {}):
            continue
        t, iv = float(e["ts"]), open_.get(_thread(e), [])
        k = bisect.bisect_right(iv, (t, float("inf"))) - 1
        if k >= 0 and t < iv[k][1]:
            ids.add(e["args"]["correlation"])
    us = sum(float(k["dur"]) for k in trace.device
             if k.get("cat") == "kernel" and k.get("args", {}).get("correlation") in ids)
    return us / trace.frames / 1e3


def self_before_ms(trace, name: str) -> float | None:
    """A call's self time before its first child named `name` starts (the
    whole call's self time without one), over the calls, in ms; None
    without a call."""
    cs = calls(trace) if trace is not None else []
    if not cs:
        return None
    total = 0.0
    for c, kids in cs:
        stop = min((float(e["ts"]) for e in kids if e["name"] == name), default=_end(c))
        covered = _union((float(e["ts"]), min(_end(e), stop)) for e in kids
                         if float(e["ts"]) < stop)
        total += stop - float(c["ts"]) - sum(b - a for a, b in covered)
    return total / len(cs) / 1e3


def clock_lead(trace) -> tuple[list[float], list[float]]:
    """How far the trace's device clock runs ahead of its host clock:
    ([t], [lead]) in us, one reading in each of the equal stretches of
    about ``ALIGN_BIN_US`` that the sub-window splits into, at the device
    time t where it was taken.

    A device event cannot start before the host call that launched it (the
    two share the trace's ``correlation``), so over a stretch of the trace
    the least lag from launch to device start is the clocks' difference (to
    within the fastest launch, microseconds). The profiler puts both on one
    clock, but on an NVIDIA H100 the device's timestamps were seen to lead
    by up to 5.4 ms and to drift by 5.3 ms over a 2 s sub-window in some
    runs; ([], []) where no event is tied to its launch."""
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in trace.host
                if e.get("cat") in LAUNCHES and "correlation" in e.get("args", {})}
    n = max(1, round((trace.t1 - trace.t0) / ALIGN_BIN_US))
    least: dict[int, tuple[float, float]] = {}
    for e in trace.device:
        host = launched.get(e.get("args", {}).get("correlation"))
        if host is not None:
            t = float(e["ts"])
            # no short stretch at an end: one whose launches all queued
            # behind earlier work would read a lead that is not there
            k = min(max(int((t - trace.t0) * n // (trace.t1 - trace.t0)), 0), n - 1)
            if k not in least or t - host < least[k][1]:
                least[k] = (t, t - host)
    readings = [least[k] for k in sorted(least)]
    return [t for t, _ in readings], [lead for _, lead in readings]


def _idle(trace) -> list[tuple[float, float]]:
    """The sub-window's idle intervals of the device, on the host's clock:
    device events moved back by ``clock_lead``, linear between its
    readings and beyond the outermost two."""
    at, lead = clock_lead(trace)

    def host(t: float) -> float:
        if len(at) < 2:
            return t - (lead[0] if lead else 0.0)
        k = min(max(bisect.bisect_left(at, t), 1), len(at) - 1)
        f = (t - at[k - 1]) / (at[k] - at[k - 1])
        return t - (lead[k - 1] + f * (lead[k] - lead[k - 1]))

    busy = _union((max(host(float(e["ts"])), trace.t0), min(host(_end(e)), trace.t1))
                  for e in trace.device)
    edges = [trace.t0] + [x for iv in busy if iv[1] > iv[0] for x in iv] + [trace.t1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def idle_unnamed_pct(trace) -> float | None:
    """The share of the sub-window in which the device is idle and the
    calling thread is in none of the calls' children, in %; None without a
    call or without device activity."""
    cs = calls(trace) if trace is not None else []
    if not cs or trace.window_s <= 0 or not trace.busy:
        return None
    named = _union((float(e["ts"]), _end(e)) for _, kids in cs for e in kids)
    idle = _idle(trace)
    unnamed = sum(b - a for a, b in idle) - _overlap(idle, named)
    return 100 * unnamed / (trace.t1 - trace.t0)


def idle_by_span(trace) -> dict[str, float] | None:
    """The sub-window's idle time of the device, in seconds, summed by the
    innermost ``lfi.*`` span of the calls' threads around it (``SELF``
    inside a call but in none of its children, ``OUTSIDE`` in no call);
    None without a call."""
    cs = calls(trace) if trace is not None else []
    if not cs:
        return None
    threads = {_thread(c) for c, _ in cs}
    spans = [e for e in program_spans(trace) if _thread(e) in threads]
    edges = sorted({trace.t0, trace.t1} | {x for e in spans for x in (float(e["ts"]), _end(e))
                                          if trace.t0 < x < trace.t1})
    idle = _idle(trace)
    idle_ends = [b for _, b in idle]
    out: dict[str, float] = {}
    active: list[dict] = []
    i = 0
    for a, b in zip(edges, edges[1:]):
        while i < len(spans) and float(spans[i]["ts"]) <= a:
            active.append(spans[i])
            i += 1
        active = [e for e in active if _end(e) > a]
        k = bisect.bisect_right(idle_ends, a)
        length = _overlap([(a, b)], idle[k:bisect.bisect_left(idle_ends, b, k) + 1])
        if length <= 0:
            continue
        # spans nest by time: the innermost open one started last (the
        # shorter of two that start together)
        inner = max(active, key=lambda e: (float(e["ts"]), -float(e["dur"])), default=None)
        key = OUTSIDE if inner is None else SELF if inner["name"] == CALL else inner["name"]
        out[key] = out.get(key, 0.0) + length / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    from lfibench import tracing

    path = argv[0] if argv else os.path.join(here, "out", "trace.json")
    trace = tracing.Trace(path, frames=0)
    idle = sum(b - a for a, b in _idle(trace)) / 1e6
    names = sorted({e["name"] for _, kids in calls(trace) for e in kids})
    lead = clock_lead(trace)[1]
    print(json.dumps({"trace": path, "window_s": trace.window_s, "idle_s": idle,
                      "device_clock_lead_us": [min(lead), max(lead)] if lead else None,
                      "calls": len(calls(trace)), "idle_by_span": idle_by_span(trace),
                      "per_call_ms": {n: per_call_ms(trace, n) for n in names},
                      "self_ms": self_ms(trace),
                      "self_before_upload_ms": self_before_ms(trace, "lfi.upload")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
