"""The traced run: a ``torch.profiler`` trace of a short steady sub-window,
and what the per-layer metrics read from it.

The profiler records CPU activity (torch operators, CUDA runtime calls and
the benchmark's own spans, ``lfibench.*``) and CUDA activity (kernels,
copies, sets) on one timeline. The trace is exported as one Chrome trace,
``lfibench/out/trace.json``, overwritten by each traced run, and read back
here: the Chrome trace is where the profiler states each copy's bytes.

Spans, as ``torch.profiler.record_function`` regions:
  lfibench.traced   the traced sub-window (opened after the profiler starts,
                    closed before it stops): the window the device's busy
                    and idle time are taken over
  lfibench.call     one call of the API, from the caller's side
  lfibench.feed     the traffic handing one frame to a stream
  lfibench.consume  the caller taking one frame's views from a stream
"""

from __future__ import annotations

import bisect
import json
import os
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Tracer:
    """Starts the profiler once the window has run `after_s`, stops it
    `length_s` later; the traffic calls ``step`` between frames and
    ``frame`` for each frame completed."""

    def __init__(self, path: str, after_s: float, length_s: float):
        self.path, self.after_s, self.length_s = path, after_s, length_s
        self.frames = 0
        self._prof = self._span = None
        self._t_on = None
        self.done = False

    @staticmethod
    def warm_up() -> None:
        """Start and stop the profiler once, in set-up: its first start
        (CUPTI's) takes seconds, which would eat the traced sub-window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def step(self, elapsed_s: float) -> None:
        if self.done:
            return
        if self._prof is None and elapsed_s >= self.after_s:
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            # every thread's operators: a stream's feeder thread copies each
            # frame into pinned memory
            self._prof = profile(activities=acts,
                                 experimental_config=_ExperimentalConfig(profile_all_threads=True))
            self._prof.start()
            self._span = torch.profiler.record_function("lfibench.traced")
            self._span.__enter__()
            self._t_on = time.perf_counter()
        elif self._prof is not None and time.perf_counter() - self._t_on >= self.length_s:
            self.stop()

    def frame(self) -> None:
        if self._prof is not None and not self.done:
            self.frames += 1

    def stop(self) -> None:
        if self._prof is None or self.done:
            return
        self._span.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.done = True
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None


def _name(ev: dict) -> str:
    """A device event's short name: a kernel's function name without its
    template arguments and parameters; a copy's name as the trace gives it."""
    name = ev["name"]
    if ev.get("cat") != "kernel":
        return name
    words = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return words[-1] if words else name


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The events of one traced sub-window (times in microseconds, the
    trace's own clock) and the frames completed in it."""

    def __init__(self, path: str, frames: int):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        spans = [e for e in events if e["name"] == "lfibench.traced"
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise RuntimeError(f"{path}: no lfibench.traced span")
        self.t0 = float(spans[0]["ts"])
        self.t1 = self.t0 + float(spans[0]["dur"])
        self.frames = frames
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        self._calls = None
        self.busy = _union([(max(float(e["ts"]), self.t0),
                             min(float(e["ts"]) + float(e["dur"]), self.t1))
                            for e in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_s(self, *names: str) -> float:
        """Seconds of the kernels whose function name is one of `names`."""
        return sum(float(e["dur"]) for e in self.device
                   if e.get("cat") == "kernel" and _name(e) in names) / 1e6

    def copies(self, kind: str) -> tuple[int, float]:
        """(bytes, seconds) of the copies of `kind` ("DtoH", "HtoD")."""
        evs = [e for e in self.device if e.get("cat") == "gpu_memcpy" and kind in e["name"]]
        return (sum(int(e.get("args", {}).get("bytes", 0)) for e in evs),
                sum(float(e["dur"]) for e in evs) / 1e6)

    def spans(self, name: str) -> list[dict]:
        return [e for e in self.host if e["name"] == name and e.get("cat") == "user_annotation"]

    def first_device_call(self, t_from: float, t_to: float) -> float | None:
        """The start of the first CUDA launch, copy or set the host makes in
        [t_from, t_to), or None."""
        if self._calls is None:
            self._calls = sorted(
                float(e["ts"]) for e in self.host
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and any(k in e["name"] for k in ("Launch", "Memcpy", "Memset")))
        i = bisect.bisect_left(self._calls, t_from)
        return self._calls[i] if i < len(self._calls) and self._calls[i] < t_to else None

    def _host_doing(self, times: list[float]) -> list[str]:
        """What the host was doing at each of the sorted `times`, by a sweep
        over the host events: the benchmark's span, the outermost torch
        operator and the innermost CUDA runtime call that cover it."""
        events = sorted(self.host, key=lambda e: float(e["ts"]))
        active: list[dict] = []
        i, out = 0, []
        for t in times:
            while i < len(events) and float(events[i]["ts"]) <= t:
                active.append(events[i])
                i += 1
            active = [e for e in active if float(e["ts"]) + float(e["dur"]) > t]
            out.append(self._doing(active))
        return out

    @staticmethod
    def _doing(cover: list[dict]) -> str:
        parts = []
        bench = [e for e in cover if e["name"].startswith("lfibench.")
                 and e["name"] != "lfibench.traced"]
        if bench:
            parts.append(min(bench, key=lambda e: float(e["dur"]))["name"])
        ops = [e for e in cover if e.get("cat") == "cpu_op"]
        if ops:
            parts.append(max(ops, key=lambda e: float(e["dur"]))["name"])
        rt = [e for e in cover if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        if rt:
            parts.append(min(rt, key=lambda e: float(e["dur"]))["name"])
        return " / ".join(parts) if parts else "no span, operator or CUDA call"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time of
        the device summed by what the host was doing in each gap (named at
        the gap's middle); at most 10 entries each, seconds."""
        ops: dict[str, float] = {}
        for e in self.device:
            ops[_name(e)] = ops.get(_name(e), 0.0) + float(e["dur"]) / 1e6
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        gaps: dict[str, float] = {}
        for (a, b), who in zip(idle, self._host_doing([(a + b) / 2 for a, b in idle])):
            gaps[who] = gaps.get(who, 0.0) + (b - a) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}
