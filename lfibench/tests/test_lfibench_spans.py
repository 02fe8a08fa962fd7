"""The readers of the program's ``lfi.*`` spans (``lfibench/spans.py`` and
the eight metrics that use it) on a hand-written Chrome trace: each gives
the value worked out by hand, and None where its span is absent.

    python -m pytest lfibench/tests/test_lfibench_spans.py -q
"""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest

from lfibench import run as harness
from lfibench import spans, tracing

#: One all-in-focus call of 500 us, at `t`: (name, start, end) on the
#: calling thread. The device is busy over [95, 97) and [140, 420), so it
#: is idle over [0, 95), [97, 140) and [420, 500): 218 us, of which 20 are
#: outside the call (0-10, 490-500) and 70 in its self time (10-20,
#: 430-490).
CALL = [("lfibench.call", 5, 495), ("lfi.interpolate", 10, 490), ("lfi.params", 20, 60),
        ("lfi.plan", 60, 80), ("lfi.upload", 80, 100), ("lfi.estimate", 100, 200),
        ("lfi.estimate.flags", 110, 130), ("lfi.filter", 200, 220), ("lfi.blend", 220, 240),
        ("lfi.download.start", 240, 260), ("lfi.download.wait", 260, 430)]
#: (host call, its time, correlation offset, device event, device start, end)
LAUNCHES = [("cudaMemGetInfo", 65, None, None, 0, 0),
            ("cudaMemcpyAsync", 90, 1, ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)"), 95, 97),
            ("cudaLaunchKernel", 115, 2, ("kernel", "void at::native::elementwise_kernel<128, 4>(int)"),
             140, 150),
            ("cudaLaunchKernel", 150, 3, ("kernel", "void focus_argmin_kernel<true, false>(int)"),
             150, 250),
            ("cudaLaunchKernel", 205, 4, ("kernel", "void at::native::reduce_kernel<512, 1>(int)"),
             250, 260),
            ("cudaLaunchKernel", 225, 5, ("kernel", "void allfocus_blend_kernel(int)"), 260, 300),
            ("cudaLaunchKernel", 245, 6, ("kernel", "void at::native::elementwise_kernel<128, 4>(int)"),
             300, 320),
            ("cudaMemcpyAsync", 255, 7, ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)"), 320, 420)]


def _trace(path, names=None, calls=(0, 500), window=1000, drift=lambda t: 0.0):
    """Write a trace of `window` us holding one call at each of `calls` us
    (only the program spans named in `names`, if given), the device's clock
    ahead of the host's by ``drift(t)`` us at t, and return it read."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "lfibench.traced", "ts": 0,
           "dur": window, "pid": 1, "tid": 1}]
    for k, t in enumerate(calls):
        ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": t + a, "dur": b - a,
                "pid": 1, "tid": 1} for n, a, b in CALL
               if names is None or n in names or not n.startswith("lfi.")]
        for host, at, corr, dev, a, b in LAUNCHES:
            args = {} if corr is None else {"correlation": 100 * k + corr}
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": host, "ts": t + at, "dur": 2,
                       "pid": 1, "tid": 1, "args": args})
            if dev is not None:
                ev.append({"ph": "X", "cat": dev[0], "name": dev[1], "ts": t + a + drift(t + a),
                           "dur": b + drift(t + b) - a - drift(t + a),
                           "pid": 0, "tid": 7, "args": {**args, "bytes": 1000}})
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.Trace(str(path), frames=len(calls))


def _read(metric: str, trace):
    rec = type("Rec", (), {"trace": trace, "config": {}, "mix": {"allfocus": True}})()
    return harness.load_module("metrics", metric).read(rec)


#: Each new metric and its value on the trace of two calls, in its unit.
KNOWN = {"api.params_ms": 0.040, "api.plan_ms": 0.020, "api.upload_ms": 0.020,
         "api.self_ms": 0.070, "download.wait_ms": 0.170,
         "download.hwc_ms": 0.020,  # the HWC copy's kernel, not the DtoH copy
         "estimate.flags_ms": 0.010,  # the flags' kernel, not the argmin launched after
         "device.idle_unnamed_pct": 100 * 2 * (20 + 70) / 1000}


@pytest.mark.parametrize("metric", sorted(KNOWN))
def test_a_reader_gives_the_known_value(metric, tmp_path):
    assert _read(metric, _trace(tmp_path / "t.json")) == pytest.approx(KNOWN[metric])


@pytest.mark.parametrize("metric", sorted(KNOWN))
def test_a_reader_without_its_span_gives_none(metric, tmp_path):
    """Without the program's spans (a program that has none, as before
    they were added), with them but not the one read, and untraced."""
    assert _read(metric, _trace(tmp_path / "a.json", names=())) is None
    read_by = {"api.params_ms": "lfi.params", "api.plan_ms": "lfi.plan",
               "api.upload_ms": "lfi.upload", "download.wait_ms": "lfi.download.wait",
               "download.hwc_ms": "lfi.download.start",
               "estimate.flags_ms": "lfi.estimate.flags"}.get(metric, "lfi.interpolate")
    others = {n for n, _, _ in CALL} - {read_by}
    assert _read(metric, _trace(tmp_path / "b.json", names=others)) is None
    assert _read(metric, None) is None


def test_the_accepted_readers_read_as_before(tmp_path):
    """The program's spans change nothing that the earlier metrics read."""
    trace = _trace(tmp_path / "t.json")
    assert _read("api.host_ms", trace) == pytest.approx(0.085)  # 5 -> the upload's copy
    assert _read("device.idle_pct", trace) == pytest.approx(100 * 2 * 218 / 1000)
    # each gap named at its middle: every one lies in a call there
    assert dict(trace.breakdown()["idle_gaps"]) == pytest.approx({"lfibench.call": 436e-6})


def test_idle_time_by_innermost_span(tmp_path):
    trace = _trace(tmp_path / "t.json")
    got = spans.idle_by_span(trace)
    assert got == pytest.approx({spans.OUTSIDE: 40e-6, spans.SELF: 140e-6, "lfi.params": 80e-6,
                                 "lfi.plan": 40e-6, "lfi.upload": 36e-6, "lfi.estimate": 40e-6,
                                 "lfi.estimate.flags": 40e-6, "lfi.download.wait": 20e-6})
    assert sum(got.values()) == pytest.approx(trace.window_s - trace.busy_s)
    assert spans.idle_by_span(_trace(tmp_path / "n.json", names=())) is None


def test_a_device_clock_that_drifts_is_put_back_on_the_host_clock(tmp_path):
    """Device timestamps that lead the host's by 3 ms and drift by 0.5 ms
    every 100 ms (seen on a card: 5.4 ms and 5.3 ms over 2 s) give the idle
    split and share of a trace whose clocks agree."""
    calls = [5000 + 2000 * i for i in range(150)]  # three readings of the lead
    plain = _trace(tmp_path / "p.json", calls=calls, window=310_000)
    drifted = _trace(tmp_path / "d.json", calls=calls, window=310_000,
                     drift=lambda t: -3000 + 0.005 * t)
    assert spans.clock_lead(plain)[1] == [0.0] * 3
    assert spans.clock_lead(drifted)[1][0] == pytest.approx(-3000 + 0.005 * 5150, abs=1)
    assert spans.idle_by_span(drifted) == pytest.approx(spans.idle_by_span(plain))
    assert spans.idle_unnamed_pct(drifted) == pytest.approx(spans.idle_unnamed_pct(plain))
    assert spans.idle_unnamed_pct(plain) == pytest.approx(
        100 * 150 * 70 / 310_000 + 100 * (310_000 - 150 * 480) / 310_000)


def test_the_host_path_before_the_first_upload_accounts_for_api_host_ms(tmp_path):
    """params + plan + the call's self time before its upload, and the
    upload's own host work before its first copy (10 us) and the caller's
    5 us before the call, make api.host_ms."""
    trace = _trace(tmp_path / "t.json")
    before = (spans.per_call_ms(trace, "lfi.params") + spans.per_call_ms(trace, "lfi.plan")
              + spans.self_before_ms(trace, "lfi.upload"))
    assert before == pytest.approx(0.070)
    assert _read("api.host_ms", trace) == pytest.approx(before + 0.010 + 0.005)


def test_a_call_outside_the_window_is_not_read(tmp_path):
    trace = _trace(tmp_path / "t.json", calls=(0, 500, 1200))
    assert len(spans.calls(trace)) == 2
    assert _read("api.params_ms", trace) == pytest.approx(0.040)


def test_the_command_line_prints_the_idle_time_by_span(tmp_path):
    _trace(tmp_path / "t.json")
    out = io.StringIO()
    with redirect_stdout(out):
        assert spans.main([str(tmp_path / "t.json")]) == 0
    line = json.loads(out.getvalue())
    assert line["calls"] == 2 and line["idle_s"] == pytest.approx(436e-6)
    assert line["idle_by_span"]["lfi.params"] == pytest.approx(80e-6)
    assert line["per_call_ms"]["lfi.download.wait"] == pytest.approx(0.170)


def test_every_new_metric_is_in_the_benchmark():
    bench = harness.load_benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in KNOWN:
        m = per_layer[name]
        assert m["source"] == "device_trace" and m["moves"] == "frames_per_s"
        assert set(m["workloads"]) <= {c["name"] for c in bench["workloads"]}
