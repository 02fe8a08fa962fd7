"""The Looking Glass configuration (``quilt5x9_1080p``) in the benchmark: its
cell and traffic, the untiling of a quilt into its views, the check that has
to fail planted faults in the canvas, the roofline count of the fused quilt
blend, and the readers of the quilt's metrics on a hand-written trace.

    python -m pytest lfibench/tests -q
"""

from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from lfibench import quilt, roofline, tracing
from lfibench import run as harness

CELL = "quilt5x9_1080p.quilt_api"
METRICS = ("quilt_blend_roofline", "quilt.hwc_ms", "quilt.download_ms")


def _rehearse(seed: int = 2 ** 33 + 21, trace: int = 0):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = harness.main(["--workload", CELL, "--seed", str(seed), "--seconds", "2",
                           "--trace", str(trace), "--rehearse"])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_the_cell_is_one_chip_of_the_whole_deployment():
    bench = harness.load_benchmark()
    config = next(c for c in bench["configs"] if c["name"] == "quilt5x9_1080p")
    assert config["reduced"] == []
    _, cell, _, mix, _, _ = harness.open_cell(CELL, rehearse=True)
    spec = harness.load_json(f"{harness.ROOT}/{config['file']}")
    assert (spec["cols"], spec["rows"], spec["height"], spec["width"]) == (8, 8, 1080, 1920)
    assert spec["views"] == 45 and spec["quilt"] == {"cols": 5, "rows": 9}
    assert spec["method"] == "TEN" and cell["chips"] == 1
    assert (mix["draws"], mix["samples"], mix["limits"]) == (64, 8, {"view_bytes_off_rule": 0})
    assert mix["focus_uniform"] == [0.0, 0.35] and mix["sweep_height_uniform"] == [0.0, 1.0]
    for m in METRICS:
        entry = next(e for e in bench["per_layer"] if e["name"] == m)
        assert entry["workloads"] == [CELL] and entry["moves"] == "frames_per_s"


def test_each_call_is_a_horizontal_sweep_at_a_focus_on_the_slider():
    _, _, cfg, mix, gen, _ = harness.open_cell(CELL, rehearse=True)
    a = harness.Run(cfg, mix, 2 ** 40 + 3, 20, "cpu")
    b = harness.Run(cfg, mix, 2 ** 40 + 3, 20, "cpu")
    call_a, call_b = gen.inputs(a), gen.inputs(b)
    calls = [call_a(i) for i in range(2 * mix["draws"])]
    assert calls == [call_b(i) for i in range(2 * mix["draws"])]
    assert calls[:mix["draws"]] == calls[mix["draws"]:]  # the draws, cycled
    heights = set()
    for c in calls:
        x0, y0, x1, y1 = (float(v) for v in c["trajectory"].split(","))
        assert (x0, x1) == (0.0, 1.0) and y0 == y1 and 0.0 <= y0 <= 1.0
        assert 0.0 <= c["focus"] <= 0.35 and c["focus_range"] == 0.0 and c["frame"] == 0
        heights.add(y0)
    assert len(heights) == mix["draws"]


def test_untile_follows_the_montage_order():
    """View i sits at tile (i // 5, i % 5): a canvas whose every tile holds
    its own index untiles into views 0, 1, ..., 44; a canvas of another
    shape gives no views."""
    gen = harness.load_module("traffic", "quilt_loop")
    h, w = 3, 4
    canvas = np.zeros((9 * h, 5 * w, 3), np.uint8)
    for r in range(9):
        for c in range(5):
            canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = 5 * r + c
    views = gen.untile(canvas, 5, 9, h, w)
    assert views.shape == (45, h, w, 3)
    assert [int(v.min()) for v in views] == [int(v.max()) for v in views] == list(range(45))
    assert gen.untile(canvas[:-1], 5, 9, h, w).shape == (0, h, w, 3)


def test_a_rehearsal_of_the_cell_is_correct():
    rc, line, err = _rehearse()
    assert rc == 0 and line["correct"] is True, err
    assert line["checks"] == {"view_bytes_off_rule": {"value": 0, "limit": 0}}
    assert "check: 8 answers" in err


def _swap_two_tiles(canvas, h, w):
    """Tiles (0, 1) and (1, 0) exchanged: views 1 and 5, as a canvas laid
    out column by column would place them."""
    a, b = canvas[:, :h, w:2 * w].clone(), canvas[:, h:2 * h, :w].clone()
    canvas[:, :h, w:2 * w], canvas[:, h:2 * h, :w] = b, a


def _one_byte(canvas, h, w):
    canvas[1, 5 * h + 3, 2 * w + 7] ^= 2  # two steps: never a neighbour of the sum


@pytest.mark.parametrize("fault", [_swap_two_tiles, _one_byte], ids=["swapped", "byte"])
def test_a_canvas_planted_with_a_fault_fails(fault, monkeypatch):
    from lfinterpolator_tpu_torch.ops import quilt as program_quilt

    original = program_quilt.quilt_blend

    def planted(images, *a, **k):
        canvas = original(images, *a, **k).clone()
        fault(canvas, images.shape[2], images.shape[3])
        return canvas

    monkeypatch.setattr(program_quilt, "quilt_blend", planted)
    rc, line, err = _rehearse()
    assert rc == 0 and line["correct"] is False, err
    assert line["checks"]["view_bytes_off_rule"]["value"] >= 8  # each kept quilt


def test_a_quilt_call_returning_the_last_quilt_fails(monkeypatch):
    from lfinterpolator_tpu_torch import api

    original, last = api.Interpolator.render_quilt, {}

    def stale(self, *a, **k):
        last["n"] = last.get("n", 0) + 1
        if last["n"] % 2 == 0 and "res" in last:
            return last["res"]
        last["res"] = original(self, *a, **k)
        return last["res"]

    monkeypatch.setattr(api.Interpolator, "render_quilt", stale)
    rc, line, err = _rehearse()
    assert line["correct"] is False, err
    assert line["checks"]["view_bytes_off_rule"]["value"] >= 1


def test_the_fused_quilt_blend_of_the_cell():
    """398 MB of grid read and the 280 MB canvas written, at 3.35 TB/s:
    0.2024 ms, the same least time as the frame's in ``step_mfu``."""
    nbytes, macs = quilt.blend_counts(64, 5, 9, 3, 1080, 1920)
    n = 3 * 1080 * 1920
    assert nbytes == 64 * n + 45 * n + 4 * 45 * 64 + 8 * 64
    assert macs == 45 * 64 * n
    assert quilt.blend_bound_s(64, 5, 9, 3, 1080, 1920) == pytest.approx(nbytes / 3.35e12)
    assert quilt.blend_bound_s(64, 5, 9, 3, 1080, 1920) == pytest.approx(0.2024e-3, rel=1e-3)
    config = harness.load_json(f"{harness.ROOT}/lfibench/configs/quilt5x9_1080p.json")
    assert roofline.frame_bound_s(config, False) == quilt.blend_bound_s(64, 5, 9, 3, 1080, 1920)


#: One quilt call of 500 us at `t`: (name, start, end) on the calling thread.
CALL = [("lfibench.call", 5, 495), ("lfi.render_quilt", 10, 490), ("lfi.params", 20, 60),
        ("lfi.upload", 60, 80), ("lfi.plan", 80, 100), ("lfi.blend", 100, 200),
        ("lfi.quilt.hwc", 200, 240), ("lfi.quilt.download", 240, 480)]
#: (host call, its time, correlation offset, device event, device start, end):
#: in lfi.blend the shifts' clip and the quilt blend, in lfi.quilt.hwc the
#: HWC copy, in lfi.quilt.download the pageable copy.
LAUNCHES = [
    ("cudaLaunchKernel", 110, 1, ("kernel", "void at::native::elementwise_kernel<128, 4>(int)"),
     150, 155),
    ("cudaLaunchKernel", 150, 2, ("kernel", "void shift_blend_kernel<(Mode)2, false>(int)"),
     160, 260),
    ("cudaLaunchKernel", 210, 3, ("kernel", "void at::native::elementwise_kernel<128, 4>(int)"),
     260, 300),
    ("cudaMemcpyAsync", 245, 4, ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)"), 300, 470)]


def _trace(path, names=None, call="lfi.render_quilt"):
    """A trace of 1000 us holding two quilt calls, at 0 and 500 us (only the
    program spans named in `names`, if given; the call span named
    `call`), and return it read."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "lfibench.traced", "ts": 0,
           "dur": 1000, "pid": 1, "tid": 1}]
    for k, t in enumerate((0, 500)):
        ev += [{"ph": "X", "cat": "user_annotation", "name": call if n == quilt.CALL else n,
                "ts": t + a, "dur": b - a, "pid": 1, "tid": 1} for n, a, b in CALL
               if names is None or n in names or not n.startswith("lfi.")]
        for host, at, corr, dev, a, b in LAUNCHES:
            args = {"correlation": 100 * k + corr}
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": host, "ts": t + at, "dur": 2,
                       "pid": 1, "tid": 1, "args": args})
            ev.append({"ph": "X", "cat": dev[0], "name": dev[1], "ts": t + a, "dur": b - a,
                       "pid": 0, "tid": 7, "args": {**args, "bytes": 1000}})
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.Trace(str(path), frames=2)


def _read(metric: str, trace):
    config = harness.load_json(f"{harness.ROOT}/lfibench/configs/quilt5x9_1080p.json")
    rec = type("Rec", (), {"trace": trace, "config": config, "mix": {"allfocus": False}})()
    return harness.load_module("metrics", metric).read(rec)


def test_the_quilt_readers_give_the_known_values(tmp_path):
    """The roofline over the blend kernel alone (not the clip launched in
    the same span), the HWC copy's kernel (not the copy to the host), the
    download's host time per call."""
    trace = _trace(tmp_path / "t.json")
    bound = quilt.blend_bound_s(64, 5, 9, 3, 1080, 1920)
    assert _read("quilt_blend_roofline", trace) == pytest.approx(100 * bound / 100e-6)
    assert _read("quilt.hwc_ms", trace) == pytest.approx(0.040)
    assert _read("quilt.download_ms", trace) == pytest.approx(0.240)


@pytest.mark.parametrize("metric", METRICS)
def test_a_program_without_the_quilt_spans_reads_as_nothing(metric, tmp_path):
    """The parent's render_quilt opens only params, upload and plan; calls
    of ``interpolate`` are no quilt calls; no trace, no number."""
    parent = _trace(tmp_path / "p.json", names={"lfi.render_quilt", "lfi.params",
                                                "lfi.upload", "lfi.plan"})
    assert _read(metric, parent) is None
    assert _read(metric, None) is None
    if metric == "quilt.download_ms":
        assert _read(metric, _trace(tmp_path / "i.json", call="lfi.interpolate")) is None


def test_the_kernel_reader_finds_no_kernel_it_was_not_asked_for(tmp_path):
    trace = _trace(tmp_path / "t.json")
    assert quilt.kernel_ms_per_frame(trace, "lfi.blend", "quilt_copy_kernel") is None
    assert quilt.kernel_ms_per_frame(trace, "lfi.quilt.hwc", "shift_blend_kernel") is None
    assert quilt.kernel_ms_per_frame(trace, "lfi.blend", "shift_blend_kernel") == \
        pytest.approx(0.100)
    assert len(quilt.calls(trace)) == 2
