"""The 17x17 configuration (``stanford17x17_1024``) in the benchmark: its
two cells rehearsed, the roofline counts of its blend, and the readers of
the metric that only its cells report.

    python -m pytest lfibench/tests -q
"""

from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest

from lfibench import roofline, tracing
from lfibench import run as harness

CELLS = ["stanford17x17_1024.allfocus_api", "stanford17x17_1024.fixed_api"]
WIDE = "wide_blend_roofline"


def _rehearse(cell: str, trace: int):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = harness.main(["--workload", cell, "--seed", str(2 ** 33 + 15), "--seconds", "2",
                           "--trace", str(trace), "--rehearse"])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_the_configuration_and_its_cells_are_found_by_name():
    bench = harness.load_benchmark()
    config = next(c for c in bench["configs"] if c["name"] == "stanford17x17_1024")
    assert config["reduced"] == []
    spec = harness.load_json(f"{harness.ROOT}/{config['file']}")
    assert (spec["cols"], spec["rows"], spec["height"], spec["width"]) == (17, 17, 1024, 1024)
    for cell in CELLS:
        _, c, cfg, mix, _, _ = harness.open_cell(cell, rehearse=True)
        assert c["chips"] == 1 and cfg["cols"] * cfg["rows"] == 289
        assert all(v == 0 for v in mix["limits"].values())
        traced = {m["name"] for m in harness.cell_metrics(bench, cell, True)}
        assert WIDE in traced and {"step_mfu", "device.idle_pct"} <= traced
        assert {m["name"] for m in harness.cell_metrics(bench, cell, False)} == {
            "frames_per_s", "setup_s"}
    metric = next(m for m in bench["per_layer"] if m["name"] == WIDE)
    assert metric["workloads"] == CELLS and metric["moves"] == "frames_per_s"


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_rehearsal_of_a_17x17_cell_prints_a_correct_line(cell, trace):
    rc, line, err = _rehearse(cell, trace)
    assert rc == 0, err
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert all(c["value"] == 0 == c["limit"] for c in line["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check answers")


def test_the_blend_of_289_images_at_1024_squared():
    nbytes, macs = roofline.blend_counts(289, 64, 3, 1024, 1024)
    assert nbytes == pytest.approx(1110.5e6, rel=1e-4)
    assert macs == 58_183_385_088  # 58.18 G multiply-adds
    assert roofline.blend_bound_s(289, 64, 3, 1024, 1024) == pytest.approx(0.3315e-3,
                                                                          rel=1e-3)
    assert roofline.blend_bound_s(289, 64, 3, 1024, 1024) == nbytes / roofline.HBM_BYTES_PER_S
    ab, am = roofline.allfocus_blend_counts(289, 64, 3, 1024, 1024)
    assert am == macs and ab == nbytes + 1024 * 1024 + 1024


def _trace(path, kernel: str, durations: list[float]):
    """A trace of 1 ms with one launch of `kernel` a duration (us), and a
    foreign kernel after each."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "lfibench.traced", "ts": 0,
           "dur": 1000, "pid": 1, "tid": 1}]
    t = 10.0
    for dur in durations:
        ev.append({"ph": "X", "cat": "kernel", "ts": t, "dur": dur, "pid": 0, "tid": 7,
                   "name": f"void (anonymous namespace)::{kernel}(unsigned char const*)"})
        ev.append({"ph": "X", "cat": "kernel", "ts": t + dur, "dur": 5, "pid": 0, "tid": 7,
                   "name": "void at::native::elementwise_kernel<128, 4>(int)"})
        t += dur + 50
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


@pytest.mark.parametrize("allfocus", [False, True], ids=["fixed", "allfocus"])
def test_the_wide_blend_reader_on_a_known_trace(tmp_path, allfocus):
    kernel = "allfocus_blend_kernel" if allfocus else "shift_blend_kernel"
    other = "shift_blend_kernel" if allfocus else "allfocus_blend_kernel"
    path = tmp_path / "trace.json"
    _trace(path, kernel, [300.0, 100.0, 50.0, 150.0])
    config = harness.load_json(f"{harness.ROOT}/lfibench/configs/stanford17x17_1024.json")
    rec = type("Rec", (), {"trace": tracing.Trace(str(path), frames=3), "config": config,
                           "mix": {"allfocus": allfocus}})()
    read = harness.load_module("metrics", WIDE).read
    bound = (roofline.allfocus_blend_bound_s if allfocus else roofline.blend_bound_s)(
        289, 64, 3, 1024, 1024)
    assert read(rec) == pytest.approx(100 * bound / 200e-6)
    _trace(path, other, [300.0])
    rec.trace = tracing.Trace(str(path), frames=3)
    assert read(rec) is None  # the mix's kernel is not there
    rec.trace = None
    assert read(rec) is None
