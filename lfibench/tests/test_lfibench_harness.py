"""The benchmark harness on the CPU: its names and files, its result line,
and its check, which has to pass the program and fail planted faults.

Runs rehearse a cell (``--rehearse``: the same steps on the CPU at a tiny
size, through the program's plain path). ``test_cells_on_the_card`` runs
each cell for a short window on a CUDA device and skips without one.

    python -m pytest lfibench/tests -q
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from lfibench import control, roofline, tracing
from lfibench import run as harness

ROOT = harness.ROOT
BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]] + ["lf8x8_1080p.fixed_stream"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
#: The stream's cell, which BENCHMARK.json leaves out (its runs spread too
#: widely on a shared host; PERF.md, Open questions): its generator, mix and
#: metric are kept for it and rehearsed here as a cell.
STREAM = {"name": "lf8x8_1080p.fixed_stream", "config": "lf8x8_1080p",
          "traffic": "fixed_stream", "chips": 1, "why": "a video through the stream"}
UPLOAD = {"name": "upload.gb_per_s", "unit": "GB/s", "better": "higher", "source": "device_trace",
          "layer": "streaming", "moves": "frames_per_s", "workloads": [STREAM["name"]]}


@pytest.fixture(autouse=True)
def with_stream(monkeypatch):
    """Every test sees BENCHMARK.json with the stream's cell added."""
    bench = harness.load_benchmark()
    bench["workloads"].append(dict(STREAM))
    bench["per_layer"].append(dict(UPLOAD))
    for m in bench["per_layer"]:
        if m["name"] == "shift_blend_roofline":
            m["workloads"] = m["workloads"] + [STREAM["name"]]
    monkeypatch.setattr(harness, "load_benchmark", lambda: bench)


def rehearse(cell: str, trace: int = 0, seed: int = 2 ** 31 + 7, seconds: float = 2.0):
    """-> (exit code, the last line's object or None, standard error)."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace), "--rehearse"])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_every_cell_and_metric_is_found_by_name():
    for cell in CELLS:
        _, c, config, mix, gen, _ = harness.open_cell(cell, rehearse=True)
        for fn in ("make_scenes", "inputs", "setup", "window"):
            assert callable(getattr(gen, fn)), (cell, fn)
        assert set(mix["limits"]) and mix["samples"] >= 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_a_name_that_is_not_there_fails():
    with pytest.raises(harness.SpecError):
        harness.load_module("metrics", "no_such_metric")
    with pytest.raises(harness.SpecError):
        harness.open_cell("no_such.cell", rehearse=True)
    rc, line, err = rehearse("no_such.cell")
    assert rc == 1 and line is None and "no_such.cell" in err


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lfibench"] and BENCH["command"] == ["python3", "lfibench/run.py"]
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lfibench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert all(cell in CELLS for cell in m.get("workloads", []))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += list(configs) + CELLS
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + \
            [c["source"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for cell in CELLS:  # setup_s, another end-to-end metric, a per-layer one
        reported = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(BENCH, cell, True)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_prints_the_contract_line(cell, trace):
    rc, line, err = rehearse(cell, trace)
    assert rc == 0, err
    assert set(line) == KEYS | {"checks"} | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["metrics"] == {}  # a rehearsal never prints a device metric
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check answers")
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _plant(monkeypatch, name: str, fault):
    from lfinterpolator_tpu_torch.models import pipeline

    original = getattr(pipeline, name)
    monkeypatch.setattr(pipeline, name, lambda *a, **k: fault(original, *a, **k))


def _one_byte(original, *a, **k):
    out = original(*a, **k).clone()
    out.view(-1)[out.numel() // 3] ^= 1
    return out


def _half_the_images(original, images, weights, *a, **k):
    """The blend over every second image, the weights renormalised over
    those: half the batch left out, the mean taken over the rest."""
    w = weights[:, ::2]
    w = (w / w.sum(dim=1, keepdim=True)).to(torch.float16).to(torch.float32)
    return original(images[::2].contiguous(), w.contiguous(), a[0][::2].contiguous(),
                    *a[1:], **k)


FIXED = ["lf8x8_1080p.fixed_api", "lf8x8_1080p.fixed_stream"]
ALLFOCUS = ["lf8x8_1080p.allfocus_api", "hci9x9_512.allfocus_api"]


@pytest.mark.parametrize("cell", FIXED + ALLFOCUS)
def test_a_byte_altered_where_the_views_are_made_fails(cell, monkeypatch):
    _plant(monkeypatch, "blend_all_focus" if cell in ALLFOCUS else "render_fixed_focus",
           _one_byte)
    rc, line, err = rehearse(cell)
    assert rc == 0 and line["correct"] is False, err
    assert line["checks"]["view_bytes_off_rule"]["value"] >= 1


@pytest.mark.parametrize("cell", ALLFOCUS)
def test_a_byte_altered_in_the_filtered_map_fails(cell, monkeypatch):
    def fault(original, *a, **k):
        maps = original(*a, **k).clone()
        maps[1, 0, 0] ^= 1
        return maps

    _plant(monkeypatch, "compute_focus_maps", fault)
    rc, line, err = rehearse(cell)
    assert line["correct"] is False, err
    assert line["checks"]["map_bytes_off"]["value"] >= 1
    assert line["checks"]["view_bytes_off_rule"]["value"] == 0  # TEN reads the raw map


@pytest.mark.parametrize("cell", FIXED + ALLFOCUS)
def test_half_the_images_left_out_fails(cell, monkeypatch):
    _plant(monkeypatch, "blend_all_focus" if cell in ALLFOCUS else "render_fixed_focus",
           _half_the_images)
    rc, line, err = rehearse(cell)
    assert line["correct"] is False, err
    assert line["checks"]["view_bytes_off_rule"]["value"] > 1000


def test_a_stream_frame_left_unchanged_fails(monkeypatch):
    """The stream's step returns its last frame's views again, every
    second frame: a state left unchanged."""
    from lfinterpolator_tpu_torch import streaming

    original, last = streaming.StreamingRenderer._render, {}

    def stale(self, images):
        last["n"] = last.get("n", 0) + 1
        if last["n"] % 2 == 0 and "out" in last:
            return last["out"].clone()
        last["out"] = original(self, images)
        return last["out"]

    monkeypatch.setattr(streaming.StreamingRenderer, "_render", stale)
    rc, line, err = rehearse("lf8x8_1080p.fixed_stream", seed=5)
    assert line["correct"] is False, err
    assert line["checks"]["view_bytes_off_rule"]["value"] >= 1


@pytest.mark.parametrize("cell", ["lf8x8_1080p.fixed_api", "hci9x9_512.allfocus_api"])
def test_an_api_call_returning_the_last_result_fails(cell, monkeypatch):
    """Every second call returns the result of the call before: a state
    left unchanged."""
    from lfinterpolator_tpu_torch import api

    original, last = api.Interpolator.interpolate, {}

    def stale(self, *a, **k):
        last["n"] = last.get("n", 0) + 1
        if last["n"] % 2 == 0 and "res" in last:
            return last["res"]
        last["res"] = original(self, *a, **k)
        return last["res"]

    monkeypatch.setattr(api.Interpolator, "interpolate", stale)
    rc, line, err = rehearse(cell, seed=6, seconds=4.0)
    assert line["correct"] is False, err
    assert line["checks"]["view_bytes_off_rule"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_a_precision_below_fails(cell):
    limits = harness.open_cell(cell, rehearse=True)[3]["limits"]
    got = control.readings(cell, 2 ** 31 + 99, rehearse=True)
    assert set(got) == set(limits)
    assert any(got[k] > limits[k] for k in limits), got


def test_without_a_card_a_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "lfibench/run.py", "--workload", CELLS[0], "--seed",
                           "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "lfibench"), tmp_path / "lfibench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    proc = subprocess.run([sys.executable, "lfibench/run.py", "--workload", CELLS[0], "--seed",
                           "3", "--seconds", "1", "--trace", "0", "--rehearse"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _fake_trace(path):
    """A trace of 1 ms holding two calls, each with the estimate's and the
    blend's kernels and a 5 MB download."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "lfibench.traced", "ts": 0, "dur": 1000,
           "pid": 1, "tid": 1}]
    for t in (0, 500):
        ev += [
            {"ph": "X", "cat": "user_annotation", "name": "lfibench.call", "ts": t + 10,
             "dur": 480, "pid": 1, "tid": 1},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemGetInfo", "ts": t + 20, "dur": 5,
             "pid": 1, "tid": 1},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t + 60, "dur": 5,
             "pid": 1, "tid": 1},
            {"ph": "X", "cat": "kernel", "ts": t + 100, "dur": 10, "pid": 0, "tid": 7,
             "name": "void (anonymous namespace)::rgbx_pack_kernel<4>(unsigned char const*)"},
            {"ph": "X", "cat": "kernel", "ts": t + 110, "dur": 100, "pid": 0, "tid": 7,
             "name": "void (anonymous namespace)::cheby_map_kernel(unsigned int const*)"},
            {"ph": "X", "cat": "kernel", "ts": t + 210, "dur": 90, "pid": 0, "tid": 7,
             "name": "void (anonymous namespace)::focus_argmin_kernel<true, false>(int)"},
            {"ph": "X", "cat": "kernel", "ts": t + 300, "dur": 50, "pid": 0, "tid": 7,
             "name": "void (anonymous namespace)::allfocus_blend_kernel(unsigned char const*)"},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
             "ts": t + 350, "dur": 100, "pid": 0, "tid": 9, "args": {"bytes": 5_000_000}},
        ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_metric_readers_on_a_known_trace(tmp_path):
    path = tmp_path / "trace.json"
    _fake_trace(path)
    trace = tracing.Trace(str(path), frames=2)
    config = harness.load_json(os.path.join(ROOT, "lfibench/configs/lf8x8_1080p.json"))
    rec = type("Rec", (), {"trace": trace, "config": config, "mix": {"allfocus": True}})()
    read = {m: harness.load_module("metrics", m).read for m in (
        "focus_estimate_roofline", "allfocus_blend_roofline", "shift_blend_roofline",
        "download.gb_per_s", "upload.gb_per_s", "api.host_ms", "device.idle_pct", "step_mfu")}
    est = roofline.estimate_bound_s(32, 32, 1080, 1920, (20, 10))
    assert read["focus_estimate_roofline"](rec) == pytest.approx(100 * est / 200e-6)
    blend = roofline.allfocus_blend_bound_s(64, 64, 3, 1080, 1920)
    assert read["allfocus_blend_roofline"](rec) == pytest.approx(100 * blend / 50e-6)
    assert read["shift_blend_roofline"](rec) is None  # no such kernel: nothing to read
    assert read["upload.gb_per_s"](rec) is None
    assert read["download.gb_per_s"](rec) == pytest.approx(10e6 / 200e-6 / 1e9)
    assert read["api.host_ms"](rec) == pytest.approx(0.05)
    assert read["device.idle_pct"](rec) == pytest.approx(100 * (1 - 700 / 1000))
    assert read["step_mfu"](rec) == pytest.approx(100 * 2 * (est + blend) / 1e-3)
    assert trace.busy_s == pytest.approx(700e-6) and trace.window_s == pytest.approx(1e-3)
    b = trace.breakdown()
    assert dict(b["device_ops"]) == pytest.approx({
        "rgbx_pack_kernel": 20e-6, "cheby_map_kernel": 200e-6, "focus_argmin_kernel": 180e-6,
        "allfocus_blend_kernel": 100e-6, "Memcpy DtoH (Device -> Pinned)": 200e-6})
    # the idle gaps, [0, 100), [450, 600) and [950, 1000) us, all inside a call
    assert dict(b["idle_gaps"]) == pytest.approx({"lfibench.call": 300e-6})


def test_the_reference_agrees_with_the_program_at_a_tiny_size():
    """The plain reference against the port's plain path, directly: maps
    equal, views within the near-tie rule, on a 9x9 grid of 24x40."""
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.io import LightField

    from lfibench.reference import render
    from lfibench.scene import OcclusionScene, plane_foci

    config = dict(harness.load_json(os.path.join(ROOT, "lfibench/configs/hci9x9_512.json")),
                  height=24, width=40, rehearsal=True)
    images = OcclusionScene(9, 9, 24, 40, plane_foci(0.0, 0.07, 32), [4, 3], 3, "cpu").frame()
    interp = Interpolator(LightField(images=images.numpy(), cols=9, rows=9), device="cpu",
                          progress=False)
    planar = images.permute(0, 3, 1, 2).contiguous()
    for traj, focus, rng in [("0.1,0.2,0.9,0.7", 0.0, 0.07), ("0,0,1,1", 0.03, 0.0)]:
        res = interp.interpolate(traj, focus=focus, focus_range=rng, method="TEN", progress=False)
        ref = render.render(config, planar, traj, focus, rng)
        got = render.compare(ref, torch.from_numpy(res.views),
                             None if res.maps is None else torch.from_numpy(res.maps))
        assert set(got.values()) == {0}, got
        bad = torch.from_numpy(res.views.copy())
        bad.view(-1)[17] ^= 2
        assert render.compare(ref, bad, None if res.maps is None
                              else torch.from_numpy(res.maps))["view_bytes_off_rule"] == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cells_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, "lfibench/run.py", "--workload", cell, "--seed",
                           str(2 ** 31 + 11), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}


def test_rehearsal_is_reproducible_from_the_seed():
    a = harness.Run({**harness.load_json(os.path.join(ROOT, "lfibench/configs/lf8x8_1080p.json")),
                     "height": 24, "width": 40}, harness.load_json(os.path.join(
                         ROOT, "lfibench/traffic/allfocus_api.json")), 2 ** 33 + 1, 20, "cpu")
    b = harness.Run(a.config, a.mix, 2 ** 33 + 1, 20, "cpu")
    a.make_scenes([(0.0, 0.0)])
    b.make_scenes([(0.0, 0.0)])
    assert a.samples == b.samples and np.array_equal(a.scenes[0], b.scenes[0])
