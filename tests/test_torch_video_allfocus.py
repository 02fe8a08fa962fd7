"""Light-field video all in focus through the port's ``StreamingRenderer``,
the shape of the benchmark's ``technicolor4x4_2048`` configuration (a 4x4
rig, all 16 cameras as focus views, every frame with its own maps) at a
small size on the CPU, held to the benchmark's plain reference
(``lfibench/reference/render.py``); the cell's rehearsal; and the readers
of the stream's per-layer metrics on a hand-written trace.

The check is exact: no view byte may break the near-tie rule against the
reference's exact sums, and every map byte equals the exact search's.
Maps one frame stale, which a map refresh of 2 would give, fail it.
"""

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from lfibench import run as harness
from lfibench import tracing
from lfibench.reference import render as bench_reference
from lfinterpolator_tpu_torch.core.config import RenderConfig
from lfinterpolator_tpu_torch.models import pipeline
from lfinterpolator_tpu_torch.streaming import StreamingRenderer

torch.set_num_threads(1)

CELL = "technicolor4x4_2048.allfocus_stream"
H, W = 48, 64
TRAJECTORY = "0,0,1,1"
FOCUS, RANGE = 0.1, 0.3


def _config(method: str) -> dict:
    """The benchmark's configuration at the tests' size and 8 candidates."""
    spec = harness.load_json(f"{harness.ROOT}/lfibench/configs/technicolor4x4_2048.json")
    return dict(spec, height=H, width=W, method=method, focus_steps=8, rehearsal=True)


def _renderer(cfg: dict) -> StreamingRenderer:
    return StreamingRenderer(
        cfg["cols"], cfg["rows"], W, H, TRAJECTORY, device="cpu", prefetch=2,
        config=RenderConfig(method=cfg["method"], view_count=cfg["views"], focus=FOCUS,
                            focus_range=RANGE, focus_steps=cfg["focus_steps"],
                            focus_map_views=cfg["focus_map_views"],
                            pixel_size_factor=cfg["pixel_size_factor"],
                            filter_radius_divisor=cfg["filter_radius_divisor"],
                            exact_focus_taps=cfg["exact_focus_taps"], focus_map_refresh=1))


def _frames(n: int, seed: int = 23) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (16, H, W, 3), dtype=np.uint8) for _ in range(n)]


def _off(cfg: dict, frame: np.ndarray, views: np.ndarray, maps: np.ndarray) -> dict:
    planar = torch.from_numpy(frame).permute(0, 3, 1, 2).contiguous()
    ref = bench_reference.render(cfg, planar, TRAJECTORY, FOCUS, RANGE)
    return bench_reference.compare(ref, torch.from_numpy(views), torch.from_numpy(maps))


@pytest.mark.parametrize("method", ["TEN", "STD"])
def test_every_frame_of_a_4x4_video_holds_to_the_reference(method):
    """A 4x4 grid, 64 views, 16 focus views, refresh 1: each frame's views
    and both maps against the reference of that frame."""
    cfg = _config(method)
    frames = _frames(4)
    r = _renderer(cfg)
    assert len(r._params.focus_ids) == 16
    got = list(r.render_stream(iter(frames)))
    assert len(got) == len(frames)
    for frame, (views, maps) in zip(frames, got):
        assert views.shape == (64, H, W, 3) and maps.shape == (2, H, W)
        assert _off(cfg, frame, views, maps) == {"view_bytes_off_rule": 0, "map_bytes_off": 0}
    assert not np.array_equal(got[0][1], got[1][1])  # each frame's own maps


def test_maps_one_frame_stale_fail_the_reference(monkeypatch):
    """The planted fault: frame t blended with, and handed, the maps of
    frame t - 1, what a map refresh of 2 gives every second frame."""
    cfg = _config("TEN")
    frames = _frames(3)
    original, last = pipeline.compute_focus_maps, []

    def stale(*a, **k):
        maps = original(*a, **k)
        last.append(maps)
        return last[-2] if len(last) > 1 else maps

    monkeypatch.setattr(pipeline, "compute_focus_maps", stale)
    got = list(_renderer(cfg).render_stream(iter(frames)))
    offs = [_off(cfg, f, v, m) for f, (v, m) in zip(frames, got)]
    assert offs[0] == {"view_bytes_off_rule": 0, "map_bytes_off": 0}
    for off in offs[1:]:
        assert off["map_bytes_off"] > 0 and off["view_bytes_off_rule"] > 0, offs


#: The cell's rehearsal in a fresh interpreter: the harness refuses a run
#: in a process that holds the JAX package, as this one does. `plant` runs
#: before it.
_REHEARSAL = """
import json, sys
sys.path.insert(0, {root!r})
{plant}
from lfibench import run
sys.exit(run.main(["--workload", {cell!r}, "--seed", "{seed}", "--seconds", "3",
                   "--trace", "{trace}", "--rehearse"]))
"""

#: The planted fault: every estimate after the first hands back the maps of
#: the frame before.
STALE_MAPS = """
from lfinterpolator_tpu_torch.models import pipeline
original, last = pipeline.compute_focus_maps, []
def stale(*a, **k):
    last.append(original(*a, **k))
    return last[-2] if len(last) > 1 else last[-1]
pipeline.compute_focus_maps = stale
"""


def _rehearse(seed: int, trace: int, plant: str = ""):
    """-> (exit code, the last line's object or None, standard error)."""
    code = _REHEARSAL.format(root=harness.ROOT, plant=plant, cell=CELL, seed=seed, trace=trace)
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, (json.loads(lines[-1]) if lines else None), proc.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cells_rehearsal_is_correct_with_maps_in_its_answers(trace):
    """The cell on the CPU at the rehearsal's size: every answer keeps its
    frame's maps, so ``map_bytes_off`` is compared, and it is 0."""
    rc, line, err = _rehearse(2 ** 33 + 5 + trace, trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, err
    assert line["checks"] == {"map_bytes_off": {"value": 0, "limit": 0},
                              "view_bytes_off_rule": {"value": 0, "limit": 0}}
    assert int(re.search(r"check answers (\d+)", err).group(1)) >= 1


def test_the_cells_rehearsal_fails_with_stale_maps():
    rc, line, err = _rehearse(2 ** 33 + 9, 0, STALE_MAPS)
    assert rc == 0 and line["correct"] is False, err[-3000:]
    assert line["checks"]["map_bytes_off"]["value"] > 0


def test_the_cell_is_the_whole_rig_on_one_chip():
    bench = harness.load_benchmark()
    config = next(c for c in bench["configs"] if c["name"] == "technicolor4x4_2048")
    assert config["reduced"] == [] and len(config["source"]) <= 200
    _, cell, _, mix, _, _ = harness.open_cell(CELL, rehearse=True)
    spec = harness.load_json(f"{harness.ROOT}/{config['file']}")
    assert (spec["cols"], spec["rows"], spec["height"], spec["width"]) == (4, 4, 1088, 2048)
    assert (spec["views"], spec["focus_steps"], spec["focus_map_views"]) == (64, 32, 16)
    assert spec["method"] == "TEN" and spec["exact_focus_taps"] and cell["chips"] == 1
    assert mix["allfocus"] is True and mix["focus_map_refresh"] == 1 and mix["prefetch"] == 2
    assert mix["occluder_shifts_px"] == list(range(0, 64, 8)) and mix["samples"] == 4
    assert mix["limits"] == {"view_bytes_off_rule": 0, "map_bytes_off": 0}
    for name in ("stream.feed_ms", "stream.take_ms", "stream.drain_ms"):
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        assert entry["workloads"] == [CELL] and entry["layer"] == "streaming"
        assert entry["moves"] == "frames_per_s" and entry["better"] == "lower"


#: A traced sub-window of 1000 us: (name, start, end, thread). The decode
#: thread (2) feeds ahead of the render loop (1); spans that start before
#: the sub-window (the first feed, take and frame) or after it are not
#: counted.
STREAM = [("lfi.stream.feed", -300, -50, 2), ("lfi.stream.take", -40, -30, 1),
          ("lfi.stream.frame", -30, 20, 1),
          ("lfi.stream.feed", 0, 300, 2), ("lfi.stream.drain", 30, 50, 1),
          ("lfi.stream.take", 60, 90, 1), ("lfi.stream.frame", 90, 400, 1),
          ("lfi.stream.feed", 310, 600, 2), ("lfi.stream.drain", 410, 450, 1),
          ("lfi.stream.take", 460, 470, 1), ("lfi.stream.frame", 470, 800, 1),
          ("lfi.stream.drain", 810, 1100, 1), ("lfi.stream.feed", 1010, 1200, 2)]


def _trace(tmp_path, spans, frames: int):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "lfibench.traced", "ts": 0,
           "dur": 1000, "pid": 1, "tid": 1}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a, "pid": 1,
            "tid": tid} for n, a, b, tid in spans]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.Trace(str(path), frames)


@pytest.mark.parametrize("name, us", [("stream.feed_ms", 300 + 290),
                                      ("stream.take_ms", 30 + 10),
                                      ("stream.drain_ms", 20 + 40 + 290)])
def test_the_stream_readers_on_a_known_trace(tmp_path, name, us):
    """Each reads the host time of its spans that start inside the
    sub-window, on any thread, over the frames completed there; nothing
    (not 0) without such spans, as a program without them gives, or
    without a frame."""
    read = harness.load_module("metrics", name).read
    rec = type("Rec", (), {"trace": _trace(tmp_path, STREAM, 2)})()
    assert read(rec) == pytest.approx(us / 2 / 1e3)
    span = "lfi." + name[:-3]
    rec.trace = _trace(tmp_path, [s for s in STREAM if s[0] != span], 2)
    assert read(rec) is None
    rec.trace = _trace(tmp_path, STREAM, 0)
    assert read(rec) is None
    rec.trace = None
    assert read(rec) is None
