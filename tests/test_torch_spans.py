"""The port's spans (``lfinterpolator_tpu_torch/utils/profiling.span``) on
the CPU, under the port's own exporter ``profiling.trace``: each public
call's span holds the spans of its layers, nested by time on the calling
thread; with no profiler running a span is one shared no-op. The estimate's
``lfi.estimate.flags`` opens only on the card (tests/test_torch_cuda.py)."""

import ast
import contextlib
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from lfinterpolator_tpu_torch.api import Interpolator
from lfinterpolator_tpu_torch.core.config import RenderConfig
from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.streaming import StreamingRenderer
from lfinterpolator_tpu_torch.utils import profiling

torch.set_num_threads(1)

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / "lfinterpolator_tpu_torch"
API = {"lfi.params", "lfi.plan", "lfi.upload"}
DOWNLOAD = {"lfi.download.start", "lfi.download.wait"}
QUILT_HOST = {"lfi.quilt.hwc", "lfi.quilt.download"}
STREAM = {"lfi.stream.feed", "lfi.stream.take", "lfi.stream.frame", "lfi.stream.drain"}
#: Each render kind: the call, its top span and the spans inside it.
KINDS = {
    "fixed": (lambda i: i.interpolate("0,0,1,1", focus=0.1, method="TEN", progress=False),
              "lfi.interpolate", API | {"lfi.blend"} | DOWNLOAD),
    "allfocus": (lambda i: i.interpolate("0.1,0.2,0.9,0.7", focus=0.1, focus_range=0.3,
                                         method="TEN", progress=False),
                 "lfi.interpolate",
                 API | {"lfi.estimate", "lfi.filter", "lfi.blend"} | DOWNLOAD),
    "quilt": (lambda i: i.render_quilt("0,0,1,1", focus=0.1, method="TEN", cols=2, rows=2,
                                       progress=False),
              "lfi.render_quilt", API | {"lfi.blend"} | QUILT_HOST | DOWNLOAD),
    "batch": (lambda i: i.interpolate_batch(["0,0,1,1", "0.2,0.2,0.8,0.8"], focus=0.1,
                                            method="STD", progress=False),
              "lfi.interpolate_batch", API | {"lfi.blend"} | DOWNLOAD),
}


@pytest.fixture(scope="module")
def interp():
    rng = np.random.default_rng(13)
    images = rng.integers(0, 256, (16, 24, 40, 3), dtype=np.uint8)
    return Interpolator(LightField(images, 4, 4), config=RenderConfig(focus_map_views=8),
                        device="cpu", progress=False)


def _spans(path) -> list[dict]:
    events = json.loads((path / "trace.json").read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X" and e["name"].startswith("lfi")]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_call_emits_its_layers_spans_nested_on_one_thread(interp, kind, tmp_path):
    call, top, inside = KINDS[kind]
    with profiling.trace(str(tmp_path)):
        call(interp)
    spans = _spans(tmp_path)
    tops = [e for e in spans if e["name"] == top]
    assert len(tops) == 1
    start, end = float(tops[0]["ts"]), float(tops[0]["ts"]) + float(tops[0]["dur"])
    assert {e["name"] for e in spans} == inside | {top}
    for e in spans:
        assert e["name"].startswith("lfi.") and not e["name"].startswith("lfibench.")
        assert (e["pid"], e["tid"]) == (tops[0]["pid"], tops[0]["tid"])
        assert start <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= end + 1e-3


def test_the_spans_of_a_call_follow_its_steps_in_order(interp, tmp_path):
    call, _, _ = KINDS["allfocus"]
    with profiling.trace(str(tmp_path)):
        call(interp)
    order = [e["name"] for e in sorted(_spans(tmp_path), key=lambda e: float(e["ts"]))]
    assert order == ["lfi.interpolate", "lfi.params", "lfi.plan", "lfi.upload", "lfi.estimate",
                     "lfi.filter", "lfi.blend", "lfi.download.start", "lfi.download.wait"]


@pytest.mark.parametrize("method, order", [
    ("TEN", ["lfi.render_quilt", "lfi.params", "lfi.upload", "lfi.plan", "lfi.blend",
             "lfi.quilt.hwc", "lfi.download.start", "lfi.quilt.download",
             "lfi.download.wait"]),
    ("STD", ["lfi.render_quilt", "lfi.params", "lfi.plan", "lfi.upload", "lfi.blend",
             "lfi.quilt.hwc", "lfi.download.start", "lfi.quilt.download",
             "lfi.download.wait"]),
])
def test_a_quilt_names_its_blend_then_its_canvas_on_the_way_to_the_host(interp, method, order,
                                                                        tmp_path):
    """Both routes of ``render_quilt`` (TEN: the fused blend; STD: the views,
    then the tile copy) end with the canvas's HWC copy and its download,
    each in a span of its own inside the call, after the blend: the
    downloader's ``start`` opens inside the HWC span and its ``wait``
    inside the download span."""
    with profiling.trace(str(tmp_path)):
        res = interp.render_quilt("0,0,1,1", focus=0.1, method=method, cols=2, rows=2,
                                  progress=False)
    assert res.fused is (method == "TEN") and res.quilt.shape == (2 * 24, 2 * 40, 3)
    spans = sorted(_spans(tmp_path), key=lambda e: float(e["ts"]))
    assert [e["name"] for e in spans] == order
    blend, hwc, start, download, wait = spans[-5:]

    def end(e):
        return float(e["ts"]) + float(e["dur"])

    assert end(blend) <= float(hwc["ts"])
    assert end(hwc) <= float(download["ts"])
    assert float(hwc["ts"]) <= float(start["ts"]) and end(start) <= end(hwc) + 1e-3
    assert float(download["ts"]) <= float(wait["ts"]) and end(wait) <= end(download) + 1e-3


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_without_a_profiler_a_span_is_the_shared_no_op(interp, kind, tmp_path):
    """No region is opened while nobody profiles: the span is the one
    shared null context, and a profiler started afterwards records none of
    the spans the call made before it."""
    entered = []
    original = torch.profiler.record_function

    class Spy(original):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    with contextlib.ExitStack() as stack:
        stack.callback(setattr, torch.profiler, "record_function", original)
        torch.profiler.record_function = Spy
        assert profiling.span("lfi.anything") is profiling.span("lfi.other")
        assert isinstance(profiling.span("lfi.anything"), contextlib.nullcontext)
        KINDS[kind][0](interp)
        assert entered == []
        with profiling.trace(str(tmp_path)):
            torch.ones(2).add_(1)
        assert _spans(tmp_path) == []
        with profiling.trace(str(tmp_path)):
            assert isinstance(profiling.span("lfi.anything"), original)


def test_every_span_the_port_names_starts_with_lfi():
    """Every literal name passed to ``profiling.span`` in the port."""
    names = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    assert names >= set().union(*(v[2] | {v[1]} for v in KINDS.values())) | {
        "lfi.estimate.flags"} | STREAM
    assert all(n.startswith("lfi.") and not n.startswith("lfibench.") for n in names), names


def test_trace_records_the_spans_of_every_thread(interp, tmp_path):
    """``profiling.trace`` records a caller's other threads too, where the
    installed torch can."""
    if profiling._all_threads_config() is None:
        pytest.skip("this torch records the launching thread only")
    worker = threading.Thread(target=KINDS["fixed"][0], args=(interp,))
    with profiling.trace(str(tmp_path)):
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive()
    spans = _spans(tmp_path)
    assert {e["tid"] for e in spans if e["name"] == "lfi.interpolate"} == {worker.native_id}


def _stream(frames: int = 2) -> list:
    """An all-in-focus stream of a 4x4 grid of 24x40, every frame estimated;
    the first frame is decoded 50 ms late, so the render loop asks for it
    before it is there."""
    rng = np.random.default_rng(29)
    renderer = StreamingRenderer(4, 4, 40, 24, "0,0,1,1", device="cpu", prefetch=1,
                                 config=RenderConfig(focus=0.1, focus_range=0.3,
                                                     focus_map_views=16, focus_steps=8))

    def decoded():
        time.sleep(0.05)
        for _ in range(frames):
            yield rng.integers(0, 256, (16, 24, 40, 3), dtype=np.uint8)

    return list(renderer.render_stream(decoded()))


def test_a_stream_feeds_on_its_own_thread_and_renders_each_frame_in_a_span(tmp_path):
    """The decode thread's ``lfi.stream.feed`` is on a thread of its own;
    the render loop's ``lfi.stream.take``, ``lfi.stream.frame`` (holding
    the frame's estimate, filter, blend and download start) and
    ``lfi.stream.drain`` (holding the download's wait) are on the caller's,
    one each a frame; the first frame, asked for before it was decoded,
    counts as a ``stream stalls``."""
    if profiling._all_threads_config() is None:
        pytest.skip("this torch records the launching thread only")
    profiling.reset_launch_counts()
    with profiling.trace(str(tmp_path)):
        out = _stream(2)
    assert len(out) == 2 and all(maps.shape == (2, 24, 40) for _, maps in out)
    assert 1 <= profiling.launch_counts()["stream stalls"] <= 2
    assert "stream stalls" in profiling.OTHER_COUNTS
    spans = sorted(_spans(tmp_path), key=lambda e: float(e["ts"]))
    caller = threading.get_native_id()
    by = {n: [e for e in spans if e["name"] == n] for n in STREAM}
    assert [len(by[n]) for n in sorted(STREAM)] == [2, 2, 2, 3]  # drain, feed, frame, take
    assert {e["tid"] for e in by["lfi.stream.feed"]} == {e["tid"] for e in by["lfi.stream.feed"][:1]}
    assert by["lfi.stream.feed"][0]["tid"] != caller
    for n in STREAM - {"lfi.stream.feed"}:
        assert {e["tid"] for e in by[n]} == {caller}, n

    def inside(name, outer):
        return [e for e in spans if e["name"] == name and any(
            float(o["ts"]) <= float(e["ts"]) and float(e["ts"]) + float(e["dur"])
            <= float(o["ts"]) + float(o["dur"]) + 1e-3 for o in by[outer])]

    for name in ("lfi.estimate", "lfi.filter", "lfi.blend", "lfi.download.start"):
        assert len(inside(name, "lfi.stream.frame")) == 2, name
    assert len(inside("lfi.download.wait", "lfi.stream.drain")) == 2
    assert len([e for e in spans if e["name"].startswith("lfi.")]) == 9 + 4 * 2 + 2


def test_without_a_profiler_a_stream_opens_no_span(tmp_path):
    entered = []
    original = torch.profiler.record_function

    class Spy(original):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    with contextlib.ExitStack() as stack:
        stack.callback(setattr, torch.profiler, "record_function", original)
        torch.profiler.record_function = Spy
        assert len(_stream(2)) == 2
        assert entered == []
        assert profiling.span("lfi.stream.feed") is profiling.span("lfi.stream.take")
