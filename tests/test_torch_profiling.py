"""Timing helpers of the port (lfinterpolator_tpu_torch/utils/profiling.py)
on the CPU, where they read the host clock. The CUDA-event path runs on the
card through the Interpolator (tests/test_torch_cuda.py)."""

import time

import pytest
import torch

from lfinterpolator_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.mark.parametrize("runs", [1, 3])
def test_benchmark_times_each_run(runs):
    calls = []

    def step():
        calls.append(1)
        time.sleep(0.002)

    res = profiling.benchmark(step, runs=runs, device="cpu")
    assert len(calls) == runs == len(res.times_s)
    assert all(t >= 0.002 for t in res.times_s)
    assert res.device == "cpu"
    assert res.avg_ms == pytest.approx(1000 * sum(res.times_s) / runs)


def test_timer_on_cpu_reads_the_host_clock():
    with profiling.Timer("cpu") as t:
        time.sleep(0.003)
    assert t.elapsed_s >= 0.003
    assert profiling.device_name("cpu") == "cpu"


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import json

    import numpy as np

    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.io import LightField

    images = np.random.default_rng(3).integers(0, 256, (4, 16, 24, 3), dtype=np.uint8)
    interp = Interpolator(LightField(images, 2, 2), device="cpu", progress=False)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.matmul(torch.ones(16, 16), torch.ones(16, 16))
        interp.interpolate("0,0,1,1", focus=0.1, progress=False)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in a.key for a in prof.key_averages())
    assert any(e.get("name") == "lfi.interpolate" and e.get("cat") == "user_annotation"
               for e in events)


def test_launch_counts_keep_streamed_launches_apart():
    """One table of counts: ``count`` adds one to a key; a key never counted
    reads 0, so a stream's launches, which count as ``shift_blend``, have no
    key of their own; the read is a copy; a reset clears every count."""
    profiling.reset_launch_counts()
    for key in ("shift_blend", "capacity budget reads", "shift_blend"):
        profiling.count(key)
    counts = profiling.launch_counts()
    assert counts == {"shift_blend": 2, "capacity budget reads": 1}
    assert counts["shift_blend (stream)"] == counts["focus_estimate_exact"] == 0
    counts["shift_blend"] += 5
    assert profiling.launch_counts()["shift_blend"] == 2
    profiling.reset_launch_counts()
    assert profiling.launch_counts() == {}


def test_card_line_on_the_cpu():
    assert profiling.card_line("cpu") == "cpu"

