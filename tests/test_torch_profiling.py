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
