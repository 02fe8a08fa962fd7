"""Tests of the port that need a CUDA device: the hand-written kernel
against its plain PyTorch version and the NumPy oracle, through the wrapper
and through the Interpolator.

Each test takes the `cuda_device` fixture, which skips without a card.
This file imports no jax, so it also runs on a GPU host that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.io.loader import LightField
from lfinterpolator_tpu.ops import reference
from lfinterpolator_tpu_torch.ops import shift_blend
from lfinterpolator_tpu_torch.state import to_device_state

torch.set_num_threads(1)

# (cols, rows, H, W, V)
SCENES = [
    (1, 1, 48, 64, 1),
    (3, 5, 45, 70, 7),
    (4, 4, 48, 64, 64),
    (2, 2, 9, 300, 33),  # ragged row tile and view chunk
]
FOCI = [0.25, -0.6, 4.0]  # the last pushes shifts past the image


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _scene(cols, rows, h, w, v, focus, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)
    se = geometry.parse_trajectory("0,0,1,1", (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    return images, wm, geometry.focused_offsets(offsets, focus)


@pytest.mark.cuda
@pytest.mark.parametrize("focus", FOCI)
@pytest.mark.parametrize(
    "scene", SCENES, ids=lambda s: f"{s[0]}x{s[1]}_{s[2]}x{s[3]}_v{s[4]}"
)
def test_kernel_matches_plain_version_and_oracle(scene, focus, cuda_device):
    images, wm, fo = _scene(*scene, focus)
    args = to_device_state(images, wm, fo, cuda_device)
    before = shift_blend.launches
    got = shift_blend.shift_blend(*args)
    torch.cuda.synchronize()
    assert shift_blend.launches == before + 1
    assert torch.equal(got, shift_blend.shift_blend_reference(*args))
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).cpu().numpy(),
        reference.blend_fixed(images, wm, fo),
    )


@pytest.mark.cuda
def test_wrapper_rejects_too_many_images(cuda_device):
    x = torch.zeros((257, 3, 4, 4), dtype=torch.uint8, device=cuda_device)
    w = torch.zeros((2, 257), dtype=torch.float32, device=cuda_device)
    s = torch.zeros((257, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="at most 256"):
        shift_blend.shift_blend(x, w, s)


@pytest.mark.cuda
def test_launch_error_raises(cuda_device, monkeypatch):
    from lfinterpolator_tpu_torch.ops import _build

    lib = _build.load()

    class Failing:
        lfi_shift_blend_max_grid = lib.lfi_shift_blend_max_grid
        lfi_cuda_error_string = lib.lfi_cuda_error_string

        @staticmethod
        def lfi_shift_blend(*args):
            return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(_build, "load", lambda: Failing)
    images, wm, fo = _scene(2, 2, 8, 8, 2, 0.0)
    before = shift_blend.launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        shift_blend.shift_blend(*to_device_state(images, wm, fo, cuda_device))
    assert shift_blend.launches == before


@pytest.mark.cuda
def test_interpolator_ten_equals_std_on_cuda(cuda_device):
    from lfinterpolator_tpu_torch.api import Interpolator

    images, _, _ = _scene(4, 4, 48, 64, 1, 0.0)
    interp = Interpolator(LightField(images, 4, 4), device=cuda_device,
                          progress=False)
    before = shift_blend.launches
    ten = interp.interpolate("0,0,1,1", focus=0.3, method="TEN",
                             benchmark_runs=2, progress=False)
    assert shift_blend.launches == before + 3
    std = interp.interpolate("0,0,1,1", focus=0.3, method="STD", progress=False)
    np.testing.assert_array_equal(ten.views, std.views)
    assert len(ten.run_times_s) == 2 and ten.avg_ms > 0
