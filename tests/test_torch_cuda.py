"""Tests of the port that need a CUDA device: the hand-written kernels
(shift_blend, focus_estimate with both tap rules, allfocus_blend) against
their plain PyTorch versions and the NumPy oracle, through the wrappers and
through the Interpolator. Tolerance: bit-equal throughout (maps are
argmin bytes; the blends sum exact products in the oracle's order).

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
from lfinterpolator_tpu_torch.ops import allfocus_blend, focus_estimate, shift_blend
from lfinterpolator_tpu_torch.state import FocusTables, focus_tables, to_device_state

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


# (cols, rows, H, W, K, steps, focus, range, radius): odd sizes, negative
# focus, taps far past the border, K = 1, steps = 2, and K at the maximum
ESTIMATES = [
    (4, 4, 37, 53, 5, 6, 0.1, 0.4, (4, 2)),
    (4, 4, 40, 64, 8, 8, -0.4, 0.6, (4, 2)),
    (4, 4, 24, 40, 6, 5, 1.5, 2.0, (6, 3)),
    (3, 5, 9, 300, 1, 4, 0.2, 0.3, (2, 2)),
    (4, 4, 30, 44, 4, 2, -0.1, 0.6, (3, 1)),
    (8, 8, 33, 47, 32, 32, 0.1, 0.3, (2, 2)),
    (16, 16, 6, 10, 256, 3, 0.2, 0.5, (2, 2)),
]


def _estimate_case(cols, rows, h, w, k, steps, focus, frange, radius, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)
    se = geometry.parse_trajectory("0,0,1,1", (cols, rows))
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    ids = geometry.select_focus_views(se, cols, rows, k)
    return images, offsets, ids


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _tables(focus, frange, steps, device):
    return FocusTables(*(_t(t, device) for t in focus_tables(focus, frange, steps)))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize(
    "case", ESTIMATES, ids=lambda c: f"{c[0]}x{c[1]}_{c[2]}x{c[3]}_k{c[4]}_s{c[5]}"
)
def test_focus_estimate_matches_plain_version_and_oracle(case, exact, cuda_device):
    cols, rows, h, w, k, steps, focus, frange, radius = case
    images, offsets, ids = _estimate_case(*case)
    selected = _t(images[ids][..., :3].transpose(0, 3, 1, 2), cuda_device)
    args = (selected, _t(offsets[ids], cuda_device),
            _tables(focus, frange, steps, cuda_device), radius, exact)
    rule = "exact" if exact else "fast"
    before = focus_estimate.launches[rule]
    got = focus_estimate.focus_estimate(*args)
    torch.cuda.synchronize()
    assert focus_estimate.launches[rule] == before + 1
    assert torch.equal(got, focus_estimate.focus_estimate_reference(*args))
    if exact:
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            reference.focus_map_estimate(images, offsets, ids, focus, frange,
                                         radius, steps=steps),
        )


# (cols, rows, H, W, V, focus, range): odd sizes, a ragged row tile and view
# chunk, shifts past the image, G at the maximum
ALLFOCUS = [
    (3, 5, 45, 70, 7, 0.1, 0.3),
    (4, 4, 48, 64, 64, -0.6, 1.5),
    (2, 2, 9, 300, 33, 2.0, 3.0),
    (16, 16, 12, 20, 40, 0.2, 0.5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["raw", "filtered"])
@pytest.mark.parametrize(
    "case", ALLFOCUS, ids=lambda c: f"{c[0]}x{c[1]}_{c[2]}x{c[3]}_v{c[4]}"
)
def test_allfocus_blend_matches_plain_version_and_oracle(case, kind, cuda_device):
    cols, rows, h, w, v, focus, frange = case
    images, wm, _ = _scene(cols, rows, h, w, v, 0.0)
    se = geometry.parse_trajectory("0,0,1,1", (cols, rows))
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    rng = np.random.default_rng(3)
    tables = focus_tables(focus, frange, 8)
    fmap = (tables.candidate_bytes[rng.integers(0, 8, (h, w))] if kind == "raw"
            else rng.integers(0, 256, (h, w), dtype=np.uint8))
    args = (_t(images[..., :3].transpose(0, 3, 1, 2), cuda_device),
            _t(wm.astype(np.float32), cuda_device), _t(offsets, cuda_device),
            _t(fmap, cuda_device), _t(tables.decode, cuda_device))
    before = allfocus_blend.launches
    got = allfocus_blend.allfocus_blend(*args)
    torch.cuda.synchronize()
    assert allfocus_blend.launches == before + 1
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).cpu().numpy(),
        reference.blend_allfocus(images, wm, offsets, fmap, focus, frange),
    )
    plain = allfocus_blend.allfocus_blend_reference(*args)
    # The plain version's f32 torch.matmul sums G in cuBLAS's own order,
    # which past G = 64 need not be ascending; the kernel's sum is the
    # oracle's (above), so against the plain version it is held to 1 LSB.
    assert (got.int() - plain.int()).abs().max() <= 1
    if cols * rows <= 64:
        assert torch.equal(got, plain)


@pytest.mark.cuda
def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    tables = _tables(0.1, 0.3, 4, cuda_device)
    sel = torch.zeros((257, 3, 4, 4), dtype=torch.uint8, device=cuda_device)
    offs = torch.zeros((257, 2), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="at most 256 focus views"):
        focus_estimate.focus_estimate(sel, offs, tables, (2, 2))
    with pytest.raises(ValueError, match="at most 256 candidates"):
        focus_estimate.focus_estimate(sel[:2], offs[:2],
                                      _tables(0.1, 0.3, 257, cuda_device), (2, 2))
    with pytest.raises(ValueError, match=r"\[K, C, H, W\] uint8"):
        focus_estimate.focus_estimate(sel[:2].float(), offs[:2], tables, (2, 2))
    with pytest.raises(ValueError, match="different devices"):
        focus_estimate.focus_estimate(sel[:2], offs[:2].cpu(), tables, (2, 2))

    img = torch.zeros((257, 3, 4, 4), dtype=torch.uint8, device=cuda_device)
    w = torch.zeros((2, 257), dtype=torch.float32, device=cuda_device)
    fmap = torch.zeros((4, 4), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="at most 256 grid images"):
        allfocus_blend.allfocus_blend(img, w, offs, fmap, tables.decode)
    with pytest.raises(ValueError, match="weights must be"):
        allfocus_blend.allfocus_blend(img, w.half(), offs, fmap, tables.decode)
    with pytest.raises(ValueError, match="different devices"):
        allfocus_blend.allfocus_blend(img[:2], w[:, :2], offs[:2], fmap.cpu(),
                                      tables.decode)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["focus_estimate", "allfocus_blend"])
def test_new_kernels_launch_error_raises(kernel, cuda_device, monkeypatch):
    from lfinterpolator_tpu_torch.ops import _build

    lib = _build.load()

    class Failing:
        lfi_cuda_error_string = lib.lfi_cuda_error_string
        lfi_focus_estimate_max_views = lib.lfi_focus_estimate_max_views
        lfi_focus_estimate_max_steps = lib.lfi_focus_estimate_max_steps
        lfi_allfocus_blend_max_grid = lib.lfi_allfocus_blend_max_grid

        @staticmethod
        def lfi_focus_estimate(*args):
            return 9  # cudaErrorInvalidConfiguration

        lfi_allfocus_blend = lfi_focus_estimate

    monkeypatch.setattr(_build, "load", lambda: Failing)
    images, offsets, ids = _estimate_case(2, 2, 8, 8, 2, 4, 0.1, 0.3, (2, 2))
    tables = _tables(0.1, 0.3, 4, cuda_device)
    planar = _t(images[..., :3].transpose(0, 3, 1, 2), cuda_device)
    offs = _t(offsets, cuda_device)
    if kernel == "focus_estimate":
        before = dict(focus_estimate.launches)
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            focus_estimate.focus_estimate(planar, offs, tables, (2, 2))
        assert focus_estimate.launches == before
    else:
        before = allfocus_blend.launches
        w = torch.full((3, 4), 0.25, dtype=torch.float32, device=cuda_device)
        fmap = torch.zeros((8, 8), dtype=torch.uint8, device=cuda_device)
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            allfocus_blend.allfocus_blend(planar, w, offs, fmap, tables.decode)
        assert allfocus_blend.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("method", ["TEN", "STD"])
def test_interpolator_allfocus_on_cuda_equals_cpu(method, exact, cuda_device):
    from lfinterpolator_tpu.core.config import RenderConfig
    from lfinterpolator_tpu_torch.api import Interpolator

    images, _, _ = _scene(4, 4, 48, 64, 1, 0.0)
    lf = LightField(images, 4, 4)
    cfg = RenderConfig(focus_map_views=8, focus_steps=8, filter_radius_divisor=1,
                       exact_focus_taps=exact)
    kw = dict(focus=0.1, focus_range=0.3, method=method, progress=False)
    rule = "exact" if exact else "fast"
    before = (focus_estimate.launches[rule], allfocus_blend.launches)
    got = Interpolator(lf, config=cfg, device=cuda_device, progress=False
                       ).interpolate("0,0,1,1", benchmark_runs=2, **kw)
    assert (focus_estimate.launches[rule], allfocus_blend.launches) == (
        before[0] + 3, before[1] + 3)
    want = Interpolator(lf, config=cfg, device="cpu", progress=False
                        ).interpolate("0,0,1,1", **kw)
    np.testing.assert_array_equal(got.maps, want.maps)
    np.testing.assert_array_equal(got.views, want.views)
    assert len(got.run_times_s) == 2 and got.avg_ms > 0
