"""Tests of the port that need a CUDA device: the hand-written kernels
(shift_blend and its quilt instantiation, focus_estimate with both tap
rules and the presence-predicated refine pass, its map pass, nine-tap loop
and RGBx pack alone, allfocus_blend, the quilt tile copy) against their plain PyTorch versions and the NumPy oracle,
through the wrappers, the Interpolator (also batched trajectories and
forced view batches) and the StreamingRenderer. Tolerance: maps (argmin
bytes) and the tile copy (moved bytes) are bit-equal to their plain
versions and oracles. The blend kernels sum on the tensor cores, so against
the plain version, the oracle and the CPU they obey the near-tie rule
(``blend_torch.check_bytes``: the byte is clip(rint(exact sum)) wherever the
exact sum is further than 2^-8 from a half-integer, else one of the two
neighbours) and differ by at most 1 LSB; kernel against kernel (streams,
view batches, batched trajectories, quilt tiles) stays bit-equal.

Each test takes the `cuda_device` fixture, which skips without a card.
Since the multi-GPU slice every kernel on a rank's path also renders a
block of rows (``row_start``/``row_count``): the block is torch.equal to
the same rows of the whole-frame launch. This file imports no jax, so it
also runs on a GPU host that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.ops import reference
from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.ops import (
    allfocus_blend, blend_torch, focus_estimate, focus_torch, quilt, quilt_torch,
    shift_blend)
from lfinterpolator_tpu_torch.ops.estimate_geometry import FocusTables, Pyramid
from lfinterpolator_tpu_torch.state import focus_tables, to_device_state
from lfinterpolator_tpu_torch.utils import profiling

torch.set_num_threads(1)

# (cols, rows, H, W, V)
SCENES = [
    (1, 1, 48, 64, 1),
    (3, 5, 45, 70, 7),
    (4, 4, 48, 64, 64),
    (2, 2, 9, 300, 33),  # ragged row tile and view chunk
    (2, 2, 12, 20, 26),  # W no multiple of 16, G = 4 padded to 16
    (16, 16, 6, 37, 64),  # G = 256
    (4, 4, 10, 50, 320),  # five view chunks
]
FOCI = [0.25, -0.6, 4.0]  # the last pushes shifts past the image


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _launched(before):
    """What ``profiling.launch_counts()`` counted since `before`."""
    return profiling.launch_counts() - before


def _one_lsb(got, want):
    """`got` (a blend kernel's bytes) within 1 LSB of `want` (the plain
    version, the oracle or the CPU render) everywhere."""
    got, want = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a).astype(int)
                 for a in (got, want))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def _near_tie(got, stack, weights):
    """The near-tie rule on views `got` [V, C, H, W] against the exact sums
    of `stack` [G, C, H, W] (shifted or selected images) under `weights`."""
    counts = blend_torch.check_bytes(got, blend_torch.exact_sums(stack, weights))
    assert counts["bytes"] == got.numel()


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
    before = profiling.launch_counts()
    got = shift_blend.shift_blend(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {"shift_blend": 1}
    _near_tie(got, blend_torch.shift_stack(args[0], args[2]), args[1])
    _one_lsb(got, shift_blend.shift_blend_reference(*args))
    _one_lsb(got.permute(0, 2, 3, 1), reference.blend_fixed(images, wm, fo))


@pytest.mark.cuda
@pytest.mark.parametrize("g, v, c, h, w, reach", [
    (7, 1, 3, 5, 19, 40),  # V = 1, W no multiple of 16, |dx| >= W
    (16, 26, 3, 9, 70, 100),  # a view batch of 26, |dx| >= W
    (64, 320, 1, 4, 130, 3),  # five view chunks
    (256, 64, 4, 3, 261, 300),  # G = 256, four channels
], ids=["v1", "v26", "v320", "g256"])
def test_blend_kernels_obey_the_near_tie_rule_with_random_weights(
        g, v, c, h, w, reach, cuda_device):
    """Random fp16 weights (a wrong fragment permutes them) and shifts up to
    `reach` past the image on arbitrary shapes; rows of the matrix alone are
    bit-equal to the same rows of the whole launch."""
    rng = np.random.default_rng(g + v)
    images = _t(rng.integers(0, 256, (g, c, h, w), dtype=np.uint8), cuda_device)
    weights = _t((rng.random((v, g)) * 4 / g).astype(np.float16).astype(np.float32),
                 cuda_device)
    shifts = _t(rng.integers(-reach, reach + 1, (g, 2)).astype(np.int32), cuda_device)
    got = shift_blend.shift_blend(images, weights, shifts)
    _near_tie(got, blend_torch.shift_stack(images, shifts), weights)
    _one_lsb(got, shift_blend.shift_blend_reference(images, weights, shifts))
    offsets = _t((rng.random((g, 2)) * 2 * reach - reach).astype(np.float32), cuda_device)
    decode = _t(np.linspace(-1.0, 1.0, 256).astype(np.float32), cuda_device)
    fmap = _t(rng.integers(0, 256, (h, w), dtype=np.uint8), cuda_device)
    af = allfocus_blend.allfocus_blend(images, weights, offsets, fmap, decode)
    _near_tie(af, blend_torch.allfocus_selected(images, offsets, fmap, decode), weights)
    _one_lsb(af, allfocus_blend.allfocus_blend_reference(
        images, weights, offsets, fmap, decode))
    for lo, hi in ((0, 1), (v // 3, min(v, v // 3 + 64)), (v - 1, v)):
        rows = weights[lo:hi].contiguous()
        assert torch.equal(shift_blend.shift_blend(images, rows, shifts), got[lo:hi])
        assert torch.equal(
            allfocus_blend.allfocus_blend(images, rows, offsets, fmap, decode), af[lo:hi])


@pytest.mark.cuda
def test_zero_padding_of_the_weight_matrix_changes_nothing(cuda_device):
    """Zero rows (views) and zero columns (extra images) leave every byte."""
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (20, 3, 9, 70), dtype=np.uint8)
    weights = (rng.random((26, 20)) / 5).astype(np.float16).astype(np.float32)
    shifts = rng.integers(-9, 10, (20, 2)).astype(np.int32)
    got = shift_blend.shift_blend(*(_t(a, cuda_device) for a in (images, weights, shifts)))
    padded_w = np.zeros((64, 32), np.float32)
    padded_w[:26, :20] = weights
    padded = shift_blend.shift_blend(
        _t(np.concatenate([images, images[:12]]), cuda_device), _t(padded_w, cuda_device),
        _t(np.concatenate([shifts, shifts[:12]]), cuda_device))
    assert torch.equal(padded[:26], got)
    assert int(padded[26:].max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["shift_blend", "allfocus_blend"])
def test_refused_launch_surfaces_as_an_error(kernel, cuda_device, monkeypatch):
    """The C entry point refuses what the kernel cannot launch (here a grid
    past the most images it takes, 512, whose per-image tables and
    resident weights it does not size for) and the wrapper raises with
    CUDA's error."""
    from lfinterpolator_tpu_torch.ops import _build

    lib = _build.load()

    class Unlimited:
        def __getattr__(self, name):
            if name.endswith("_max_grid"):
                return lambda: 1 << 20
            return getattr(lib, name)

    monkeypatch.setattr(_build, "load", lambda: Unlimited())
    g = 600
    images = torch.zeros((g, 1, 4, 16), dtype=torch.uint8, device=cuda_device)
    weights = torch.zeros((2, g), dtype=torch.float32, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error"):
        if kernel == "shift_blend":
            shift_blend.shift_blend(images, weights, torch.zeros(
                (g, 2), dtype=torch.int32, device=cuda_device))
        else:
            allfocus_blend.allfocus_blend(
                images, weights, torch.zeros((g, 2), device=cuda_device),
                torch.zeros((4, 16), dtype=torch.uint8, device=cuda_device),
                torch.zeros(256, device=cuda_device))


@pytest.mark.cuda
def test_wrapper_rejects_too_many_images(cuda_device):
    g = blend_torch.MAX_GRID + 1
    x = torch.zeros((g, 3, 4, 4), dtype=torch.uint8, device=cuda_device)
    w = torch.zeros((2, g), dtype=torch.float32, device=cuda_device)
    s = torch.zeros((g, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match=f"at most {blend_torch.MAX_GRID} grid images"):
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
    before = profiling.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        shift_blend.shift_blend(*to_device_state(images, wm, fo, cuda_device))
    assert profiling.launch_counts() == before


@pytest.mark.cuda
def test_interpolator_ten_equals_std_on_cuda(cuda_device):
    from lfinterpolator_tpu_torch.api import Interpolator

    images, _, _ = _scene(4, 4, 48, 64, 1, 0.0)
    interp = Interpolator(LightField(images, 4, 4), device=cuda_device,
                          progress=False)
    before = profiling.launch_counts()
    ten = interp.interpolate("0,0,1,1", focus=0.3, method="TEN",
                             benchmark_runs=2, progress=False)
    assert _launched(before)["shift_blend"] == 3
    std = interp.interpolate("0,0,1,1", focus=0.3, method="STD", progress=False)
    _one_lsb(ten.views, std.views)
    assert len(ten.run_times_s) == 2 and ten.avg_ms > 0


# (cols, rows, H, W, K, steps, focus, range, radius): odd sizes that are no
# multiples of the kernels' tiles, negative focus, taps far past the border,
# K = 1, steps = 2, K at the maximum; a focus at which every row and column
# is dirty for every candidate (the nine-tap loop alone computes the map), a
# frame narrower and shorter than the radius (two candidates' maps a chunk),
# and the largest number of candidates (in chunks of 11)
ESTIMATES = [
    (4, 4, 37, 53, 5, 6, 0.1, 0.4, (4, 2)),
    (4, 4, 40, 64, 8, 8, -0.4, 0.6, (4, 2)),
    (4, 4, 24, 40, 6, 5, 1.5, 2.0, (6, 3)),
    (3, 5, 9, 300, 1, 4, 0.2, 0.3, (2, 2)),
    (4, 4, 30, 44, 4, 2, -0.1, 0.6, (3, 1)),
    (8, 8, 33, 47, 32, 32, 0.1, 0.3, (2, 2)),
    (16, 16, 6, 10, 256, 3, 0.2, 0.5, (2, 2)),
    (8, 8, 12, 20, 64, 4, 1.0, 0.5, (6, 5)),
    (2, 2, 9, 7, 4, 4, 0.2, 0.5, (10, 12)),
    (2, 2, 17, 45, 2, 256, 0.0, 2.0, (30, 4)),
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
    before = profiling.launch_counts()
    got = focus_estimate.focus_estimate(*args)
    torch.cuda.synchronize()
    rule = "focus_estimate_exact" if exact else "focus_estimate_fast"
    assert _launched(before) == {rule: 1}
    assert torch.equal(got, focus_estimate.focus_estimate_reference(*args))
    if exact:
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            reference.focus_map_estimate(images, offsets, ids, focus, frange,
                                         radius, steps=steps),
        )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ESTIMATES + [(4, 4, 20, 30, 4, 5, 0.1, 0.3, (0, 0))],
    ids=lambda c: f"{c[0]}x{c[1]}_{c[2]}x{c[3]}_k{c[4]}_s{c[5]}_r{c[8][0]}"
)
def test_estimate_passes_and_the_nine_tap_loop_alone(case, cuda_device):
    """The map pass equals focus_torch.cheby_map for every candidate; the
    exact rule with every flag cleared (the nine-tap loop alone), with only
    the rows or only the columns cleared, and with the real flags give equal
    bytes; the flags the wrapper computes on the card are the CPU's."""
    cols, rows, h, w, k, steps, focus, frange, radius = case
    images, offsets, ids = _estimate_case(*case)
    selected = _t(images[ids][..., :3].transpose(0, 3, 1, 2), cuda_device)
    tables = _tables(focus, frange, steps, cuda_device)
    args = (selected, _t(offsets[ids], cuda_device), tables, radius)
    maps = focus_estimate.cheby_maps(*args)
    torch.cuda.synchronize()
    assert tuple(maps.shape) == (steps, h + 2 * radius[1], w + 2 * radius[0])
    for i in {0, steps // 2, steps - 1}:
        assert torch.equal(maps[i], focus_torch.cheby_map(
            selected, args[1], tables.candidates[i], radius))
    flags = focus_torch.clean_flags(args[1], tables, radius, h, w)
    on_cpu = focus_torch.clean_flags(
        torch.from_numpy(offsets[ids]),
        FocusTables(*(torch.from_numpy(t) for t in focus_tables(focus, frange, steps))),
        radius, h, w)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(flags, on_cpu))
    if case[:2] == (8, 8) and radius == (6, 5):
        assert focus_torch.slow_share(*flags) == 1.0  # the all-dirty case is one
    if radius == (0, 0):
        assert focus_torch.slow_share(*flags) == 0.0
    want = focus_estimate.focus_estimate(*args)
    before = profiling.launch_counts()
    none = tuple(torch.zeros_like(f) for f in flags)
    for forced in (none, (none[0], flags[1]), (flags[0], none[1]), flags):
        assert torch.equal(focus_estimate.focus_estimate_flagged(*args, forced), want)
    assert _launched(before) == {"focus_estimate_exact": 4}
    with pytest.raises(ValueError, match="flags must be bool"):
        focus_estimate.focus_estimate_flagged(*args, (flags[0].cpu(), flags[1]))


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
    before = profiling.launch_counts()
    got = allfocus_blend.allfocus_blend(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {"allfocus_blend": 1}
    _near_tie(got, blend_torch.allfocus_selected(args[0], *args[2:]), args[1])
    _one_lsb(got.permute(0, 2, 3, 1),
             reference.blend_allfocus(images, wm, offsets, fmap, focus, frange))
    _one_lsb(got, allfocus_blend.allfocus_blend_reference(*args))


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

    g = blend_torch.MAX_GRID + 1
    img = torch.zeros((g, 3, 4, 4), dtype=torch.uint8, device=cuda_device)
    w = torch.zeros((2, g), dtype=torch.float32, device=cuda_device)
    fmap = torch.zeros((4, 4), dtype=torch.uint8, device=cuda_device)
    offs = torch.zeros((g, 2), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match=f"at most {blend_torch.MAX_GRID} grid images"):
        allfocus_blend.allfocus_blend(img, w, offs, fmap, tables.decode)
    with pytest.raises(ValueError, match="weights must be"):
        allfocus_blend.allfocus_blend(img, w.half(), offs, fmap, tables.decode)
    with pytest.raises(ValueError, match="different devices"):
        allfocus_blend.allfocus_blend(img[:2], w[:, :2], offs[:2], fmap.cpu(),
                                      tables.decode)


# test id -> the C entry whose launch fails: an estimate is three launches
# (the RGBx pack, the map pass, the argmin pass), and any of them may
FAILING = {"focus_estimate_rgbx": "lfi_rgbx_pack",
           "focus_estimate": "lfi_focus_cheby_map",
           "focus_estimate_argmin": "lfi_focus_estimate",
           "allfocus_blend": "lfi_allfocus_blend"}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(FAILING))
def test_new_kernels_launch_error_raises(kernel, cuda_device, monkeypatch):
    from lfinterpolator_tpu_torch.ops import _build

    lib = _build.load()

    class Failing:
        """The library with one entry that returns
        cudaErrorInvalidConfiguration and launches nothing."""

        def __getattr__(self, name):
            return (lambda *args: 9) if name == FAILING[kernel] else getattr(lib, name)

    monkeypatch.setattr(_build, "load", lambda: Failing())
    images, offsets, ids = _estimate_case(2, 2, 8, 8, 2, 4, 0.1, 0.3, (2, 2))
    tables = _tables(0.1, 0.3, 4, cuda_device)
    planar = _t(images[..., :3].transpose(0, 3, 1, 2), cuda_device)
    offs = _t(offsets, cuda_device)
    if kernel.startswith("focus_estimate"):
        before = profiling.launch_counts()
        for exact in (True, False):
            with pytest.raises(RuntimeError,
                               match=f"{FAILING[kernel]} launch failed: CUDA error 9"):
                focus_estimate.focus_estimate(planar, offs, tables, (2, 2), exact)
        assert profiling.launch_counts() == before
    else:
        before = profiling.launch_counts()
        w = torch.full((3, 4), 0.25, dtype=torch.float32, device=cuda_device)
        fmap = torch.zeros((8, 8), dtype=torch.uint8, device=cuda_device)
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            allfocus_blend.allfocus_blend(planar, w, offs, fmap, tables.decode)
        assert profiling.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 3, 5, 7), (2, 1, 8, 12), (5, 4, 6, 10), (1, 3, 33, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rgbx_pack_matches_plain_version(shape, cuda_device):
    """Odd pixel counts (one pixel a thread) and multiples of 4 (four), 1 to
    4 channels, and a strided view of a larger tensor."""
    rng = np.random.default_rng(sum(shape))
    sel = _t(rng.integers(0, 256, shape, dtype=np.uint8), cuda_device)
    got = focus_estimate.rgbx(sel)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and tuple(got.shape) == (shape[0], *shape[2:])
    assert torch.equal(got, focus_estimate.rgbx_reference(sel))
    half = sel[:, :, ::2, ::2]
    assert torch.equal(focus_estimate.rgbx(half), focus_estimate.rgbx_reference(half))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("method", ["TEN", "STD"])
def test_interpolator_allfocus_on_cuda_equals_cpu(method, exact, cuda_device):
    from lfinterpolator_tpu_torch.core.config import RenderConfig
    from lfinterpolator_tpu_torch.api import Interpolator

    images, _, _ = _scene(4, 4, 48, 64, 1, 0.0)
    lf = LightField(images, 4, 4)
    cfg = RenderConfig(focus_map_views=8, focus_steps=8, filter_radius_divisor=1,
                       exact_focus_taps=exact)
    kw = dict(focus=0.1, focus_range=0.3, method=method, progress=False)
    rule = "focus_estimate_exact" if exact else "focus_estimate_fast"
    before = profiling.launch_counts()
    got = Interpolator(lf, config=cfg, device=cuda_device, progress=False
                       ).interpolate("0,0,1,1", benchmark_runs=2, **kw)
    launched = _launched(before)
    assert (launched[rule], launched["allfocus_blend"]) == (3, 3)
    want = Interpolator(lf, config=cfg, device="cpu", progress=False
                        ).interpolate("0,0,1,1", **kw)
    np.testing.assert_array_equal(got.maps, want.maps)
    _one_lsb(got.views, want.views)
    assert len(got.run_times_s) == 2 and got.avg_ms > 0


def _masked_oracle(images, offsets, ids, cands, cand_bytes, radius, present):
    """reference.focus_map_estimate's search with a per-pixel candidate
    mask: a candidate that is not present never updates the best."""
    views = images[ids][..., :3].astype(np.int64)
    k, h, w = views.shape[:3]
    rx, ry = radius
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    best = np.full((h, w), np.iinfo(np.int64).max)
    best_i = np.zeros((h, w), dtype=np.int64)
    for i, f in enumerate(cands):
        lo = np.full((9, h, w, 3), 255, dtype=np.int64)
        hi = np.zeros((9, h, w, 3), dtype=np.int64)
        for v in range(k):
            cy = np.trunc(ys + f * offsets[ids[v], 1]).astype(np.int64)
            cx = np.trunc(xs + f * offsets[ids[v], 0]).astype(np.int64)
            for t, (sy, sx) in enumerate((a, b) for a in (-ry, 0, ry) for b in (-rx, 0, rx)):
                px = views[v][np.clip(cy + sy, 0, h - 1), np.clip(cx + sx, 0, w - 1)]
                lo[t] = np.minimum(lo[t], px)
                hi[t] = np.maximum(hi[t], px)
        cost = (hi - lo).max(axis=-1).sum(axis=0)
        better = (cost < best) & present[i]
        best = np.where(better, cost, best)
        best_i = np.where(better, i, best_i)
    return cand_bytes[best_i]


# (cols, rows, H, W, K, steps, radius, tb, wco, sc): presence grains of the
# JAX package's shapes (tb a multiple of 8, wco of 128) and smaller ones;
# then a radius at which 81% of the pairs are dirty, a frame narrower than
# the radius, K = 1, and K = 256 with 256 candidates in chunks
PRESENCE = [
    (4, 4, 40, 300, 8, 8, (4, 2), 16, 128, 4),
    (4, 4, 37, 53, 5, 6, (4, 2), 8, 32, 2),
    (8, 8, 48, 96, 32, 32, (2, 2), 24, 64, 4),
    (4, 4, 14, 70, 16, 8, (8, 6), 8, 32, 4),
    (2, 2, 9, 7, 4, 4, (10, 12), 8, 32, 1),
    (3, 5, 21, 33, 1, 4, (2, 2), 8, 32, 2),
    (16, 16, 6, 37, 256, 256, (30, 2), 8, 32, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", PRESENCE, ids=lambda c: f"{c[2]}x{c[3]}_k{c[4]}_s{c[5]}_tb{c[7]}_wco{c[8]}"
)
def test_presence_estimate_matches_plain_version_and_oracle(case, cuda_device):
    cols, rows, h, w, k, steps, radius, tb, wco, sc = case
    images, offsets, ids = _estimate_case(cols, rows, h, w, k, steps, 0.1, 0.5, radius)
    plan = Pyramid(scale=2, refine=1, radius_c=(1, 1), tb=tb, wco=wco, sc=sc,
                   nb=-(-h // tb), n_wc=-(-w // wco))
    rng = np.random.default_rng(7)
    pres = rng.integers(0, 2**sc, (plan.nb, plan.n_wc, -(-steps // sc)),
                        dtype=np.int32)
    selected = _t(images[ids][..., :3].transpose(0, 3, 1, 2), cuda_device)
    tables = _tables(0.1, 0.5, steps, cuda_device)
    args = (selected, _t(offsets[ids], cuda_device), tables, radius)
    before = profiling.launch_counts()
    got = focus_estimate.focus_estimate(*args, True, _t(pres, cuda_device), plan)
    torch.cuda.synchronize()
    assert _launched(before) == {"focus_estimate_pyramid": 1}
    plain = focus_torch.estimate_presence(*args, _t(pres, cuda_device), plan)
    assert torch.equal(got, plain)
    present = focus_torch.expand_presence(
        torch.from_numpy(pres), plan, steps, h, w).numpy()
    t = focus_tables(0.1, 0.5, steps)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        _masked_oracle(images, offsets, ids, t.candidates, t.candidate_bytes,
                       radius, present),
    )
    # every candidate present: the exact sweep
    full = torch.full_like(_t(pres, cuda_device), 2**sc - 1)
    assert torch.equal(focus_estimate.focus_estimate(*args, True, full, plan),
                       focus_estimate.focus_estimate(*args))
    # the nine-tap loop alone under the same presence words
    dirty = (torch.zeros((steps, h), dtype=torch.bool, device=cuda_device),
             torch.zeros((steps, w), dtype=torch.bool, device=cuda_device))
    assert torch.equal(focus_estimate.focus_estimate_flagged(
        *args, dirty, _t(pres, cuda_device), plan), plain)


@pytest.mark.cuda
def test_presence_estimate_rejects_what_the_kernel_does_not_take(cuda_device):
    images, offsets, ids = _estimate_case(2, 2, 16, 64, 2, 4, 0.1, 0.3, (2, 2))
    args = (_t(images[ids][..., :3].transpose(0, 3, 1, 2), cuda_device),
            _t(offsets[ids], cuda_device), _tables(0.1, 0.3, 4, cuda_device), (2, 2))
    plan = Pyramid(2, 1, (1, 1), tb=8, wco=32, sc=4, nb=2, n_wc=2)
    pres = torch.ones((2, 2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="exact taps"):
        focus_estimate.focus_estimate(*args, False, pres, plan)
    with pytest.raises(ValueError, match=r"pres must be \[2, 2, 1\] int32"):
        focus_estimate.focus_estimate(*args, True, pres[:1], plan)
    with pytest.raises(RuntimeError, match="lfi_focus_estimate_pres launch failed"):
        # a block height that is not a multiple of the kernel's 8 rows
        odd = plan._replace(tb=4, nb=4)
        focus_estimate.focus_estimate(
            *args, True, torch.ones((4, 2, 1), dtype=torch.int32, device=cuda_device), odd)


def _montage(tiles, cols, rows):
    """[N, H, W, C] -> [rows*H, cols*W, C], tile i at (i // cols, i % cols)."""
    h, w, c = tiles.shape[1:]
    out = np.zeros((rows * h, cols * w, c), tiles.dtype)
    for i in range(cols * rows):
        r, cl = divmod(i, cols)
        out[r * h:(r + 1) * h, cl * w:(cl + 1) * w] = tiles[i]
    return out


# (cols, rows, H, W, quilt cols, quilt rows, focus)
QUILTS = [
    (4, 4, 48, 64, 5, 9, 0.25),
    (3, 5, 45, 70, 2, 3, -0.6),
    (8, 8, 24, 136, 5, 9, 4.0),
    (2, 2, 9, 300, 7, 2, 0.1),  # 14 views: one mma row tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", QUILTS, ids=lambda c: f"{c[2]}x{c[3]}_{c[4]}x{c[5]}")
def test_quilt_blend_matches_plain_version_and_oracle(case, cuda_device):
    cols, rows, h, w, qc, qr, focus = case
    images, wm, fo = _scene(cols, rows, h, w, 64, focus)
    args = to_device_state(images, wm, fo, cuda_device)
    before = profiling.launch_counts()
    got = quilt.quilt_blend(*args, qc, qr)
    torch.cuda.synchronize()
    assert _launched(before) == {"quilt_blend": 1}
    assert got.shape == (3, qr * h, qc * w)
    # kernel against kernel: the canvas is the montage of shift_blend's views
    assert torch.equal(got, quilt_torch.montage(shift_blend.shift_blend(*args), qc, qr))
    _one_lsb(got, quilt.quilt_blend_reference(*args, qc, qr))
    tiles = got.reshape(3, qr, h, qc, w).permute(1, 3, 0, 2, 4).reshape(qc * qr, 3, h, w)
    _near_tie(tiles, blend_torch.shift_stack(args[0], args[2]), args[1][: qc * qr])
    want = _montage(reference.blend_fixed(images, wm[: qc * qr], fo), qc, qr)
    _one_lsb(got.permute(1, 2, 0), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(45, 3, 48, 64), (6, 3, 45, 70), (50, 1, 9, 301)],
                         ids=["aligned", "odd", "bytes"])
def test_quilt_copy_matches_plain_version_and_oracle(shape, cuda_device):
    cols, rows = (2, 3) if shape[0] == 6 else (5, 9)
    tiles = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    t = _t(tiles, cuda_device)
    before = profiling.launch_counts()
    got = quilt.quilt_copy(t, cols, rows)
    torch.cuda.synchronize()
    assert _launched(before) == {"quilt_copy": 1}
    assert torch.equal(got, quilt_torch.montage(t, cols, rows))
    np.testing.assert_array_equal(
        got.permute(1, 2, 0).cpu().numpy(),
        _montage(tiles.transpose(0, 2, 3, 1), cols, rows))
    with pytest.raises(ValueError, match="Quilt needs 45 views"):
        quilt.quilt_copy(t[:44] if shape[0] >= 45 else t, 5, 9)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw", [dict(method="TEN"), dict(method="STD"), dict(method="TEN", focus_range=0.3),
           dict(method="TEN", tile_size=(20, 40))],
    ids=["fused", "std", "allfocus", "resized"])
def test_render_quilt_on_cuda_equals_cpu(kw, cuda_device):
    from lfinterpolator_tpu_torch.core.config import RenderConfig
    from lfinterpolator_tpu_torch.api import Interpolator

    images, _, _ = _scene(4, 4, 48, 64, 1, 0.0)
    lf = LightField(images, 4, 4)
    cfg = RenderConfig(focus_map_views=8, focus_steps=8)
    before = profiling.launch_counts()
    got = Interpolator(lf, config=cfg, device=cuda_device, progress=False
                       ).render_quilt("0,0,1,1", focus=0.1, progress=False, **kw)
    fused = kw == dict(method="TEN")
    assert got.fused is fused
    key, other = ("quilt_blend", "quilt_copy") if fused else ("quilt_copy", "quilt_blend")
    launched = _launched(before)
    assert (launched[key], launched[other]) == (1, 0)
    want = Interpolator(lf, config=cfg, device="cpu", progress=False
                        ).render_quilt("0,0,1,1", focus=0.1, progress=False, **kw)
    if kw == dict(method="STD"):  # plain ops on both devices, no resize
        np.testing.assert_array_equal(got.quilt, want.quilt)
    elif "tile_size" in kw:  # a blend within 1 LSB, then the resize's f32 matmul
        assert np.abs(got.quilt.astype(int) - want.quilt.astype(int)).max() <= 2
    else:  # the blend kernel against its plain version
        _one_lsb(got.quilt, want.quilt)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["TEN", "STD"], ids=["fused", "two_stage"])
def test_render_quilt_downloads_its_canvas_into_pinned_memory_it_hands_over(
        method, cuda_device, monkeypatch):
    """Both routes download the canvas whole through the Interpolator's
    ``transfer.Downloader`` (one band a call): the quilt is the canvas's
    [H, W, C] bytes, in pinned host memory, and a kept quilt is not touched
    by a later call. 70 px tiles: a width no multiple of 128."""
    from lfinterpolator_tpu_torch.core.config import RenderConfig
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.utils import transfer

    canvases = []
    original = transfer.Downloader.start

    def start(self, views, maps=None, out=None):
        canvases.append(quilt_torch.to_hwc(views[0]).cpu().numpy())
        return original(self, views, maps, out)

    monkeypatch.setattr(transfer.Downloader, "start", start)
    images, _, _ = _scene(4, 4, 24, 70, 1, 0.0, seed=5)
    interp = Interpolator(LightField(images, 4, 4), config=RenderConfig(focus_steps=8),
                          device=cuda_device, progress=False)
    kept = []
    for focus in (0.1, 0.6):
        before = profiling.launch_counts()
        res = interp.render_quilt("0,0,1,1", focus=focus, method=method, cols=3, rows=2,
                                  progress=False)
        assert res.fused is (method == "TEN")
        assert _launched(before)["download bands"] == 1
        assert res.quilt.shape == (2 * 24, 3 * 70, 3) and res.quilt.flags.c_contiguous
        assert np.array_equal(res.quilt, canvases[-1])
        assert torch.from_numpy(res.quilt).is_pinned()
        kept.append((res.quilt, res.quilt.copy()))
    assert len(canvases) == 2 and not np.array_equal(canvases[0], canvases[1])
    assert not np.shares_memory(kept[0][0], kept[1][0])
    for quilt_np, copy in kept:
        np.testing.assert_array_equal(quilt_np, copy)


@pytest.mark.cuda
def test_interpolator_pyramid_on_cuda_equals_cpu(cuda_device):
    from lfinterpolator_tpu_torch.core.config import RenderConfig
    from lfinterpolator_tpu_torch.api import Interpolator

    images, _, _ = _scene(4, 4, 40, 512, 1, 0.0)
    lf = LightField(images, 4, 4)
    cfg = RenderConfig(focus_map_views=8, focus_steps=8, focus_pyramid=True)
    before = profiling.launch_counts()
    got = Interpolator(lf, config=cfg, device=cuda_device, progress=False
                       ).interpolate("0,0,1,1", focus=0.1, focus_range=0.3,
                                     method="TEN", progress=False)
    # the coarse pass on the exact kernel, the refine on the predicated one
    launched = _launched(before)
    assert (launched["focus_estimate_exact"], launched["focus_estimate_pyramid"]) == (1, 1)
    want = Interpolator(lf, config=cfg, device="cpu", progress=False
                        ).interpolate("0,0,1,1", focus=0.1, focus_range=0.3,
                                      method="TEN", progress=False)
    np.testing.assert_array_equal(got.maps, want.maps)
    _one_lsb(got.views, want.views)


@pytest.mark.cuda
@pytest.mark.parametrize("focus_range", [0.0, 0.3], ids=["fixed", "allfocus"])
def test_stream_on_cuda_equals_plain_and_oracle(focus_range, cuda_device):
    """The CUDA stream (pinned uploads, upload/download streams) yields each
    frame within 1 LSB of the plain pipeline on the CPU (maps equal); fixed
    TEN frames equal a one-pass shift_blend byte for byte, are within 1 LSB
    of the oracle and launch shift_blend once a frame."""
    from lfinterpolator_tpu_torch.core.config import RenderConfig
    from lfinterpolator_tpu_torch.streaming import StreamingRenderer

    cfg = RenderConfig(method="TEN", focus=0.3, focus_range=focus_range, view_count=9,
                       focus_map_views=8, focus_steps=8, focus_map_refresh=2)
    frames = [_scene(4, 4, 37, 70, 1, 0.0, seed=s)[0] for s in range(5)]
    before = profiling.launch_counts()
    got = list(StreamingRenderer(4, 4, 70, 37, "0,0,1,1", config=cfg, prefetch=2,
                                 device=cuda_device).render_stream(iter(frames)))
    want = list(StreamingRenderer(4, 4, 70, 37, "0,0,1,1", config=cfg,
                                  device="cpu").render_stream(iter(frames)))
    assert len(got) == len(want) == 5
    if focus_range:
        for (gv, gm), (wv, wm_) in zip(got, want):
            np.testing.assert_array_equal(gm, wm_)
            _one_lsb(gv, wv)
        return
    assert _launched(before)["shift_blend"] == 5
    _, wm, fo = _scene(4, 4, 37, 70, 9, 0.3)
    for frame, g, w in zip(frames, got, want):
        one_pass = shift_blend.shift_blend(*to_device_state(frame, wm, fo, cuda_device))
        np.testing.assert_array_equal(g, one_pass.permute(0, 2, 3, 1).cpu().numpy())
        _one_lsb(g, w)
        _one_lsb(g, reference.blend_fixed(frame, wm, fo))


@pytest.mark.cuda
@pytest.mark.parametrize("focus_range", [0.0, 0.3], ids=["fixed", "allfocus"])
def test_interpolate_batch_on_cuda_equals_solo_and_cpu(focus_range, cuda_device):
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.core.config import RenderConfig

    images, _, _ = _scene(4, 4, 48, 64, 1, 0.0)
    lf = LightField(images, 4, 4)
    cfg = RenderConfig(method="TEN", view_count=8, focus_map_views=8, focus_steps=8)
    trajs = ["0,0,1,1", "0.2,0.2,0.8,0.8", "0,0,0.5,0.5"]
    kw = dict(focus=0.2, focus_range=focus_range, progress=False)
    gpu = Interpolator(lf, config=cfg, device=cuda_device, progress=False)
    before = profiling.launch_counts()
    got = gpu.interpolate_batch(trajs, **kw)
    # two center groups: one blend launch each, one estimate each
    launched = _launched(before)
    assert [launched[k] for k in ("shift_blend", "allfocus_blend",
                                  "focus_estimate_exact")] == (
        [0, 2, 2] if focus_range else [2, 0, 0])
    want = Interpolator(lf, config=cfg, device="cpu", progress=False
                        ).interpolate_batch(trajs, **kw)
    for t, g, w in zip(trajs, got, want):
        _one_lsb(g.views, w.views)
        np.testing.assert_array_equal(g.views, gpu.interpolate(t, **kw).views)
        if focus_range:
            np.testing.assert_array_equal(g.maps, w.maps)


@pytest.mark.cuda
@pytest.mark.parametrize("method, focus_range", [("TEN", 0.0), ("STD", 0.0), ("TEN", 0.3)],
                         ids=["fixed_ten", "fixed_std", "allfocus"])
def test_forced_view_batches_on_cuda_equal_unbatched(method, focus_range, cuda_device,
                                                     monkeypatch):
    """LFI_HBM_BYTES forces view batches (pinned downloads on a side stream
    while the next batch renders): equal to the one-pass render, and the
    fixed TEN views to the oracle."""
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.core import capacity
    from lfinterpolator_tpu_torch.core.config import RenderConfig

    images, wm, fo = _scene(4, 4, 48, 64, 64, 0.2)
    lf = LightField(images, 4, 4)
    cfg = RenderConfig(focus_map_views=8, focus_steps=8)
    interp = Interpolator(lf, config=cfg, device=cuda_device, progress=False)
    kw = dict(focus=0.2, focus_range=focus_range, method=method, progress=False)
    ref = interp.interpolate("0,0,1,1", **kw)
    k = 8 if focus_range else 0
    budget = next(b for b in range(1 << 24, 0, -1001)
                  if (capacity.plan_render(16, 3, 48, 64, 64, method=method,
                                           focus_views=k, budget=b).view_batch or 64) <= 20)
    monkeypatch.setenv("LFI_HBM_BYTES", str(budget))
    assert interp._plan(64, method, k, 0, False).view_batch <= 20
    before = profiling.launch_counts()
    out = interp.interpolate("0,0,1,1", **kw)
    launched = _launched(before)["allfocus_blend" if focus_range else "shift_blend"]
    assert launched == (0 if method == "STD" else -(-64 // interp._plan(
        64, method, k, 0, False).view_batch))
    np.testing.assert_array_equal(out.views, ref.views)
    if focus_range:
        np.testing.assert_array_equal(out.maps, ref.maps)
    elif method == "TEN":
        _one_lsb(out.views, reference.blend_fixed(images, wm, fo))


# -- row blocks: one rank's rows of a multi-GPU render -----------------------

ROW_H = 270  # two blocks of 135 rows (1080 over 8 space ranks)


def _row_blocks(h):
    """(r0, hb) for hb = 1, 7, 135 and the frame, r0 at the top, in the
    middle and at the bottom."""
    out = [(0, h)]
    for hb in (1, 7, 135):
        out += [(0, hb), ((h - hb) // 2, hb), (h - hb, hb)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("focus", [0.25, 4.0], ids=["f0.25", "f4"])
def test_shift_blend_row_blocks_equal_the_frame(focus, cuda_device):
    images, wm, fo = _scene(4, 4, ROW_H, 150, 24, focus)
    args = to_device_state(images, wm, fo, cuda_device)
    whole = shift_blend.shift_blend(*args)
    stack = blend_torch.shift_stack(args[0], args[2])
    for r0, hb in _row_blocks(ROW_H):
        before = profiling.launch_counts()
        got = shift_blend.shift_blend(*args, row_start=r0, row_count=hb)
        torch.cuda.synchronize()
        assert _launched(before) == {"shift_blend": 1}
        assert got.shape == (24, 3, hb, 150)
        assert torch.equal(got, whole[:, :, r0:r0 + hb]), (r0, hb)
        _near_tie(got, stack[:, :, r0:r0 + hb], args[1])
        _one_lsb(got, shift_blend.shift_blend_reference(*args, r0, hb))


@pytest.mark.cuda
def test_quilt_instantiation_is_unchanged_by_row_blocks(cuda_device):
    images, wm, fo = _scene(4, 4, ROW_H, 150, 64, 0.25)
    args = to_device_state(images, wm, fo, cuda_device)
    canvas = quilt.quilt_blend(*args, 5, 9)
    rows = [shift_blend.shift_blend(*args, row_start=r0, row_count=135) for r0 in (0, 135)]
    assert torch.equal(canvas, quilt_torch.montage(torch.cat(rows, dim=2), 5, 9))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "estimated"])
def test_allfocus_blend_row_blocks_equal_the_frame(kind, cuda_device):
    images, wm, fo = _scene(4, 4, ROW_H, 150, 24, 0.0)
    args = to_device_state(images, wm, fo, cuda_device)
    imgs, weights = args[0], args[1]
    se = geometry.parse_trajectory("0,0,1,1", (4, 4))
    offsets = _t(geometry.compute_offsets(4, 4, 150, ROW_H, 1.0,
                                          geometry.trajectory_center(se)), cuda_device)
    tables = _tables(-0.2, 0.9, 8, cuda_device)
    if kind == "random":
        rng = np.random.default_rng(1)
        fmap = tables.candidate_bytes[_t(rng.integers(0, 8, (ROW_H, 150)), cuda_device)]
    else:
        fmap = focus_estimate.focus_estimate(imgs[:8], offsets[:8], tables, (4, 3))
    whole = allfocus_blend.allfocus_blend(imgs, weights, offsets, fmap, tables.decode)
    selected = blend_torch.allfocus_selected(imgs, offsets, fmap, tables.decode)
    for r0, hb in _row_blocks(ROW_H):
        block = fmap[r0:r0 + hb].contiguous()
        before = profiling.launch_counts()
        got = allfocus_blend.allfocus_blend(imgs, weights, offsets, block, tables.decode,
                                            r0, hb)
        torch.cuda.synchronize()
        assert _launched(before) == {"allfocus_blend": 1}
        assert torch.equal(got, whole[:, :, r0:r0 + hb]), (r0, hb)
        _near_tie(got, selected[:, :, r0:r0 + hb], weights)
        _one_lsb(got, allfocus_blend.allfocus_blend_reference(
            imgs, weights, offsets, block, tables.decode, r0, hb))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("radius", [(4, 3), (6, 10)], ids=["r4x3", "r6x10"])
def test_estimate_row_blocks_equal_the_frame(radius, exact, cuda_device):
    images, offsets, ids = _estimate_case(4, 4, ROW_H, 150, 8, 8, 0.1, 0.4, radius)
    selected = _t(images[ids][..., :3].transpose(0, 3, 1, 2), cuda_device)
    sel_off, tables = _t(offsets[ids], cuda_device), _tables(0.1, 0.4, 8, cuda_device)
    whole = focus_estimate.focus_estimate(selected, sel_off, tables, radius, exact)
    maps = focus_estimate.cheby_maps(selected, sel_off, tables, radius)
    rule = "focus_estimate_exact" if exact else "focus_estimate_fast"
    for r0, hb in _row_blocks(ROW_H):
        before = profiling.launch_counts()
        got = focus_estimate.focus_estimate(selected, sel_off, tables, radius, exact,
                                            row_start=r0, row_count=hb)
        torch.cuda.synchronize()
        assert _launched(before) == {rule: 1}
        assert torch.equal(got, whole[r0:r0 + hb]), (r0, hb)
        assert torch.equal(got, focus_estimate.focus_estimate_reference(
            selected, sel_off, tables, radius, exact, row_start=r0, row_count=hb))
        got_maps = focus_estimate.cheby_maps(selected, sel_off, tables, radius, r0, hb)
        assert torch.equal(got_maps, maps[:, r0:r0 + hb + 2 * radius[1]]), (r0, hb)


@pytest.mark.cuda
def test_row_blocks_past_the_frame_raise(cuda_device):
    from lfinterpolator_tpu_torch.ops import _build

    images, wm, fo = _scene(2, 2, 20, 40, 4, 0.1)
    args = to_device_state(images, wm, fo, cuda_device)
    with pytest.raises(ValueError, match="row block"):
        shift_blend.shift_blend(*args, row_start=15, row_count=7)
    lib = _build.load()
    out = torch.empty((4, 3, 7, 40), dtype=torch.uint8, device=cuda_device)
    err = lib.lfi_shift_blend(args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
                              out.data_ptr(), 4, 3, 20, 40, 4, 15, 7,
                              torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue: nothing launched


@pytest.mark.cuda
def test_the_cached_budget_sees_a_tensor_that_fills_the_card(cuda_device):
    """A render that fits in one pass; a tensor that leaves less than its
    peak free makes the next plan batch views exactly as a plan against a
    fresh reading does; freed, the next plan is one pass again."""
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.core import capacity

    images, _, _ = _scene(4, 4, 1024, 1024, 64, 0.2)
    interp = Interpolator(LightField(images, 4, 4), device=cuda_device, progress=False)
    g, c, h, w = interp.images.shape

    def plan():
        return interp._plan(64, "TEN", 0, 0, False)

    first = plan()
    assert not first.batched and plan() == first
    peak = first.bytes_unbatched
    fill = torch.empty(capacity.device_hbm_bytes(cuda_device) - peak // 2,
                       dtype=torch.uint8, device=cuda_device)
    before = profiling.launch_counts()
    filled = plan()
    assert _launched(before) == {"capacity budget reads": 1}  # over half the cached budget
    fresh = capacity.device_hbm_bytes(cuda_device)
    assert filled.batched and filled == capacity.plan_render(
        g, c, h, w, 64, method="TEN", device=cuda_device, budget=fresh)
    del fill
    assert not plan().batched
    torch.cuda.empty_cache()
    assert not plan().batched


@pytest.mark.cuda
def test_spans_on_the_card_hold_the_flags_and_the_download_copy(cuda_device, tmp_path):
    """An all-in-focus call under ``profiling.trace`` on the card: the
    exact rule's clean flags open inside the estimate, and kernels (the
    [N, C, H, W] -> [N, H, W, C] copy) are launched inside the download's
    start, tied to their launches by the trace's ``correlation``."""
    import json

    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.core.config import RenderConfig
    from lfinterpolator_tpu_torch.utils import profiling

    images, _, _ = _scene(4, 4, 48, 64, 64, 0.2)
    interp = Interpolator(LightField(images, 4, 4), config=RenderConfig(focus_map_views=8),
                          device=cuda_device, progress=False)
    kw = dict(focus=0.1, focus_range=0.3, method="TEN", progress=False)
    interp.interpolate("0,0,1,1", **kw)
    with profiling.trace(str(tmp_path)):
        interp.interpolate("0.1,0.2,0.9,0.7", **kw)
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("lfi.")}
    # the plan reads free memory (lfi.plan.read) only where its cached
    # reading is over a second old: the warm call's build can make it so
    assert set(spans) - {"lfi.plan.read"} == {
        "lfi.interpolate", "lfi.params", "lfi.plan", "lfi.upload", "lfi.estimate",
        "lfi.estimate.flags", "lfi.filter", "lfi.blend", "lfi.download.start",
        "lfi.download.wait"}

    def inside(e, span):
        return span["ts"] <= e["ts"] < span["ts"] + span["dur"]

    if "lfi.plan.read" in spans:
        assert inside(spans["lfi.plan.read"], spans["lfi.plan"])

    assert inside(spans["lfi.estimate.flags"], spans["lfi.estimate"])
    for name in ("lfi.estimate.flags", "lfi.download.start"):
        ids = {e["args"]["correlation"] for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
               and inside(e, spans[name])}
        assert any(e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in ids
                   for e in events), name
