"""Grids of more than 256 images: the Stanford Light Field Archive's 17x17
gantry grid (289 views) on the port's normal path, and the blend kernels
that stage such grids in passes.

On the CPU, ``Interpolator.interpolate`` (fixed focus with TEN and STD, all
in focus with the exact estimate) renders a seeded 17x17 grid at 24x40,
held to the benchmark's plain reference (``lfibench/reference/render.py``)
and to the port's NumPy oracle (``ops/reference.py``): views under the
near-tie rule (``blend_torch.check_bytes``), maps byte-equal. A planted
byte and a dropped image fail. The plain float32 sum's error bound
(``blend_torch.f32_sum_error_bound``) stays under the rule's band up to the
kernels' limit, ``blend_torch.MAX_GRID``.

On the card (``cuda`` marker; each test skips without one), both blend
kernels at G from 1 to the limit against their plain versions under the
near-tie rule, their row blocks and the quilt instantiation past 256
images, the occupancy the passes hold, a planted worst case for the
tensor cores' truncation, and the limit itself. This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_wide_grid.py
"""

import numpy as np
import pytest
import torch

from lfibench.reference import render as bench_reference
from lfibench.scene import OcclusionScene, plane_foci
from lfinterpolator_tpu_torch.api import Interpolator
from lfinterpolator_tpu_torch.core import geometry
from lfinterpolator_tpu_torch.core.config import RenderConfig
from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.ops import (
    allfocus_blend, blend_torch, quilt, reference, shift_blend)
from lfinterpolator_tpu_torch.state import allfocus_params, render_params
from lfinterpolator_tpu_torch.utils import profiling

torch.set_num_threads(1)

COLS = ROWS = 17
H, W = 24, 40
TRAJECTORY = "0.1,0.2,0.9,0.7"
#: (method, focus, focus_range): fixed focus with both methods, all in focus
RENDERS = [("TEN", 0.2, 0.0), ("STD", 0.2, 0.0), ("TEN", 0.0, 0.07)]
#: The configuration of the benchmark's 17x17 cells, at the tests' size.
CONFIG = {"cols": COLS, "rows": ROWS, "height": H, "width": W, "views": 64,
          "method": "TEN", "effect": 3.0, "aspect": 1.0, "focus_steps": 32,
          "focus_map_views": 32, "pixel_size_factor": 100, "filter_radius_divisor": 10,
          "exact_focus_taps": True, "rehearsal": True}


@pytest.fixture(scope="module")
def grid17():
    """A seeded 17x17 parallax-occlusion grid [289, H, W, 3] uint8."""
    scene = OcclusionScene(COLS, ROWS, H, W, plane_foci(0.0, 0.07, 32), [4, 3], 5, "cpu")
    return scene.frame().numpy()


@pytest.fixture(scope="module")
def renders(grid17):
    """Each of RENDERS through the port's normal path on the CPU."""
    interp = Interpolator(LightField(images=grid17, cols=COLS, rows=ROWS), device="cpu",
                          progress=False)
    return {r: interp.interpolate(TRAJECTORY, focus=r[1], focus_range=r[2], method=r[0],
                                  progress=False) for r in RENDERS}


def _planar(images) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images[..., :3].transpose(0, 3, 1, 2)))


def _rule(views_hwc: np.ndarray, stack: torch.Tensor, weights) -> dict:
    """check_bytes on views [V, H, W, C] against the exact sums of `stack`
    [G, C, H, W] under `weights` [V, G]."""
    got = torch.from_numpy(np.ascontiguousarray(views_hwc)).permute(0, 3, 1, 2)
    sums = blend_torch.exact_sums(stack, torch.as_tensor(np.asarray(weights, np.float32)))
    return blend_torch.check_bytes(got.contiguous(), sums)


@pytest.mark.parametrize("case", RENDERS, ids=["fixed_ten", "fixed_std", "allfocus_ten"])
def test_a_17x17_grid_follows_the_benchmark_reference(grid17, renders, case):
    method, focus, focus_range = case
    res = renders[case]
    ref = bench_reference.render(dict(CONFIG, method=method), _planar(grid17).contiguous(),
                                 TRAJECTORY, focus, focus_range)
    got = bench_reference.compare(ref, torch.from_numpy(res.views),
                                  None if res.maps is None else torch.from_numpy(res.maps))
    assert set(got.values()) == {0}, got
    assert res.views.shape == (64, H, W, 3)


@pytest.mark.parametrize("case", RENDERS, ids=["fixed_ten", "fixed_std", "allfocus_ten"])
def test_a_17x17_grid_follows_the_numpy_oracle(grid17, renders, case):
    method, focus, focus_range = case
    res = renders[case]
    if focus_range == 0:
        wm, shifts = render_params(TRAJECTORY, cols=COLS, rows=ROWS, height=H, width=W,
                                   focus=focus)
        oracle = reference.blend_fixed(grid17, wm.astype(np.float16), shifts)
        stack = blend_torch.shift_stack(_planar(grid17), torch.from_numpy(shifts))
    else:
        cfg = RenderConfig(method=method, focus=focus, focus_range=focus_range)
        p = allfocus_params(TRAJECTORY, cols=COLS, rows=ROWS, height=H, width=W, config=cfg)
        wm = p.weights
        raw = reference.focus_map_estimate(grid17, p.offsets, p.focus_ids, focus,
                                           focus_range, p.radius, cfg.focus_steps)
        filtered = reference.focus_map_filter(raw, p.filter_radius)
        assert np.array_equal(res.maps, np.stack([raw, filtered]))
        oracle = reference.blend_allfocus(grid17, wm.astype(np.float16), p.offsets, raw,
                                          focus, focus_range)
        stack = blend_torch.allfocus_selected(
            _planar(grid17), torch.from_numpy(p.offsets), torch.from_numpy(raw),
            torch.from_numpy(np.asarray(p.tables.decode)))
    assert wm.shape == (64, COLS * ROWS)
    _rule(res.views, stack, wm)
    _rule(oracle, stack, wm)  # the oracle's sequential sum of 289 terms too
    assert np.abs(res.views.astype(int) - oracle.astype(int)).max() <= 1


def test_a_byte_planted_in_a_17x17_render_fails(grid17, renders):
    case = RENDERS[0]
    res = renders[case]
    ref = bench_reference.render(CONFIG, _planar(grid17).contiguous(), TRAJECTORY, 0.2, 0.0)
    bad = torch.from_numpy(res.views.copy())
    bad.view(-1)[bad.numel() // 2] ^= 4
    assert bench_reference.compare(ref, bad, None)["view_bytes_off_rule"] == 1
    wm, shifts = render_params(TRAJECTORY, cols=COLS, rows=ROWS, height=H, width=W, focus=0.2)
    with pytest.raises(AssertionError, match="break the near-tie rule"):
        _rule(bad.numpy(), blend_torch.shift_stack(_planar(grid17), torch.from_numpy(shifts)),
              wm)


@pytest.mark.parametrize("dropped", [0, 256, 288], ids=["first", "257th", "last"])
def test_an_image_left_out_of_a_17x17_blend_fails(grid17, dropped):
    """The blend over 288 of the 289 images, the weights renormalised over
    those: the views break the rule against the 289-term sums, whichever
    image is left out (the 257th and later ones too)."""
    wm, shifts = render_params(TRAJECTORY, cols=COLS, rows=ROWS, height=H, width=W, focus=0.2)
    stack = blend_torch.shift_stack(_planar(grid17), torch.from_numpy(shifts))
    keep = [g for g in range(COLS * ROWS) if g != dropped]
    w = wm[:, keep] / wm[:, keep].sum(axis=1, keepdims=True)
    short = blend_torch.blend(stack[keep].contiguous(),
                              torch.from_numpy(w.astype(np.float16).astype(np.float32)))
    ref = bench_reference.render(CONFIG, _planar(grid17).contiguous(), TRAJECTORY, 0.2, 0.0)
    assert bench_reference.compare(ref, short.permute(0, 2, 3, 1), None)[
        "view_bytes_off_rule"] > 0
    with pytest.raises(AssertionError, match="break the near-tie rule"):
        blend_torch.check_bytes(short, blend_torch.exact_sums(stack, torch.from_numpy(wm)))


def _grid_of(g: int) -> tuple[int, int]:
    """A grid of `g` images: square where g is, else one row."""
    side = int(round(g ** 0.5))
    return (side, side) if side * side == g else {512: (32, 16)}.get(g, (g, 1))


@pytest.mark.parametrize("g", [256, 257, 289, blend_torch.MAX_GRID])
def test_the_plain_sum_stays_inside_the_band(g):
    """The bound: (G - 1) 2^-17 < 2^-8 up to the limit, and the plain
    version's float32 sums of a render's weights keep to it."""
    assert blend_torch.f32_sum_error_bound(g) < blend_torch.BAND
    cols, rows = _grid_of(g)
    se = geometry.parse_trajectory("0,0,1,1", (cols, rows))
    wm = geometry.quantize_weights_f16(geometry.weight_matrix(se, cols, rows, 3.0, 16))
    weights = torch.from_numpy(wm.astype(np.float32))
    rng = np.random.default_rng(g)
    pixels = np.full((g, 1, 16, 64), 255, np.uint8)  # partial sums near the top binade
    pixels[:, :, 8:] = rng.integers(0, 256, (g, 1, 8, 64), dtype=np.uint8)
    stack = torch.from_numpy(pixels)
    exact = blend_torch.exact_sums(stack, weights)
    f32 = blend_torch.matmul_f32(weights, stack.reshape(g, -1).float()).reshape(exact.shape)
    assert float((f32.double() - exact).abs().max()) <= blend_torch.f32_sum_error_bound(g)
    assert float(exact.max()) < 256
    blend_torch.check_bytes(blend_torch.blend(stack, weights), exact)


def test_the_limit_is_where_the_plain_argument_ends():
    assert blend_torch.f32_sum_error_bound(blend_torch.MAX_GRID + 1) >= blend_torch.BAND


# ---------------------------------------------------------------- on the card

#: G: one image, the headline grid, one past a pass of 64, the old limit,
#: one past it, the 17x17 grid and the limit.
GRIDS = [1, 64, 65, 256, 257, 289, blend_torch.MAX_GRID]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _operands(g, v, c, h, w, reach, device, seed=0):
    """Random images, fp16-valued weights that sum to about 1 a row, shifts
    and offsets up to `reach` past the image, and a noise map."""
    rng = np.random.default_rng(seed + g)
    images = _t(rng.integers(0, 256, (g, c, h, w), dtype=np.uint8), device)
    raw = rng.random((v, g)) + 0.05
    weights = _t((raw / raw.sum(axis=1, keepdims=True)).astype(np.float16).astype(np.float32),
                 device)
    shifts = _t(rng.integers(-reach, reach + 1, (g, 2)).astype(np.int32), device)
    offsets = _t((rng.random((g, 2)) * 2 * reach - reach).astype(np.float32), device)
    fmap = _t(rng.integers(0, 256, (h, w), dtype=np.uint8), device)
    decode = _t(np.linspace(-1.0, 1.0, 256).astype(np.float32), device)
    return images, weights, shifts, offsets, fmap, decode


def _one_lsb(got, want):
    assert got.shape == want.shape
    assert int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("g", GRIDS)
def test_blend_kernels_obey_the_near_tie_rule_at_any_grid(g, cuda_device):
    """Both kernels against their plain versions, with 70 views (two view
    chunks) on a ragged row; rows of the weight matrix alone are bit-equal
    to the same rows of the whole launch; each kernel launches once a call,
    and a launch runs the passes that the library reports."""
    from lfinterpolator_tpu_torch.ops import _build

    images, weights, shifts, offsets, fmap, decode = _operands(g, 70, 3, 5, 150, 60,
                                                               cuda_device)
    passes = _build.load().lfi_blend_grid_passes(g)
    assert passes == (1 if g <= 96 else -(-((g + 15) // 16 * 16) // 64))
    before = profiling.launch_counts()
    got = shift_blend.shift_blend(images, weights, shifts)
    af = allfocus_blend.allfocus_blend(images, weights, offsets, fmap, decode)
    assert profiling.launch_counts() - before == {"shift_blend": 1, "allfocus_blend": 1}
    stack = blend_torch.shift_stack(images, shifts)
    blend_torch.check_bytes(got, blend_torch.exact_sums(stack, weights))
    _one_lsb(got, shift_blend.shift_blend_reference(images, weights, shifts))
    selected = blend_torch.allfocus_selected(images, offsets, fmap, decode)
    blend_torch.check_bytes(af, blend_torch.exact_sums(selected, weights))
    _one_lsb(af, allfocus_blend.allfocus_blend_reference(images, weights, offsets, fmap,
                                                         decode))
    for lo, hi in ((0, 1), (3, 67), (69, 70)):
        rows = weights[lo:hi].contiguous()
        assert torch.equal(shift_blend.shift_blend(images, rows, shifts), got[lo:hi])
        assert torch.equal(allfocus_blend.allfocus_blend(images, rows, offsets, fmap, decode),
                           af[lo:hi])


@pytest.mark.cuda
@pytest.mark.parametrize("g", [289, blend_torch.MAX_GRID])
def test_row_blocks_past_256_images_equal_the_whole_frame(g, cuda_device):
    h = 13
    images, weights, shifts, offsets, fmap, decode = _operands(g, 64, 3, h, 70, 9,
                                                               cuda_device, seed=1)
    whole = shift_blend.shift_blend(images, weights, shifts)
    af = allfocus_blend.allfocus_blend(images, weights, offsets, fmap, decode)
    for r0, hb in ((0, 4), (4, 5), (9, 4)):
        assert torch.equal(shift_blend.shift_blend(images, weights, shifts, row_start=r0,
                                                   row_count=hb), whole[:, :, r0:r0 + hb])
        block = fmap[r0:r0 + hb].contiguous()
        assert torch.equal(allfocus_blend.allfocus_blend(images, weights, offsets, block,
                                                         decode, row_start=r0, row_count=hb),
                           af[:, :, r0:r0 + hb])


@pytest.mark.cuda
def test_quilt_blend_of_289_images(cuda_device):
    """The quilt instantiation at 289 images: each tile bit-equal to the
    same view of shift_blend, the canvas under the rule against the plain
    quilt."""
    cols, rows, h, w = 5, 9, 12, 70
    images, weights, shifts, _, _, _ = _operands(289, 45, 3, h, w, 20, cuda_device, seed=2)
    from lfinterpolator_tpu_torch.ops import _build

    before = profiling.launch_counts()
    canvas = quilt.quilt_blend(images, weights, shifts, cols, rows)
    assert profiling.launch_counts() - before == {"quilt_blend": 1}
    assert _build.load().lfi_blend_grid_passes(289) == 5
    views = shift_blend.shift_blend(images, weights, shifts)
    tiles = canvas.reshape(3, rows, h, cols, w).permute(1, 3, 0, 2, 4).reshape(45, 3, h, w)
    assert torch.equal(tiles, views)
    _one_lsb(canvas, quilt.quilt_blend_reference(images, weights, shifts, cols, rows))


@pytest.mark.cuda
def test_one_image_past_the_limit_raises(cuda_device):
    g = blend_torch.MAX_GRID + 1
    images, weights, shifts, offsets, _, decode = _operands(g, 2, 3, 4, 4, 1, cuda_device)
    fmap = torch.zeros((4, 4), dtype=torch.uint8, device=cuda_device)
    match = f"at most {blend_torch.MAX_GRID} grid images, got {g}"
    with pytest.raises(ValueError, match=match):
        shift_blend.shift_blend(images, weights, shifts)
    with pytest.raises(ValueError, match=match):
        allfocus_blend.allfocus_blend(images, weights, offsets, fmap, decode)
    with pytest.raises(ValueError, match=match):
        quilt.quilt_blend(images, weights, shifts, 1, 2)


@pytest.mark.cuda
def test_the_kernels_report_the_limit(cuda_device):
    from lfinterpolator_tpu_torch.ops import _build

    lib = _build.load()
    assert lib.lfi_shift_blend_max_grid() == lib.lfi_allfocus_blend_max_grid() \
        == blend_torch.MAX_GRID


@pytest.mark.cuda
@pytest.mark.parametrize("g", [64, 81, 256, 289, blend_torch.MAX_GRID])
def test_two_blocks_stay_resident_on_an_sm(g, cuda_device):
    """What the passes hold: at least two blocks of each blend kernel on an
    SM, in no more shared memory a block than G = 256 took in one pass
    (110 KB); a grid of one pass keeps the old layout's size."""
    from lfinterpolator_tpu_torch.ops import _build

    lib = _build.load()
    gp = (g + 15) // 16 * 16
    one_pass = 64 * (gp + 8) * 2 + 64 * 144 + gp * 136 * 2  # weights, bytes, operand
    for kernel in ("shift_blend", "allfocus_blend"):
        smem = getattr(lib, f"lfi_{kernel}_smem_bytes")(g)
        blocks = getattr(lib, f"lfi_{kernel}_blocks_per_sm")(g)
        assert blocks >= 2 and smem <= 110 * 1024, (kernel, g, smem, blocks)
        if g <= 96:
            assert smem == one_pass + 2 * gp * 4, (kernel, g, smem)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [289, blend_torch.MAX_GRID])
def test_the_tensor_core_sum_keeps_the_rule_where_truncation_bites(g, cuda_device):
    """A planted worst case for the tensor cores' adder: two large terms
    (weights near 1/2 and 1/4, random pixels) put the running sum near the
    top binade, and every other image adds 255 times 2^-14 + 2^-24, whose
    lowest bits an adder that aligns to the sum's exponent drops: 255/256
    of an ulp each without bits below the f32 significand, 63/64 of a
    quarter ulp with two. With two the error stays under the band (the
    argument in csrc/lfi_common.cuh); without them it would pass it and
    break the rule on some of the 65536 pixels."""
    rng = np.random.default_rng(g)
    h, w, v = 64, 1024, 16
    images = np.full((g, 1, h, w), 255, np.uint8)
    images[:2] = rng.integers(0, 256, (2, 1, h, w), dtype=np.uint8)
    wm = np.full((v, g), 2.0 ** -14 + 2.0 ** -24, np.float32)
    wm[:, 0] = 0.5 + np.arange(v) * 2.0 ** -11
    wm[:, 1] = 0.25 + (2 * np.arange(v) + 1) * 2.0 ** -12
    assert np.array_equal(wm.astype(np.float16).astype(np.float32), wm)
    assert float(wm.sum(axis=1).max()) <= 1.0
    images, weights = _t(images, cuda_device), _t(wm, cuda_device)
    sums = blend_torch.exact_sums(images, weights)
    counts = blend_torch.check_bytes(
        shift_blend.shift_blend(images, weights,
                                torch.zeros((g, 2), dtype=torch.int32, device=cuda_device)),
        sums)
    assert counts["bytes"] == v * h * w
    blend_torch.check_bytes(allfocus_blend.allfocus_blend(
        images, weights, torch.zeros((g, 2), device=cuda_device),
        torch.zeros((h, w), dtype=torch.uint8, device=cuda_device),
        torch.zeros(256, device=cuda_device)), sums)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RENDERS, ids=["fixed_ten", "fixed_std", "allfocus_ten"])
def test_interpolator_renders_a_17x17_grid_on_cuda(case, cuda_device):
    """The normal path on the card at 48x80: maps equal to the CPU's, views
    within the near-tie rule of the CPU's exact sums and 1 LSB of its
    views; a TEN render launches its blend once, five passes a launch."""
    method, focus, focus_range = case
    images = OcclusionScene(COLS, ROWS, 48, 80, plane_foci(0.0, 0.07, 32), [4, 3], 9,
                            "cpu").frame().numpy()
    lf = LightField(images=images, cols=COLS, rows=ROWS)
    before = profiling.launch_counts()
    got = Interpolator(lf, device=cuda_device, progress=False).interpolate(
        TRAJECTORY, focus=focus, focus_range=focus_range, method=method, progress=False)
    want = Interpolator(lf, device="cpu", progress=False).interpolate(
        TRAJECTORY, focus=focus, focus_range=focus_range, method=method, progress=False)
    if method == "TEN":
        from lfinterpolator_tpu_torch.ops import _build

        launched = profiling.launch_counts() - before
        passes = tuple(launched[k] * _build.load().lfi_blend_grid_passes(COLS * ROWS)
                       for k in ("shift_blend", "allfocus_blend"))
        assert passes == ((5, 0) if focus_range == 0 else (0, 5))
    assert np.abs(got.views.astype(int) - want.views.astype(int)).max() <= 1
    if focus_range:
        assert np.array_equal(got.maps, want.maps)
    ref = bench_reference.render(dict(CONFIG, height=48, width=80, method=method),
                                 _planar(images).contiguous(), TRAJECTORY, focus, focus_range)
    assert set(bench_reference.compare(
        ref, torch.from_numpy(got.views),
        None if got.maps is None else torch.from_numpy(got.maps)).values()) == {0}
