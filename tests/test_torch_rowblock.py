"""Row blocks of the port's plain renders and estimates, in one process.

Every function that takes ``row_start``/``row_count`` must equal the
whole-frame function followed by a slice, bit for bit, for every shard
position of 2, 3 and 8 space ranks, odd heights, blocks touching the top
and the bottom edge, and shifts larger than the block; the kernel wrappers
take their plain version on CPU tensors with the same blocks. The block
filter and estimate are also held equal to the JAX package's
(``focus.filter_focus_map_block``, ``focus.estimate_focus_map`` with
``row_start``/``row_count``). The last tests show why the exact rule's
clean flags are the frame's, sliced: flags computed on the block alone give
another map.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lfinterpolator_tpu.ops import focus as jax_focus
from lfinterpolator_tpu_torch.core import geometry
from lfinterpolator_tpu_torch.models import pipeline
from lfinterpolator_tpu_torch.ops import (allfocus_blend, blend_torch, focus_estimate,
                                          focus_torch, shift_blend)
from lfinterpolator_tpu_torch.parallel import mesh
from lfinterpolator_tpu_torch.state import focus_tables

torch.set_num_threads(1)


def _blocks(h):
    """Every block of 2, 3 and 8 space ranks over `h` rows (the last rank
    takes the remainder), and blocks of one row at both edges."""
    out = {(0, 1), (h - 1, 1)}
    for ns in (2, 3, 8):
        hb = h // ns
        for i in range(ns):
            out.add((i * hb, hb if i < ns - 1 else h - i * hb))
    return sorted(out)


def _scene(g, h, w, seed, amp):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, (g, 3, h, w), dtype=np.uint8))
    weights = torch.from_numpy(geometry.quantize_weights_f16(
        np.abs(rng.normal(size=(5, g))) / g).astype(np.float32))
    offsets = torch.from_numpy(rng.uniform(-amp, amp, (g, 2)).astype(np.float32))
    return images, weights, offsets


# (G, H, W, shift amplitude): odd heights; amplitude 40 shifts past an
# 8-rank block of 27 rows (3 each) and past the frame
SCENES = [(4, 27, 33, 3.0), (6, 21, 40, 40.0), (5, 16, 24, 9.0)]


@pytest.mark.parametrize("scene", SCENES, ids=lambda s: f"g{s[0]}_{s[1]}x{s[2]}_amp{s[3]:g}")
def test_fixed_render_blocks_equal_the_frame(scene):
    g, h, w, amp = scene
    images, weights, offsets = _scene(g, h, w, g + h, amp)
    shifts = torch.round(offsets * 1.5).to(torch.int32)
    whole = blend_torch.render_fixed(images, weights, shifts)
    stack = blend_torch.shift_stack(images, shifts)
    for r0, hb in _blocks(h):
        blk = blend_torch.shift_stack(images, shifts, r0, hb)
        assert torch.equal(blk, stack[:, :, r0:r0 + hb]), (r0, hb)
        want = whole[:, :, r0:r0 + hb]
        assert torch.equal(blend_torch.render_fixed(images, weights, shifts, r0, hb), want)
        assert torch.equal(shift_blend.shift_blend(images, weights, shifts, row_start=r0,
                                                   row_count=hb), want)
        for method in ("STD", "TEN"):
            got = pipeline.render_fixed_focus(images, weights, shifts, method=method,
                                              row_start=r0, row_count=hb)
            assert torch.equal(got, want), (method, r0, hb)


@pytest.mark.parametrize("scene", SCENES, ids=lambda s: f"g{s[0]}_{s[1]}x{s[2]}_amp{s[3]:g}")
def test_allfocus_blend_blocks_equal_the_frame(scene):
    g, h, w, amp = scene
    images, weights, offsets = _scene(g, h, w, 2 * g + h, amp)
    tables = focus_tables(-0.4, 1.3, 8)
    rng = np.random.default_rng(h)
    fmap = torch.from_numpy(tables.candidate_bytes[rng.integers(0, 8, (h, w))])
    decode = torch.from_numpy(tables.decode)
    whole = blend_torch.render_allfocus(images, weights, offsets, fmap, decode)
    selected = blend_torch.allfocus_selected(images, offsets, fmap, decode)
    maps = torch.stack([fmap, torch.flip(fmap, [0])])
    for r0, hb in _blocks(h):
        blk_map = fmap[r0:r0 + hb]
        got = blend_torch.allfocus_selected(images, offsets, blk_map, decode, r0, hb)
        assert torch.equal(got, selected[:, :, r0:r0 + hb]), (r0, hb)
        want = whole[:, :, r0:r0 + hb]
        assert torch.equal(allfocus_blend.allfocus_blend(
            images, weights, offsets, blk_map, decode, r0, hb), want)
        got = pipeline.blend_all_focus(images, weights, offsets, maps[:, r0:r0 + hb],
                                       decode, method="TEN", row_start=r0, row_count=hb)
        assert torch.equal(got, want), (r0, hb)


def _focus_scene(k, h, w, seed):
    """K views of one texture at per-view shifts, so the search has signal;
    offsets up to 30 px per unit focus, so taps leave the block and the
    frame, and coordinates change sign inside the frame."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (h + 24, w + 24, 3), dtype=np.uint8)
    sel = np.stack([tex[3 * (i % 3):3 * (i % 3) + h, 2 * i:2 * i + w] for i in range(k)])
    offsets = rng.uniform(-30, 30, (k, 2)).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(sel.transpose(0, 3, 1, 2))), \
        torch.from_numpy(offsets)


# (K, H, W, radius, focus, range, steps): odd heights, radii beyond a block
FOCUS_CASES = [(5, 27, 40, (3, 2), -0.3, 0.6, 8), (4, 25, 32, (2, 5), 0.1, 0.3, 6)]


def _tables(focus, frange, steps):
    return type(focus_tables(0.0, 1.0, 2))(
        *(torch.from_numpy(t) for t in focus_tables(focus, frange, steps)))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("case", FOCUS_CASES, ids=["k5_27x40", "k4_25x32"])
def test_estimate_blocks_equal_the_frame(case, exact):
    k, h, w, radius, focus, frange, steps = case
    sel, offsets = _focus_scene(k, h, w, k + h)
    tables = _tables(focus, frange, steps)
    whole = focus_torch.estimate_focus_map(sel, offsets, tables, radius, exact)
    assert len(torch.unique(whole)) > 1
    assert torch.equal(focus_torch.estimate_hoisted(sel, offsets, tables, radius, exact),
                       whole)
    for r0, hb in _blocks(h):
        want = whole[r0:r0 + hb]
        for got in (
            focus_torch.estimate_focus_map(sel, offsets, tables, radius, exact,
                                           row_start=r0, row_count=hb),
            focus_torch.estimate_hoisted(sel, offsets, tables, radius, exact, r0, hb),
            focus_estimate.focus_estimate(sel, offsets, tables, radius, exact,
                                          row_start=r0, row_count=hb),
        ):
            assert torch.equal(got, want), (r0, hb)


@pytest.mark.parametrize("case", FOCUS_CASES, ids=["k5_27x40", "k4_25x32"])
def test_cheby_map_blocks_are_rows_of_the_extended_frame(case):
    k, h, w, radius, focus, frange, steps = case
    sel, offsets = _focus_scene(k, h, w, 2 * k + h)
    f = torch.tensor(focus + frange / 2, dtype=torch.float32)
    whole = focus_torch.cheby_map(sel, offsets, f, radius)
    ry = radius[1]
    for r0, hb in _blocks(h):
        got = focus_torch.cheby_map(sel, offsets, f, radius, r0, hb)
        assert torch.equal(got, whole[r0:r0 + hb + 2 * ry]), (r0, hb)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_estimate_blocks_equal_the_jax_block_estimate(exact):
    k, h, w, radius, focus, frange, steps = FOCUS_CASES[0]
    sel, offsets = _focus_scene(k, h, w, 7)
    tables = _tables(focus, frange, steps)
    pad = jax_focus.shift_pad_bound(offsets.numpy(), focus, frange, radius, h, w)
    for r0, hb in [(0, 9), (9, 9), (18, 9), (13, 1)]:
        want = np.asarray(jax_focus.estimate_focus_map(
            jnp.asarray(sel.numpy()), jnp.asarray(offsets.numpy()), jnp.float32(focus),
            jnp.float32(frange), radius, steps=steps, pad=pad, row_start=r0,
            row_count=hb, exact_taps=exact))
        got = focus_torch.estimate_focus_map(sel, offsets, tables, radius, exact,
                                             row_start=r0, row_count=hb)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{r0}, {hb}")


@pytest.mark.parametrize("radius", [(0, 0), (1, 1), (3, 2), (2, 7)])
@pytest.mark.parametrize("h", [21, 16])
def test_filter_block_equals_the_frame_and_jax(radius, h):
    rng = np.random.default_rng(h + radius[1])
    fmap = rng.integers(0, 256, (h, 30), dtype=np.uint8)
    whole = focus_torch.filter_focus_map(torch.from_numpy(fmap), radius)
    for r0, hb in _blocks(h):
        got = focus_torch.filter_focus_map_block(torch.from_numpy(fmap), radius, r0, hb)
        assert torch.equal(got, whole[r0:r0 + hb]), (r0, hb)
        want = np.asarray(jax_focus.filter_focus_map_block(jnp.asarray(fmap), radius, r0, hb))
        np.testing.assert_array_equal(got.numpy(), want)


def _dirty_band_scene():
    """A scene whose dirty rows (where the exact rule's tap leaves the
    hoisted rule's, around each view's coordinate sign change) lie in the
    middle of the frame: oy = -90, candidates near 0.2, so y + f*oy
    changes sign near row 18 of 36, inside the second block of two."""
    k, h, w = 4, 36, 24
    rng = np.random.default_rng(3)
    sel = torch.from_numpy(rng.integers(0, 256, (k, 3, h, w), dtype=np.uint8))
    offsets = torch.tensor([[1.0, -90.0], [-2.0, -88.5], [0.5, -91.0], [1.5, -89.25]])
    return sel, offsets, _tables(0.15, 0.1, 6), (2, 4)


def test_block_flags_are_the_frames_rows():
    sel, offsets, tables, radius = _dirty_band_scene()
    h, w = sel.shape[2:]
    rows, cols = focus_torch.clean_flags(offsets, tables, radius, h, w)
    r0, hb = 18, 18
    local, _ = focus_torch.clean_flags(offsets, tables, radius, hb, w)
    assert not torch.equal(local, rows[:, r0:r0 + hb])  # block rows != rows 0..hb
    got = focus_torch.estimate_hoisted(sel, offsets, tables, radius, True, r0, hb,
                                       flags=(rows[:, r0:r0 + hb], cols))
    whole = focus_torch.estimate_focus_map(sel, offsets, tables, radius, True)
    assert torch.equal(got, whole[r0:r0 + hb])


def test_flags_of_the_block_alone_give_another_map():
    """Planted: the block's own flags call clean the block's dirty rows
    (they describe rows 0..hb of the frame), and the map changes there."""
    sel, offsets, tables, radius = _dirty_band_scene()
    h, w = sel.shape[2:]
    r0, hb = 18, 18
    whole = focus_torch.estimate_focus_map(sel, offsets, tables, radius, True)
    wrong = focus_torch.clean_flags(offsets, tables, radius, hb, w)
    got = focus_torch.estimate_hoisted(sel, offsets, tables, radius, True, r0, hb,
                                       flags=wrong)
    assert not torch.equal(got, whole[r0:r0 + hb])


@pytest.mark.parametrize("bad", [(-1, 4), (0, 0), (10, 7), (16, None)])
def test_a_block_outside_the_frame_raises(bad):
    images, weights, offsets = _scene(4, 16, 20, 1, 3.0)
    shifts = offsets.to(torch.int32)
    r0, hb = bad
    with pytest.raises(ValueError, match="row block"):
        shift_blend.shift_blend(images, weights, shifts, row_start=r0, row_count=hb)
    with pytest.raises(ValueError, match="row block"):
        focus_torch.filter_focus_map_block(torch.zeros((16, 20), dtype=torch.uint8),
                                           (1, 1), r0, 4 if hb is None else hb)


def test_the_refine_pass_takes_the_whole_frame_only():
    from lfinterpolator_tpu_torch.ops.estimate_geometry import Pyramid

    sel, offsets = _focus_scene(2, 16, 64, 2)
    plan = Pyramid(2, 1, (1, 1), tb=8, wco=32, sc=4, nb=2, n_wc=2)
    pres = torch.ones((2, 2, 1), dtype=torch.int32)
    args = (sel, offsets, _tables(0.1, 0.3, 4), (2, 2), True, pres, plan)
    whole = focus_estimate.focus_estimate(*args)
    assert whole.shape == (16, 64)
    with pytest.raises(ValueError, match="whole frame"):
        focus_estimate.focus_estimate(*args, row_start=8, row_count=8)


def test_the_pyramid_estimates_the_whole_frame_only():
    sel, offsets = _focus_scene(4, 16, 24, 1)
    with pytest.raises(ValueError, match="whole frame"):
        pipeline.estimate_focus(sel, offsets, torch.arange(4), _tables(0.0, 0.2, 4),
                                radius=(2, 2), pyramid=object(), row_start=8,
                                row_count=8)


@pytest.mark.parametrize("method", ["STD", "TEN"])
def test_shard_bytes(method):
    """The per-rank arithmetic: the phases add what they say, the peak is
    their max, and more space ranks shrink every per-rank term but the
    replicated stack and the gathered views."""
    g, c, h, w, v = 64, 3, 1080, 1920, 64
    one = mesh.fixed_shard_bytes(1, 1, g, c, h, w, v, method=method)
    four = mesh.fixed_shard_bytes(2, 2, g, c, h, w, v, method=method)
    assert one["stack"] == four["stack"] == g * c * h * w
    assert four["gather"] == g * c * h * w + 32 * c * 540 * w + 2 * v * c * h * w
    assert four["peak"] == max(four["render"], four["gather"]) <= one["peak"]
    af = mesh.allfocus_shard_bytes(2, 2, g, 32, c, h, w, v, radius=(20, 10),
                                   filter_radius=(10, 5), steps=32)
    assert af["peak"] == max(af[k] for k in ("estimate", "filter", "blend", "gather"))
    assert af["estimate"] > af["stack"] + 32 * (c + 4) * h * w
    with pytest.raises(ValueError, match="must divide by the mesh axes"):
        mesh.fixed_shard_bytes(2, 7, g, c, h, w, v, method=method)
