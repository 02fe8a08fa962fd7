"""The near-tie rule of the blend kernels (blend_torch.exact_sums and
check_bytes) and the fp16 precondition on their weights.

The Hopper blend kernels sum on the tensor cores, so their bytes are not
bit-equal to a sequential f32 sum. The contract that replaces bit-equality:
where the exact sum lies further than 2^-8 from a half-integer the byte is
clip(rint(sum)) exactly, elsewhere it is one of the two neighbouring bytes.
Here, on the CPU, the rule is held against everything the kernels are
compared with -- the port's plain versions, the NumPy oracle
(reference.blend_fixed / blend_allfocus) and the JAX package's Pallas
kernels in interpret mode (blend_pallas.blend_tiled, the fused all-focus
route) -- on seeded numpy inputs at G = 4, 16, 64 and 256, so that a failure
of the rule on the card points at the kernel. Tolerance: the rule itself,
band 2^-8; the checker is shown to reject an off-by-one outside the band
and a 2-LSB error inside it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfinterpolator_tpu.models import pipeline as jax_pipeline
from lfinterpolator_tpu.ops import allfocus_pallas, blend_pallas, reference
from lfinterpolator_tpu.ops import focus as focus_ops
from lfinterpolator_tpu_torch import state
from lfinterpolator_tpu_torch.api import Interpolator
from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.models import pipeline
from lfinterpolator_tpu_torch.ops import allfocus_blend, blend_torch, quilt, shift_blend

torch.set_num_threads(1)

GRIDS = [4, 16, 64, 256]
BAND = 2.0 ** -8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fp16(a):
    return a.astype(np.float16).astype(np.float32)


def _fixed_scene(g, v=12, c=3, h=10, w=37, reach=45, seed=0):
    """Seeded operands of a fixed-focus blend: shifts reach past the image."""
    rng = np.random.default_rng(seed + g)
    images = rng.integers(0, 256, (g, c, h, w), dtype=np.uint8)
    weights = _fp16(rng.random((v, g)) * 4 / g)
    shifts = rng.integers(-reach, reach + 1, (g, 2)).astype(np.int32)
    return images, weights, shifts


def _allfocus_scene(g, v=12, c=3, h=10, w=37, seed=0):
    rng = np.random.default_rng(seed + 7 * g)
    images = rng.integers(0, 256, (g, c, h, w), dtype=np.uint8)
    weights = _fp16(rng.random((v, g)) * 4 / g)
    offsets = rng.uniform(-30, 30, (g, 2)).astype(np.float32)
    tables = state.focus_tables(0.1, 0.6, 8)
    fmap = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return images, weights, offsets, fmap, tables


@pytest.mark.parametrize("g", GRIDS)
def test_exact_sums_are_the_float64_sums(g):
    images, weights, shifts = _fixed_scene(g)
    shifted = blend_torch.shift_stack(_t(images), _t(shifts))
    sums = blend_torch.exact_sums(shifted, _t(weights))
    assert sums.dtype == torch.float64 and sums.shape == (12, 3, 10, 37)
    want = np.einsum("vg,gchw->vchw", weights.astype(np.float64),
                     shifted.numpy().astype(np.float64))
    # both exact: products of u8 and fp16 values, summed within 53 bits
    np.testing.assert_array_equal(sums.numpy(), want)
    # one channel or a block of rows at a time gives the same sums
    assert torch.equal(blend_torch.exact_sums(shifted[:, 1, 2:5], _t(weights)),
                       sums[:, 1, 2:5])


@pytest.mark.parametrize("g", GRIDS)
def test_fixed_plain_version_and_oracle_obey_the_rule(g):
    images, weights, shifts = _fixed_scene(g)
    args = (_t(images), _t(weights), _t(shifts))
    sums = blend_torch.exact_sums(blend_torch.shift_stack(args[0], args[2]), args[1])
    plain = shift_blend.shift_blend(*args)  # CPU tensors: the plain version
    counts = blend_torch.check_bytes(plain, sums, BAND)
    assert counts["bytes"] == plain.numel() and 0 <= counts["ties_off"] <= counts["lax"]
    oracle = reference.blend_fixed(images.transpose(0, 2, 3, 1), weights, shifts)
    blend_torch.check_bytes(_t(oracle.transpose(0, 3, 1, 2)), sums, BAND)


@pytest.mark.parametrize("g", GRIDS)
def test_allfocus_plain_version_and_oracle_obey_the_rule(g):
    images, weights, offsets, fmap, tables = _allfocus_scene(g)
    args = (_t(images), _t(weights), _t(offsets), _t(fmap), _t(tables.decode))
    selected = blend_torch.allfocus_selected(args[0], *args[2:])
    sums = blend_torch.exact_sums(selected, args[1])
    plain = allfocus_blend.allfocus_blend(*args)
    assert blend_torch.check_bytes(plain, sums, BAND)["bytes"] == plain.numel()
    oracle = reference.blend_allfocus(images.transpose(0, 2, 3, 1), weights, offsets,
                                      fmap, 0.1, 0.6)
    blend_torch.check_bytes(_t(oracle.transpose(0, 3, 1, 2)), sums, BAND)


@pytest.mark.parametrize("g", GRIDS)
def test_jax_blend_tiled_obeys_the_rule(g, monkeypatch):
    """blend_pallas.blend_tiled (_blend_tiled_kernel, interpret mode): the
    matrix-unit contraction the tensor-core kernels replace."""
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(g)
    x4 = rng.integers(0, 256, (g, 2, 8, 128), dtype=np.uint8)
    weights = _fp16(rng.random((8, g)) * 4 / g)
    got = np.array(blend_pallas.blend_tiled(jnp.asarray(x4), jnp.asarray(weights)))
    counts = blend_torch.check_bytes(
        _t(got), blend_torch.exact_sums(_t(x4), _t(weights)), BAND)
    assert counts["bytes"] == 8 * 2 * 8 * 128


@pytest.mark.parametrize("method", ["TEN", "STD"])
@pytest.mark.parametrize("g", GRIDS)
def test_jax_allfocus_route_obeys_the_rule(g, method, monkeypatch):
    """The JAX package's fused all-focus blend (_af_kernel feeding
    _blend_tiled_kernel, interpret mode) against the exact sums of the
    port's bit-exact select."""
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")
    h, w, focus, frange = 32, 128, 0.1, 0.3
    rng = np.random.default_rng(3 * g)
    images = rng.integers(0, 256, (g, 3, h, w), dtype=np.uint8)
    weights = _fp16(rng.random((4, g)) * 4 / g)
    offsets = rng.uniform(-15, 15, (g, 2)).astype(np.float32)
    tables = state.focus_tables(focus, frange, 8)
    maps = np.stack([tables.candidate_bytes[rng.integers(0, 8, (h, w))],
                     rng.integers(0, 256, (h, w), dtype=np.uint8)])
    spread = allfocus_pallas.spread_bound(offsets, focus, frange, bucket=8)
    assert jax_pipeline.allfocus_uses_fused_blend(method, h, w, spread)
    got = np.array(jax_pipeline.blend_all_focus(
        jnp.asarray(images), jnp.asarray(weights), jnp.asarray(offsets),
        jnp.asarray(maps), jnp.float32(focus), jnp.float32(frange),
        method=method, steps=8,
        pad=focus_ops.shift_pad_bound(offsets, focus, frange, (2, 2), h, w),
        spread=spread,
    ))
    fmap = maps[1] if method == "STD" else maps[0]
    selected = blend_torch.allfocus_selected(_t(images), _t(offsets), _t(fmap),
                                             _t(tables.decode))
    blend_torch.check_bytes(_t(got), blend_torch.exact_sums(selected, _t(weights)), BAND)
    # the port's CPU route picks the same map and obeys the same rule
    mine = pipeline.blend_all_focus(_t(images), _t(weights), _t(offsets), _t(maps),
                                    _t(tables.decode), method=method)
    blend_torch.check_bytes(mine, blend_torch.exact_sums(selected, _t(weights)), BAND)


def _planted():
    """Sums with known distances from a half-integer, and their bytes."""
    sums = torch.tensor([[10.25, 99.5 + 2.0 ** -10, 200.5 - 2.0 ** -9, 7.5,
                          -3.2, 255.49, 300.0, 0.5 + 2.0 ** -7]], dtype=torch.float64)
    good = torch.tensor([[10, 100, 200, 8, 0, 255, 255, 1]], dtype=torch.uint8)
    return sums, good


def test_check_bytes_accepts_either_neighbour_inside_the_band_only():
    sums, good = _planted()
    counts = blend_torch.check_bytes(good, sums, BAND)
    assert counts == {"bytes": 8, "lax": 3, "ties_off": 0}
    lax = good.clone()
    lax[0, 1], lax[0, 2], lax[0, 3] = 99, 201, 7  # the other neighbour of each
    counts = blend_torch.check_bytes(lax, sums, BAND)
    assert counts == {"bytes": 8, "lax": 3, "ties_off": 3}


@pytest.mark.parametrize("index, byte", [
    (0, 11),  # off by one, 0.25 from the half-integer
    (7, 0),  # off by one, 2^-7 from the half-integer: just outside the band
    (1, 101),  # inside the band, but 2 LSB from the lower neighbour
    (2, 199),  # inside the band, one below the lower neighbour
    (4, 1),  # a negative sum clips to 0
    (6, 254),  # a sum past 255 clips to 255
], ids=["strict+1", "edge_of_band", "lax+2", "lax-1", "clip0", "clip255"])
def test_check_bytes_raises_on_a_planted_error(index, byte):
    sums, good = _planted()
    bad = good.clone()
    bad[0, index] = byte
    with pytest.raises(AssertionError, match=rf"first at \(0, {index}\)"):
        blend_torch.check_bytes(bad, sums, BAND)


def test_check_bytes_rejects_mismatched_operands():
    sums, good = _planted()
    with pytest.raises(ValueError, match="against sums"):
        blend_torch.check_bytes(good[:, :4], sums)
    with pytest.raises(ValueError, match="against sums"):
        blend_torch.check_bytes(good.int(), sums)


@pytest.mark.parametrize("spoil", ["mantissa", "overflow", "nan", "underflow"])
@pytest.mark.parametrize("upload", ["fixed", "allfocus"])
def test_weights_that_fp16_cannot_hold_raise_on_the_cpu_path(upload, spoil):
    """A float32 weight outside fp16 would be rounded silently by the tensor
    cores; the upload refuses it on every device, the CPU included."""
    value = {"mantissa": 1.0 + 2.0 ** -12, "overflow": 70000.0, "nan": np.nan,
             "underflow": 2.0 ** -30}[spoil]
    images, weights, shifts = _fixed_scene(4)
    good = state.fp16_valued(weights)
    assert good.dtype == np.float32 and np.array_equal(good, weights)
    weights[3, 2] = value
    with pytest.raises(ValueError, match="float16 cannot represent"):
        if upload == "fixed":
            state.upload_params(weights, shifts, "cpu")
        else:
            cfg = state.RenderConfig(focus_range=0.3, focus_map_views=4, view_count=12)
            params = state.allfocus_params("0,0,1,1", cols=2, rows=2, height=10,
                                           width=37, config=cfg)
            state.upload_allfocus(dataclasses.replace(params, weights=weights), "cpu")


def test_every_api_weight_matrix_passes_the_fp16_check():
    rng = np.random.default_rng(1)
    lf = LightField(rng.integers(0, 256, (16, 24, 40, 4), dtype=np.uint8), 4, 4)
    interp = Interpolator(lf, device="cpu", progress=False,
                          config=state.RenderConfig(view_count=9, focus_map_views=8,
                                                    focus_steps=4))
    for kw in (dict(focus=0.2), dict(focus=0.2, focus_range=0.3)):
        assert interp.interpolate("0,0,3,3", progress=False, **kw).views.shape[0] == 9
        batch = interp.interpolate_batch(["0,0,3,3", "1,1,2,2"], progress=False, **kw)
        assert [r.views.shape[0] for r in batch] == [9, 9]


@pytest.mark.parametrize("kind", ["fixed", "allfocus", "quilt"])
def test_zero_padding_of_the_weight_matrix_gives_the_unpadded_result(kind):
    """Zero rows (the kernels pad views to a multiple of 16) and zero
    columns (G to a multiple of 16, here with extra images) change no byte
    of the plain version, the rule's reference."""
    images, weights, shifts = _fixed_scene(12, v=6)
    _, _, offsets, fmap, tables = _allfocus_scene(12, v=6)
    padded_w = np.zeros((16, 16), np.float32)
    padded_w[:6, :12] = weights
    more = np.concatenate([images, images[:4]])
    if kind == "fixed":
        got = shift_blend.shift_blend(_t(images), _t(weights), _t(shifts))
        padded = shift_blend.shift_blend(
            _t(more), _t(padded_w), _t(np.concatenate([shifts, shifts[:4]])))
    elif kind == "allfocus":
        rest = (_t(fmap), _t(tables.decode))
        got = allfocus_blend.allfocus_blend(_t(images), _t(weights), _t(offsets), *rest)
        padded = allfocus_blend.allfocus_blend(
            _t(more), _t(padded_w), _t(np.concatenate([offsets, offsets[:4]])), *rest)
    else:
        got = quilt.quilt_blend(_t(images), _t(weights), _t(shifts), 3, 2)
        padded = quilt.quilt_blend(
            _t(more), _t(padded_w), _t(np.concatenate([shifts, shifts[:4]])), 3, 2)
        assert torch.equal(padded, got)
        return
    assert torch.equal(padded[:6], got)
    assert int(padded[6:].max()) == 0
