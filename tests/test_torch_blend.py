"""The port's STD path (lfinterpolator_tpu_torch/ops/blend_torch.py) against
the JAX package's blend_xla and the NumPy oracle.

Same seeded inputs through both packages; the tolerance is bit-equality
throughout: the shift is pure data movement, and with fp16-quantized
weights every product is exact, so the f32 sums agree byte for byte
(reference.blend_fixed sums in ascending g, as the kernel does).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.ops import blend_xla, reference
from lfinterpolator_tpu_torch.ops import blend_torch

torch.set_num_threads(1)

# (cols, rows, H, W, V): grids of 1x1, 3x5, 4x4; an odd 45x70 geometry
SCENES = [
    (1, 1, 48, 64, 1),
    (3, 5, 45, 70, 7),
    (4, 4, 48, 64, 64),
]


def _scene(cols, rows, h, w, v, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)
    se = geometry.parse_trajectory("0,0,1,1", (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    return rng, images, wm, offsets


def _shifts(rng, g, h, w):
    """Integer (dx, dy): zeros, negatives and values past the image size."""
    fo = rng.integers(-(w + 9), w + 10, (g, 2)).astype(np.int32)
    fo[:, 1] = rng.integers(-(h + 9), h + 10, g)
    fo[0] = 0
    if g > 2:
        fo[1] = (-(w + 3), h + 5)  # saturates both clamps
        fo[2] = (-3, -2)
    return fo


def _planar(images):
    return np.ascontiguousarray(images[..., :3].transpose(0, 3, 1, 2))


def _ids(s):
    return f"{s[0]}x{s[1]}_{s[2]}x{s[3]}_v{s[4]}"


@pytest.mark.parametrize("scene", SCENES, ids=_ids)
def test_shift_stack_matches_blend_xla(scene):
    cols, rows, h, w, v = scene
    rng, images, _, _ = _scene(*scene)
    fo = _shifts(rng, cols * rows, h, w)
    planar = _planar(images)
    got = blend_torch.shift_stack(torch.from_numpy(planar), torch.from_numpy(fo))
    want = np.asarray(blend_xla.shift_stack(jnp.asarray(planar), jnp.asarray(fo)))
    np.testing.assert_array_equal(got.numpy(), want)
    for g in range(cols * rows):  # and the oracle's clamped read
        np.testing.assert_array_equal(
            got.numpy()[g].transpose(1, 2, 0),
            reference._shift_clamped(images[g, :, :, :3], fo[g, 1], fo[g, 0]),
        )


@pytest.mark.parametrize("scene", SCENES, ids=_ids)
def test_blend_matches_blend_xla(scene):
    rng, images, wm, _ = _scene(*scene)
    planar = _planar(images)
    w32 = wm.astype(np.float32)
    got = blend_torch.blend(torch.from_numpy(planar), torch.from_numpy(w32))
    want = np.asarray(blend_xla.blend(jnp.asarray(planar), jnp.asarray(w32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("focus", [0.0, 0.37, -0.6, 9.0])
@pytest.mark.parametrize("scene", SCENES, ids=_ids)
def test_render_fixed_matches_blend_xla_and_oracle(scene, focus):
    rng, images, wm, offsets = _scene(*scene)
    fo = geometry.focused_offsets(offsets, focus)
    planar = _planar(images)
    w32 = wm.astype(np.float32)
    got = blend_torch.render_fixed(
        torch.from_numpy(planar), torch.from_numpy(w32), torch.from_numpy(fo)
    ).numpy()
    want = np.asarray(blend_xla.render_fixed(
        jnp.asarray(planar), jnp.asarray(w32), jnp.asarray(fo)
    ))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got.transpose(0, 2, 3, 1), reference.blend_fixed(images, wm, fo)
    )


def test_render_fixed_extreme_shifts_match_oracle():
    rng, images, wm, _ = _scene(3, 5, 45, 70, 7)
    fo = _shifts(rng, 15, 45, 70)
    got = blend_torch.render_fixed(
        torch.from_numpy(_planar(images)),
        torch.from_numpy(wm.astype(np.float32)),
        torch.from_numpy(fo),
    ).numpy()
    np.testing.assert_array_equal(
        got.transpose(0, 2, 3, 1), reference.blend_fixed(images, wm, fo)
    )


def test_planar_roundtrip_matches_blend_xla():
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (2, 5, 7, 4), dtype=np.uint8)
    planar = blend_torch.to_planar(torch.from_numpy(images))
    np.testing.assert_array_equal(
        planar.numpy(), np.asarray(blend_xla.to_planar(jnp.asarray(images)))
    )
    back = blend_torch.from_planar(planar)
    np.testing.assert_array_equal(back.numpy(), images[..., :3])
    assert planar.is_contiguous() and back.is_contiguous()


def test_blend_rounds_half_to_even_and_clips():
    # one image, one view: out = rint(w * p) clipped to [0, 255]
    px = torch.tensor([0, 1, 3, 5, 255], dtype=torch.uint8).reshape(1, 1, 1, 5)
    for wv, want in [(0.5, [0, 0, 2, 2, 128]), (2.0, [0, 2, 6, 10, 255]),
                     (-1.0, [0, 0, 0, 0, 0])]:
        got = blend_torch.blend(px, torch.tensor([[wv]], dtype=torch.float32))
        assert got.reshape(-1).tolist() == want


def test_temp_bytes_counts_the_peak():
    g, v, c, h, w = 64, 64, 3, 1080, 1920
    n = c * h * w
    assert blend_torch.temp_bytes(g, v, c, h, w) == 5 * g * n + 4 * v * n
    assert blend_torch.temp_bytes(1, 64, c, h, w) == n + 5 * 64 * n


@pytest.mark.parametrize("allow", [True, False])
def test_blend_leaves_the_callers_tf32_setting(allow):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        px = torch.full((2, 3, 4, 5), 7, dtype=torch.uint8)
        got = blend_torch.blend(px, torch.tensor([[0.5, 0.25]], dtype=torch.float32))
        assert (got == 5).all()  # rint(3.5 + 1.75)
        assert torch.backends.cuda.matmul.allow_tf32 is allow
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
