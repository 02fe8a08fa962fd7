"""The port's per-pixel-focus blend (blend_torch.allfocus_selected /
render_allfocus, the plain version that ops/allfocus_blend.py takes on CPU
tensors) and models/pipeline's all-focus functions against the JAX package
and the NumPy oracle.

Tolerances:
  * against reference.blend_allfocus: bit-equal, on raw maps (the
    estimator's level bytes) and on filtered maps (arbitrary bytes) -- the
    select is pure data movement with the oracle's coordinate expression,
    and with fp16-valued weights every product is exact;
  * against pipeline.blend_all_focus of the JAX package (its fused Pallas
    allFocus kernel, interpret mode): within 1 LSB, the class of its
    blend_tiled contraction (blend_pallas.py:261-270).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.models import pipeline as jax_pipeline
from lfinterpolator_tpu.ops import allfocus_pallas, reference
from lfinterpolator_tpu.ops import focus as focus_ops
from lfinterpolator_tpu_torch.models import pipeline
from lfinterpolator_tpu_torch.ops import allfocus_blend, blend_torch
from lfinterpolator_tpu_torch.state import focus_tables
from lfinterpolator_tpu_torch.utils import profiling

torch.set_num_threads(1)

# (cols, rows, H, W, V)
SCENES = [
    (1, 1, 20, 30, 1),
    (3, 5, 45, 70, 7),
    (4, 4, 48, 64, 64),
]
# (focus, range): the headline pair, negative focus, shifts past the image
FOCI = [(0.1, 0.3), (-0.6, 1.5), (2.0, 3.0)]


def _scene(cols, rows, h, w, v, focus, frange, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)
    se = geometry.parse_trajectory("0,0,1,1", (cols, rows))
    wm = geometry.quantize_weights_f16(geometry.weight_matrix(se, cols, rows, 3.0, v))
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    tables = focus_tables(focus, frange, 8)
    raw = tables.candidate_bytes[rng.integers(0, 8, (h, w))]
    filtered = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return images, wm, offsets, {"raw": raw, "filtered": filtered}, tables.decode


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planar(images):
    return _t(images[..., :3].transpose(0, 3, 1, 2))


def _ids(s):
    return f"{s[0]}x{s[1]}_{s[2]}x{s[3]}_v{s[4]}"


@pytest.mark.parametrize("kind", ["raw", "filtered"])
@pytest.mark.parametrize("foci", FOCI, ids=["f0.1", "neg", "far"])
@pytest.mark.parametrize("scene", SCENES, ids=_ids)
def test_render_allfocus_matches_oracle(scene, foci, kind):
    images, wm, offsets, maps, decode = _scene(*scene, *foci)
    got = blend_torch.render_allfocus(
        _planar(images), _t(wm.astype(np.float32)), _t(offsets),
        _t(maps[kind]), _t(decode),
    ).numpy()
    want = reference.blend_allfocus(images, wm, offsets, maps[kind], *foci)
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("kind", ["raw", "filtered"])
@pytest.mark.parametrize("foci", FOCI, ids=["f0.1", "neg", "far"])
def test_allfocus_selected_matches_oracle(foci, kind):
    images, _, offsets, maps, decode = _scene(3, 5, 45, 70, 1, *foci)
    got = blend_torch.allfocus_selected(
        _planar(images), _t(offsets), _t(maps[kind]), _t(decode)
    ).numpy()
    # unit weights: the oracle's blend returns each image's selected pixels
    eye = np.eye(15, dtype=np.float16)
    want = reference.blend_allfocus(images, eye, offsets, maps[kind], *foci)
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), want)


# (G, H, W, focus, range, offset amplitude): geometries the fused kernel takes
JAX_CASES = [
    (6, 64, 256, 0.1, 0.3, 60.0),
    (5, 96, 140, -0.9, 0.2, 200.0),  # shifts beyond the image width
]


@pytest.mark.parametrize("method", ["TEN", "STD"])
@pytest.mark.parametrize("case", JAX_CASES, ids=["g6_64x256", "g5_96x140_far"])
def test_blend_all_focus_matches_jax_pipeline(case, method, monkeypatch):
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")  # JAX -> the Pallas kernel
    g, h, w, focus, frange, amp = case
    rng = np.random.default_rng(g + h)
    images = rng.integers(0, 256, (g, 3, h, w), dtype=np.uint8)
    wm = (np.abs(rng.normal(size=(8, g))) / g).astype(np.float16).astype(np.float32)
    offsets = rng.uniform(-amp, amp, (g, 2)).astype(np.float32)
    tables = focus_tables(focus, frange, 8)
    maps = np.stack([
        tables.candidate_bytes[rng.integers(0, 8, (h, w))],
        rng.integers(0, 256, (h, w), dtype=np.uint8),
    ])
    spread = allfocus_pallas.spread_bound(offsets, focus, frange, bucket=8)
    assert jax_pipeline.allfocus_uses_fused_blend(method, h, w, spread)
    want = np.asarray(jax_pipeline.blend_all_focus(
        jnp.asarray(images), jnp.asarray(wm), jnp.asarray(offsets),
        jnp.asarray(maps), jnp.float32(focus), jnp.float32(frange),
        method=method, steps=8,
        pad=focus_ops.shift_pad_bound(offsets, focus, frange, (2, 2), h, w),
        spread=spread,
    ))
    got = pipeline.blend_all_focus(
        _t(images), _t(wm), _t(offsets), _t(maps), _t(tables.decode),
        method=method,
    ).numpy()
    assert got.shape == want.shape == (8, 3, h, w)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    fmap = maps[1] if method == "STD" else maps[0]
    np.testing.assert_array_equal(
        got.transpose(0, 2, 3, 1),
        reference.blend_allfocus(images.transpose(0, 2, 3, 1), wm, offsets,
                                 fmap, focus, frange),
    )


def test_wrapper_takes_the_plain_version_on_cpu():
    images, wm, offsets, maps, decode = _scene(3, 5, 45, 70, 7, 0.1, 0.3)
    args = (_planar(images), _t(wm.astype(np.float32)), _t(offsets),
            _t(maps["filtered"]), _t(decode))
    before = profiling.launch_counts()
    got = allfocus_blend.allfocus_blend(*args)
    assert profiling.launch_counts() == before  # no kernel ran
    assert torch.equal(got, blend_torch.render_allfocus(*args))
    bad = {
        "images must be": (args[0].float(), *args[1:]),
        "weights must be": (args[0], args[1][:, :3], *args[2:]),
        "offsets must be": (*args[:2], args[2][:3], *args[3:]),
        "focus map must be": (*args[:3], args[3][:5], args[4]),
        "decode must be": (*args[:4], args[4][:255]),
    }
    for text, bad_args in bad.items():
        with pytest.raises(ValueError, match=text):
            allfocus_blend.allfocus_blend(*bad_args)


def test_pipeline_picks_the_map_of_each_method():
    images, wm, offsets, maps, decode = _scene(3, 5, 45, 70, 7, 0.1, 0.3)
    stack = _t(np.stack([maps["raw"], maps["filtered"]]))
    args = (_planar(images), _t(wm.astype(np.float32)), _t(offsets))
    for method, kind in (("STD", "filtered"), ("TEN", "raw"), ("TEN_WM", "raw")):
        got = pipeline.blend_all_focus(*args, stack, _t(decode), method=method)
        want = blend_torch.render_allfocus(*args, _t(maps[kind]), _t(decode))
        assert torch.equal(got, want), method
    with pytest.raises(ValueError, match="unknown method"):
        pipeline.blend_all_focus(*args, stack, _t(decode), method="WHAT")
