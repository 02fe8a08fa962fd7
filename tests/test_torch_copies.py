"""The port's own copies of the JAX package's framework-free modules,
held equal to the originals on the same inputs: ``core/geometry.py``,
``core/config.py``, ``io/{codec,loader,writer}.py``, the CLI parser, the
oracle ``ops/reference.py`` and ``utils/{metrics,scenes}.py``.

Tolerance: none. Every array, message, file byte and parsed flag is equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lfinterpolator_tpu import cli as jax_cli
from lfinterpolator_tpu.core import config as jax_config
from lfinterpolator_tpu.core import geometry as jax_geometry
from lfinterpolator_tpu.io import codec as jax_codec
from lfinterpolator_tpu.io import loader as jax_loader
from lfinterpolator_tpu.io import writer as jax_writer
from lfinterpolator_tpu.ops import reference as jax_reference
from lfinterpolator_tpu.utils import metrics as jax_metrics
from lfinterpolator_tpu.utils import scenes as jax_scenes
from lfinterpolator_tpu_torch import cli
from lfinterpolator_tpu_torch.core import config, geometry
from lfinterpolator_tpu_torch.io import codec, loader, writer
from lfinterpolator_tpu_torch.ops import reference
from lfinterpolator_tpu_torch.utils import metrics, scenes

torch.set_num_threads(1)


def _trajectory(rng) -> str:
    return ",".join(f"{x:.4f}" for x in rng.uniform(-0.2, 1.2, 4))


@pytest.mark.parametrize("seed", range(6))
def test_geometry_functions_equal_the_jax_ones(seed):
    rng = np.random.default_rng(seed)
    cols, rows = (int(x) for x in rng.integers(1, 9, 2))
    w, h = (int(x) for x in rng.integers(8, 2000, 2))
    effect, aspect, focus = rng.uniform(0.5, 4), rng.uniform(0.3, 2), rng.uniform(-3, 3)
    views = int(rng.integers(1, 70))
    traj = _trajectory(rng)

    def both(name, *args):
        got, want = getattr(geometry, name)(*args), getattr(jax_geometry, name)(*args)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert np.asarray(got).dtype == np.asarray(want).dtype, name
        return got

    se = both("parse_trajectory", traj, (cols, rows))
    both("generate_trajectory", se, views)
    center = both("trajectory_center", se)
    both("grid_positions", cols, rows)
    both("generate_weights", center, cols, rows, effect)
    wm = both("weight_matrix", se, cols, rows, effect, views)
    both("quantize_weights_f16", wm)
    offsets = both("compute_offsets", cols, rows, w, h, aspect, center)
    both("focused_offsets", offsets, focus)
    both("select_focus_views", se, cols, rows, int(rng.integers(1, cols * rows + 1)))
    both("block_radius", w, h, int(rng.integers(1, 200)))
    both("focus_candidates", focus, rng.uniform(0.01, 2), int(rng.integers(2, 40)))
    both("round_half_away", rng.integers(-20, 20, 50) / 2.0)


def test_geometry_errors_equal_the_jax_ones():
    for fn, args in (("parse_trajectory", ("0,0,1", (2, 2))),
                     ("select_focus_views", (np.zeros(4, np.float32), 2, 2, 5))):
        with pytest.raises(ValueError) as got:
            getattr(geometry, fn)(*args)
        with pytest.raises(ValueError) as want:
            getattr(jax_geometry, fn)(*args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"effect": -1.0, "aspect": 0.0}, {"focus": 0.2, "focus_range": 0.3},
     {"method": "WHAT"}, {"view_count": 0}, {"focus_steps": 1}, {"channels": 4},
     {"focus_map_refresh": 0}, {"method": "TEN_WM", "focus_map_refresh": 3}],
    ids=["default", "coerced", "all_focus", "method", "views", "steps", "channels",
         "refresh", "ten_wm"],
)
def test_render_config_equals_the_jax_one(kwargs):
    got, want = config.RenderConfig(**kwargs), jax_config.RenderConfig(**kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.uses_focus_map == want.uses_focus_map
    errors = []
    for cfg in (got, want):
        try:
            cfg.validate()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_codec_round_trips_across_packages(tmp_path, channels):
    img = np.random.default_rng(channels).integers(0, 256, (9, 13, channels), np.uint8)
    codec.encode_png(str(tmp_path / "port.png"), img)
    jax_codec.encode_png(str(tmp_path / "jax.png"), img)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    for name in ("port.png", "jax.png"):
        a, b = codec.decode(str(tmp_path / name)), jax_codec.decode(str(tmp_path / name))
        np.testing.assert_array_equal(a, b)
        assert a.shape == (9, 13, 4)
    assert codec.native_available() == jax_codec.native_available()
    out = np.empty((1, 9, 13, 4), np.uint8)
    assert codec.decode_batch([str(tmp_path / "port.png")], out) == jax_codec.decode_batch(
        [str(tmp_path / "port.png")], out.copy())
    with pytest.raises(ValueError, match="expects uint8"):
        codec.encode_png(str(tmp_path / "bad.png"), img.astype(np.int16))


@pytest.fixture
def scene_dir(tmp_path, small_lf):
    images, (cols, rows) = small_lf
    d = tmp_path / "scene"
    d.mkdir()
    for c in range(cols):
        for r in range(rows):
            jax_codec.encode_png(str(d / f"{c:02d}_{r:02d}.png"), images[c * rows + r])
    (d / "quilt.png").write_bytes(b"stray")
    return str(d)


@pytest.mark.parametrize("reference_order", [False, True])
def test_load_light_field_equals_the_jax_one(scene_dir, reference_order):
    got = loader.load_light_field(scene_dir, progress=False,
                                  reference_order=reference_order)
    want = jax_loader.load_light_field(scene_dir, progress=False,
                                       reference_order=reference_order)
    assert isinstance(got, loader.LightField)
    assert (got.cols, got.rows, got.grid_size, got.height, got.width) == (
        want.cols, want.rows, want.grid_size, want.height, want.width)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.image(1, 2), want.image(1, 2))


def test_loader_errors_equal_the_jax_ones(tmp_path):
    (tmp_path / "empty").mkdir()
    for path in (str(tmp_path / "missing"), str(tmp_path / "empty")):
        with pytest.raises((FileNotFoundError, ValueError)) as got:
            loader.load_light_field(path, progress=False)
        with pytest.raises((FileNotFoundError, ValueError)) as want:
            jax_loader.load_light_field(path, progress=False)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


@pytest.mark.parametrize("with_maps", [False, True])
def test_writer_bytes_equal_the_jax_ones(tmp_path, with_maps):
    rng = np.random.default_rng(7)
    views = rng.integers(0, 256, (11, 6, 10, 3), np.uint8)
    maps = rng.integers(0, 256, (2, 6, 10), np.uint8) if with_maps else None
    got = writer.write_views(str(tmp_path / "port"), views, maps, progress=False)
    want = jax_writer.write_views(str(tmp_path / "jax"), views, maps, progress=False)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    quilt = rng.integers(0, 256, (12, 20, 3), np.uint8)
    writer.write_quilt(str(tmp_path / "port" / "q" / "quilt.png"), quilt)
    jax_writer.write_quilt(str(tmp_path / "jax" / "q" / "quilt.png"), quilt)
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))


@pytest.mark.parametrize(
    "argv",
    [[], ["-h"], ["-i", "in", "-t", "0,0,1,1", "-o", "out", "-m", "TEN", "-f", "0.2"],
     ["-i", "a", "-r", "0.3", "-s", "-1", "-a", "2", "-b", "5", "--focus-views", "8",
      "--fast-focus", "--focus-pyramid", "--reference-order", "--json", "--no-progress"],
     ["--quilt", "--quilt-only", "--quilt-tile", "24x32", "--quilt-reference",
      "--bench-runs", "3"]],
    ids=["empty", "help", "fixed", "all_focus", "quilt"],
)
def test_build_parser_equals_the_jax_one(argv):
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(jax_cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert vars(cli.build_parser().parse_args(argv + ["--device", "cpu"]))["device"] == "cpu"


def _both(got, want):
    np.testing.assert_array_equal(got, want)
    assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.fixture(scope="module")
def oracle_inputs():
    """A seeded 3x3 grid at 24x32 with the render's weights and offsets."""
    rng = np.random.default_rng(11)
    cols = rows = 3
    h, w = 24, 32
    images = rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)
    se = geometry.parse_trajectory("0.1,0.2,0.9,0.7", (cols, rows))
    wm = geometry.quantize_weights_f16(geometry.weight_matrix(se, cols, rows, 3.0, 5))
    offsets = geometry.compute_offsets(cols, rows, w, h, 1.3, geometry.trajectory_center(se))
    ids = geometry.select_focus_views(se, cols, rows, 6)
    fmap = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return images, wm, offsets, ids, fmap


@pytest.mark.parametrize("focus", [0.37, -1.5])
def test_oracle_blends_equal_the_jax_ones(oracle_inputs, focus):
    images, wm, offsets, _, fmap = oracle_inputs
    fo = geometry.focused_offsets(offsets, focus)
    _both(reference.blend_fixed(images, wm, fo), jax_reference.blend_fixed(images, wm, fo))
    _both(reference.blend_fixed_fp16acc(images, wm, fo, batch=4),
          jax_reference.blend_fixed_fp16acc(images, wm, fo, batch=4))
    _both(reference.focus_values_from_map(fmap, focus, 0.3),
          jax_reference.focus_values_from_map(fmap, focus, 0.3))
    _both(reference.blend_allfocus(images, wm, offsets, fmap, focus, 0.3),
          jax_reference.blend_allfocus(images, wm, offsets, fmap, focus, 0.3))


@pytest.mark.parametrize("radius", [(2, 2), (4, 2), (0, 2)], ids=["r2", "r4x2", "r0"])
def test_oracle_focus_map_equals_the_jax_one(oracle_inputs, radius):
    images, _, offsets, ids, fmap = oracle_inputs
    if radius[0]:
        _both(reference.focus_map_estimate(images, offsets, ids, 0.1, 0.4, radius, steps=9),
              jax_reference.focus_map_estimate(images, offsets, ids, 0.1, 0.4, radius,
                                               steps=9))
    _both(reference.focus_map_filter(fmap, radius),
          jax_reference.focus_map_filter(fmap, radius))


def test_psnr_and_ssim_equal_the_jax_ones():
    rng = np.random.default_rng(12)
    a = rng.integers(0, 256, (30, 26, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0, 255).astype(np.uint8)
    for x, y in ((a, b), (a[..., 0], b[..., 0]), (a, a)):
        assert metrics.psnr(x, y) == jax_metrics.psnr(x, y)
        assert metrics.ssim(x, y) == jax_metrics.ssim(x, y)
        assert metrics.compare_images(x, y) == jax_metrics.compare_images(x, y)
    assert metrics.psnr(a, a) == float("inf")
    assert metrics.psnr(a, b, max_value=1.0) == jax_metrics.psnr(a, b, max_value=1.0)
    for fn in ("psnr", "ssim"):
        with pytest.raises(ValueError) as got:
            getattr(metrics, fn)(a, b[:-1])
        with pytest.raises(ValueError) as want:
            getattr(jax_metrics, fn)(a, b[:-1])
        assert str(got.value) == str(want.value)


def test_compare_files_and_vmaf_equal_the_jax_ones(tmp_path):
    rng = np.random.default_rng(13)
    for name in ("a.png", "b.png"):
        jax_codec.encode_png(str(tmp_path / name),
                             rng.integers(0, 256, (20, 18, 4), dtype=np.uint8))
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert metrics.vmaf_available() == jax_metrics.vmaf_available()
    assert metrics.vmaf(pa, pb) == jax_metrics.vmaf(pa, pb)
    for with_vmaf in (False, True):
        assert (metrics.compare_files(pa, pb, with_vmaf=with_vmaf)
                == jax_metrics.compare_files(pa, pb, with_vmaf=with_vmaf))


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"occluder_shift": (3.0, -7.6)}, {"n_occluders": (0, 2), "seed": 4},
     {"plane_foci": (0.1, 0.2), "n_occluders": (2,)}],
    ids=["default", "occluder_shift", "occluders", "two_planes"],
)
def test_occlusion_scene_equals_the_jax_one(kwargs):
    assert scenes.occlusion_foci(0.1, 0.4, 32) == jax_scenes.occlusion_foci(0.1, 0.4, 32)
    assert scenes.occlusion_foci() == jax_scenes.occlusion_foci()
    _both(scenes.make_occlusion_scene(3, 2, 30, 44, **kwargs),
          jax_scenes.make_occlusion_scene(3, 2, 30, 44, **kwargs))


def test_occlusion_scene_errors_equal_the_jax_ones():
    with pytest.raises(ValueError) as got:
        scenes.make_occlusion_scene(2, 2, 20, 20, n_occluders=(1,))
    with pytest.raises(ValueError) as want:
        jax_scenes.make_occlusion_scene(2, 2, 20, 20, n_occluders=(1,))
    assert str(got.value) == str(want.value)
