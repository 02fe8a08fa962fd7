"""The port's own copies of the JAX package's framework-free modules,
held equal to the originals on the same inputs: ``core/geometry.py``,
``core/config.py``, ``io/{codec,loader,writer}.py`` and the CLI parser.

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
from lfinterpolator_tpu_torch import cli
from lfinterpolator_tpu_torch.core import config, geometry
from lfinterpolator_tpu_torch.io import codec, loader, writer

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
