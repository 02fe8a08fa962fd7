"""The port's fixed-focus slice end to end on the CPU, against the JAX
package: Interpolator against Interpolator, CLI against CLI.

Tolerances: the port's views are bit-equal to the NumPy oracle
(reference.blend_fixed); against the JAX package they are within 1 LSB,
the class of the JAX TEN kernel (blend_pallas.py:261-270), which runs here
in Pallas interpret mode.
"""

import json
import os

import numpy as np
import pytest
import torch

from lfinterpolator_tpu import cli as jax_cli
from lfinterpolator_tpu.api import Interpolator as JaxInterpolator
from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.core.config import RenderConfig
from lfinterpolator_tpu.io import codec
from lfinterpolator_tpu.io.loader import LightField
from lfinterpolator_tpu.ops import reference
from lfinterpolator_tpu_torch import cli
from lfinterpolator_tpu_torch import io as port_io
from lfinterpolator_tpu_torch.api import Interpolator, RenderResult, interpolate
from lfinterpolator_tpu_torch.state import render_params, to_device_state

torch.set_num_threads(1)


@pytest.fixture
def scene_dir(tmp_path, small_lf):
    images, (cols, rows) = small_lf
    d = tmp_path / "scene"
    d.mkdir()
    for c in range(cols):
        for r in range(rows):
            codec.encode_png(str(d / f"{c:02d}_{r:02d}.png"), images[c * rows + r])
    return str(d)


def _params(cols, rows, h, w, focus, effect=3.0, aspect=1.0, views=64,
            trajectory="0,0,1,1"):
    """The weights and shifts as lfinterpolator_tpu/api.py:593-611 builds them."""
    se = geometry.parse_trajectory(trajectory, (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, effect, views)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, aspect, geometry.trajectory_center(se)
    )
    return wm, geometry.focused_offsets(offsets, focus)


def _oracle(images, cols, rows, focus, views=64):
    wm, fo = _params(cols, rows, images.shape[1], images.shape[2], focus,
                     views=views)
    return reference.blend_fixed(images, wm, fo)


@pytest.mark.parametrize("method", ["STD", "TEN"])
@pytest.mark.parametrize("focus", [0.0, 0.25, -0.6])
def test_interpolator_matches_jax_and_oracle(small_lf, method, focus, monkeypatch):
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")  # JAX TEN -> Pallas kernels
    images, (cols, rows) = small_lf
    lf = LightField(images, cols, rows)
    got = Interpolator(lf, device="cpu", progress=False).interpolate(
        "0,0,1,1", focus=focus, method=method, progress=False
    )
    want = JaxInterpolator(lf, progress=False).interpolate(
        "0,0,1,1", focus=focus, method=method, progress=False
    )
    assert got.views.shape == want.views.shape == (64, 48, 64, 3)
    assert np.abs(got.views.astype(int) - want.views.astype(int)).max() <= 1
    np.testing.assert_array_equal(got.views, _oracle(images, cols, rows, focus))
    assert got.maps is None and got.run_times_s == []


def test_interpolator_benchmark_runs(small_lf):
    images, (cols, rows) = small_lf
    interp = Interpolator(LightField(images, cols, rows),
                          config=RenderConfig(view_count=8), device="cpu",
                          progress=False)
    res = interp.interpolate("0,0,1,1", focus=0.1, method="TEN",
                             benchmark_runs=2, progress=False)
    assert len(res.run_times_s) == 2 and res.avg_ms > 0
    assert res.megapixels_per_s == pytest.approx(
        8 * 48 * 64 / (res.avg_ms / 1000) / 1e6
    )


def test_cli_matches_jax_cli(scene_dir, small_lf, tmp_path, capsys):
    out_port, out_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    common = ["-i", scene_dir, "-t", "0.0,0.0,1.0,1.0", "-f", "0.2",
              "--json", "--no-progress"]
    assert cli.main(common + ["-o", out_port, "-m", "TEN", "--device", "cpu"]) == 0
    port_json = capsys.readouterr().out.strip().splitlines()[-1]
    assert jax_cli.main(common + ["-o", out_jax, "-m", "STD"]) == 0
    jax_json = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(port_json).keys() == json.loads(jax_json).keys()
    assert json.loads(port_json)["files_written"] == 64
    names = sorted(os.listdir(out_port))
    assert names == sorted(os.listdir(out_jax)) == [f"{i:02d}.png" for i in range(64)]
    images, (cols, rows) = small_lf
    want = _oracle(images, cols, rows, 0.2)
    for i, name in enumerate(names):
        a = port_io.decode(os.path.join(out_port, name))
        b = codec.decode(os.path.join(out_jax, name))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        np.testing.assert_array_equal(a[..., :3], want[i])
        assert (a[..., 3] == 255).all()


@pytest.mark.parametrize(
    "change, text",
    [
        ({"-m": "WHAT"}, "interpolation method"),
        ({"-t": "0,0,1"}, "4 comma-separated values"),
        ({"-i": "/nonexistent/scene"}, "does not exist"),
        ({"-r": "0.3", "--focus-pyramid": None}, "not yet ported (ROADMAP slice 2b)"),
        ({"--quilt": None}, "not yet ported (ROADMAP slice 3)"),
        # 16 grid images cannot feed the default 32 focus views
        ({"-r": "0.3", "--fast-focus": None}, "needs at least 32 grid images"),
    ],
    ids=["method", "trajectory", "missing_dir", "range", "quilt", "fast_focus"],
)
def test_cli_error_paths_exit_1_with_one_line(scene_dir, tmp_path, capsys, change, text):
    args = {"-i": scene_dir, "-o": str(tmp_path / "o"), "-t": "0,0,1,1",
            "-m": "STD", "--device": "cpu", **change}
    argv = [x for k, v in args.items() for x in ([k] if v is None else [k, v])]
    assert cli.main(argv) == 1
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1 and text in err
    assert not os.path.exists(tmp_path / "o")


def test_cli_help_and_missing_required(capsys):
    assert cli.main(["-h"]) == 0
    assert "hand-written Hopper kernel" in capsys.readouterr().out
    assert cli.main(["-i", "/tmp"]) == 1
    assert "Missing required parameters" in capsys.readouterr().err


def test_to_device_state_roundtrip(small_lf):
    images, (cols, rows) = small_lf
    wm = np.random.default_rng(5).random((7, cols * rows)).astype(np.float32)
    fo = np.arange(2 * cols * rows, dtype=np.int32).reshape(-1, 2) - 9
    x, w, s = to_device_state(images, wm, fo, "cpu")
    assert x.shape == (cols * rows, 3, 48, 64) and x.dtype == torch.uint8
    assert x.is_contiguous() and w.dtype == torch.float32 and s.dtype == torch.int32
    np.testing.assert_array_equal(x.numpy().transpose(0, 2, 3, 1), images[..., :3])
    np.testing.assert_array_equal(w.numpy(), wm)
    np.testing.assert_array_equal(s.numpy(), fo)


def test_not_ported_parts_raise(small_lf):
    images, (cols, rows) = small_lf
    interp = Interpolator(LightField(images, cols, rows), device="cpu",
                          config=RenderConfig(focus_pyramid=True), progress=False)
    with pytest.raises(NotImplementedError, match="ROADMAP slice 2b"):
        interp.interpolate("0,0,1,1", focus_range=0.3, progress=False)
    with pytest.raises(NotImplementedError, match="ROADMAP slice 3"):
        interp.render_quilt("0,0,1,1")
    with pytest.raises(NotImplementedError, match="ROADMAP slice 4"):
        interp.interpolate_batch(["0,0,1,1"])
    with pytest.raises(ValueError, match="does not exist"):
        interp.interpolate("0,0,1,1", method="WHAT", progress=False)


def test_one_shot_interpolate_and_loader(scene_dir, small_lf, tmp_path):
    images, (cols, rows) = small_lf
    lf = port_io.load_light_field(scene_dir, progress=False)
    assert (lf.cols, lf.rows) == (cols, rows)
    np.testing.assert_array_equal(lf.images, images)
    out = str(tmp_path / "out")
    res = interpolate(scene_dir, out, "0,0,1,1", focus=0.25, method="TEN",
                      progress=False, device="cpu")
    assert isinstance(res, RenderResult)
    assert sorted(os.listdir(out))[0] == "00.png" and len(os.listdir(out)) == 64
    np.testing.assert_array_equal(
        port_io.decode(os.path.join(out, "63.png"))[..., :3], res.views[63]
    )
    assert (port_io.decode(os.path.join(out, "00.png"))[..., 3] == 255).all()


def test_loader_reference_order_and_errors(scene_dir, small_lf, tmp_path):
    images, (cols, rows) = small_lf
    lf = port_io.load_light_field(scene_dir, progress=False, reference_order=True)
    np.testing.assert_array_equal(lf.image(1, 2), images[2 * rows + 1])
    with pytest.raises(FileNotFoundError):
        port_io.load_light_field(str(tmp_path / "missing"), progress=False)
    holes = tmp_path / "holes"
    holes.mkdir()
    for name in ["00_00.png", "00_01.png", "01_00.png"]:
        port_io.encode_png(str(holes / name), images[0])
    with pytest.raises(ValueError, match="missing images"):
        port_io.load_light_field(str(holes), progress=False)
    assert port_io.codec_name() in ("native", "pillow")


@pytest.mark.parametrize(
    "cols, rows, h, w, focus, effect, aspect, views, trajectory",
    [
        (4, 4, 48, 64, 0.0, 3.0, 1.0, 64, "0,0,1,1"),
        (4, 4, 48, 64, -0.6, 3.0, 1.0, 64, "0,0,1,1"),
        (3, 5, 45, 70, 0.25, 1.5, 1.0, 7, "0,0,1,1"),
        (3, 5, 45, 70, 4.0, 3.0, 0.5, 1, "0.2,0.9,0.7,0.1"),
        (1, 1, 48, 64, 0.37, 3.0, 1.0, 64, "0,0,1,1"),
        (8, 8, 1080, 1920, 5.0, 3.0, 1.0, 64, "0,0,1,1"),
    ],
    ids=["4x4_f0", "4x4_neg", "3x5_v7", "3x5_aspect_v1", "1x1", "8x8_1080p_far"],
)
def test_render_params_match_the_jax_construction(
    cols, rows, h, w, focus, effect, aspect, views, trajectory
):
    wm, fo = render_params(trajectory, cols=cols, rows=rows, height=h, width=w,
                           focus=focus, effect=effect, aspect=aspect, views=views)
    want_wm, want_fo = _params(cols, rows, h, w, focus, effect, aspect, views,
                               trajectory)
    assert wm.dtype == np.float32 and wm.shape == (views, cols * rows)
    np.testing.assert_array_equal(wm, want_wm.astype(np.float32))
    assert fo.dtype == np.int32 and fo.shape == (cols * rows, 2)
    np.testing.assert_array_equal(fo, want_fo)
