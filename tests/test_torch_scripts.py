"""The port's scripts (``scripts/torch_*.py``) on the CPU, at small sizes.

Each is held against its original where the original runs quickly here
(the video, quilt and metric scripts: same files, same lines), else
against the port's copy of the NumPy oracle or the port's API: the gate
must pass with every gated row at >= 45 dB, the 8K script's scene must be
the original's bytes and its band check must pass on a render and flag a
planted byte, the batching check must find no failing arm.

Tolerance: none, except the quilt's tile resize (1 LSB, ROADMAP Queue 3
entry 2) and the gate's own 45 dB threshold.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from lfinterpolator_tpu_torch import RenderConfig
from lfinterpolator_tpu_torch.api import Interpolator
from lfinterpolator_tpu_torch.io import LightField, codec, load_light_field

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _script(name):
    """Import scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _strict(text: str):
    """json.loads that refuses NaN and Infinity."""
    def refuse(c):
        raise ValueError(f"non-strict JSON constant {c}")
    return json.loads(text, parse_constant=refuse)


def _original(name, argv, monkeypatch):
    """Run the JAX package's scripts/<name>.py main() with `argv`."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return _script(name).main()


# --- the quality gate ---------------------------------------------------------

ORIGINAL_ROWS = {"fixed/STD", "fixed/TEN", "allfocus/STD", "allfocus/TEN",
                 "allfocus-fast/STD", "allfocus-fast/TEN"}
NEW_ROWS = {"quilt/TEN", "stream/fixed", "stream/allfocus"}


@pytest.mark.parametrize("scene", ["plane", "occlusion"])
def test_gate_passes_with_every_gated_row_over_45_db(scene, capsys):
    gate = _script("torch_quality_gate")
    rc = gate.main(["--size", "48x64", "--grid", "4x4", "--device", "cpu",
                    "--scene", scene])
    out = _strict(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["pass"] is True and out["threshold_db"] == 45.0
    assert set(out["psnr_db"]) == ORIGINAL_ROWS | NEW_ROWS
    assert set(out["gated"]) == set(out["psnr_db"]) - {"allfocus-fast/STD",
                                                        "allfocus-fast/TEN"}
    for row in out["gated"]:
        db = out["psnr_db"][row]
        assert db == "inf" or db >= 45.0, (row, db)
    assert set(out["informational"]) == {"allfocus-fast/STD", "allfocus-fast/TEN"}
    assert "PARITY.md:421" in out["informational"]["allfocus-fast/STD"]
    assert out["maps_equal_oracle"] == {"STD": True, "TEN": True}
    assert "pyramid_not_run" in out and "pyramid/TEN" not in out["psnr_db"]
    # the CPU launches no kernel
    assert not any(out["launches"].values()) and not any(out["stream_launches"].values())


def test_gate_make_scene_equals_the_original():
    got = _script("torch_quality_gate").make_scene(np.random.default_rng(5), 3, 2, 20, 24)
    want = _script("quality_gate").make_scene(np.random.default_rng(5), 3, 2, 20, 24)
    np.testing.assert_array_equal(got, want)


# --- the 8K render's pieces ---------------------------------------------------


def test_8k_scene_equals_the_original(monkeypatch):
    original = _script("bench_8k")
    monkeypatch.setattr(original, "H", 96)
    monkeypatch.setattr(original, "W", 160)
    np.testing.assert_array_equal(_script("torch_bench_8k").build_scene(96, 160),
                                  original.build_scene())


@pytest.fixture(scope="module")
def render_96x160():
    bench = _script("torch_bench_8k")
    images = bench.build_scene(96, 160)
    interp = Interpolator(LightField(images, bench.COLS, bench.ROWS), device="cpu",
                          progress=False)
    res = interp.interpolate(bench.TRAJ, focus=bench.FOCUS, focus_range=bench.FRANGE,
                             method="TEN", progress=False)
    return bench, images, res


def test_8k_band_check_passes_on_a_render(render_96x160):
    bench, images, res = render_96x160
    got = bench.verify_band(images, res.views, res.maps, "TEN")
    assert got["ok"], got
    assert got["rows"] == [48, 64] and got["map0_maxdiff"] == got["map1_maxdiff"] == 0
    assert got["views"]["bytes"] == 64 * 16 * 160 * 3


@pytest.mark.parametrize("plant", ["view", "map0", "map1"])
def test_8k_band_check_flags_a_planted_byte(render_96x160, plant):
    bench, images, res = render_96x160
    views, maps = res.views.copy(), res.maps.copy()
    if plant == "view":
        views[37, 50, 101, 2] ^= 0x40
    else:
        maps[int(plant[-1]), 55, 17] ^= 0x10
    got = bench.verify_band(images, views, maps, "TEN")
    assert not got["ok"]
    if plant == "view":
        assert "break the near-tie rule" in got["views"]["error"]
    else:
        assert got[f"{plant}_maxdiff"] == 0x10


def test_8k_script_end_to_end_at_a_small_size(capsys):
    bench = _script("torch_bench_8k")
    assert bench.main(["--size", "40x64", "--method", "STD", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("RESULT ")
    res = _strict(line[len("RESULT "):])["methods"]["STD"]
    assert res["plan"]["arm"] == "one pass" and res["verify"]["ok"]
    assert set(res["phases_ms"]) == {"estimate", "blend", "download"}


# --- map refresh ----------------------------------------------------------------


def test_map_refresh_json_is_strict_and_counts_stale_frames(capsys):
    mr = _script("torch_map_refresh_quality")
    args = ["--size", "48x64", "--grid", "4x4", "--frames", "6", "--device", "cpu"]
    assert mr.main(args + ["--refresh", "3"]) == 0
    out = _strict(capsys.readouterr().out.strip())
    got = out["refresh"]["3"]
    assert got["stale_frames"] == 4 and got["identical_frames"] == 0
    assert isinstance(got["min_db"], float) and got["min_db"] <= got["mean_db"]
    assert set(out["fps"]) == {"1", "3"}
    # still occluders: every stale frame is identical, so no dB at all
    assert mr.main(["--size", "48x64", "--frames", "4", "--steps", "8", "--speed", "0",
                    "--refresh", "3", "--device", "cpu"]) == 0
    still = _strict(capsys.readouterr().out.strip())["refresh"]["3"]
    assert still == {"stale_frames": 2, "identical_frames": 2, "mean_db": None,
                     "min_db": None}


def test_map_refresh_rejects_refresh_1(capsys):
    assert _script("torch_map_refresh_quality").main(
        ["--size", "48x64", "--frames", "6", "--refresh", "4,1", "--device", "cpu"]) == 1
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1 and ">= 2" in err


# --- render video -------------------------------------------------------------


@pytest.fixture
def video_tree(tmp_path):
    root = tmp_path / "video"
    rng = np.random.default_rng(3)
    for f in range(3):
        d = root / f"frame{f:03d}"
        d.mkdir(parents=True)
        for c in range(2):
            for r in range(2):
                codec.encode_png(str(d / f"{c}_{r}.png"),
                                 rng.integers(0, 256, (12, 16, 4), dtype=np.uint8))
    return root


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def test_render_video_writes_the_originals_pngs_and_resumes(video_tree, tmp_path,
                                                             monkeypatch, capsys):
    argv = ["-i", str(video_tree), "-t", "0,0,1,1", "-m", "STD", "-f", "0.3"]
    assert _original("render_video", argv + ["-o", str(tmp_path / "jax")], monkeypatch) == 0
    video = _script("torch_render_video")
    port = argv + ["-o", str(tmp_path / "port"), "--device", "cpu"]
    assert video.main(port) == 0
    capsys.readouterr()
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(got) == 3 * 64 and got == want
    assert video.main(port + ["--resume"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1].startswith("3 frames (0 rendered, 3 skipped)")
    assert _strict(lines[-1])["skipped"] == 3


# --- validate batching -----------------------------------------------------------


def test_validate_batching_finds_no_failing_arm(capsys):
    assert _script("torch_validate_batching").main(
        ["--size", "96x128", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert _strict(lines[-1]) == {"batched_arm_failures": 0}
    batched = [ln for ln in lines if "view batches" in ln]
    assert len(batched) == 3 and all("views_eq=True" in ln for ln in batched)
    assert sum("not an arm of the port (TPU only)" in ln for ln in lines) == 11


# --- views to quilt ----------------------------------------------------------------


@pytest.mark.parametrize("tile", [None, "10x7"], ids=["native", "tile_10x7"])
def test_views_to_quilt_equals_the_original(tmp_path, monkeypatch, tile):
    views = np.random.default_rng(4).integers(0, 256, (46, 12, 16, 3), dtype=np.uint8)
    d = tmp_path / "views"
    d.mkdir()
    for i, v in enumerate(views):
        codec.encode_png(str(d / f"{i:02d}.png"), v)
    codec.encode_png(str(d / "map0.png"), views[0])
    extra = ["--tile", tile] if tile else []
    assert _original("views_to_quilt", [str(d), str(tmp_path / "jax.png"), *extra],
                     monkeypatch) == 0
    assert _script("torch_views_to_quilt").main(
        [str(d), str(tmp_path / "port.png"), *extra, "--device", "cpu"]) == 0
    got = codec.decode(str(tmp_path / "port.png")).astype(int)
    want = codec.decode(str(tmp_path / "jax.png")).astype(int)
    assert got.shape == want.shape == ((9 * 7, 5 * 10, 4) if tile else (9 * 12, 5 * 16, 4))
    assert np.abs(got - want).max() <= (1 if tile else 0)


# --- image metrics and compare dirs --------------------------------------------------


@pytest.fixture
def image_dirs(tmp_path):
    rng = np.random.default_rng(6)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    for name in ("00.png", "01.png", "02.png"):
        img = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
        codec.encode_png(str(a / name), img)
        noisy = np.clip(img.astype(int) + rng.integers(-3, 4, img.shape), 0, 255)
        codec.encode_png(str(b / name), img if name == "01.png" else noisy.astype(np.uint8))
    (a / "only_a.png").write_bytes((a / "00.png").read_bytes())
    return a, b


def test_image_quality_metrics_line_equals_the_original(image_dirs, monkeypatch, capsys):
    a, b = image_dirs
    for name in ("00.png", "01.png"):
        pair = [str(a / name), str(b / name)]
        assert _original("image_quality_metrics", pair, monkeypatch) == 0
        want = capsys.readouterr().out
        assert _script("torch_image_quality_metrics").main(pair + ["--device", "cpu"]) == 0
        assert capsys.readouterr().out == want


@pytest.mark.parametrize("as_json", [False, True], ids=["lines", "json"])
def test_compare_dirs_output_equals_the_original(image_dirs, monkeypatch, capsys, as_json):
    a, b = image_dirs
    argv = [str(a), str(b)] + (["--json"] if as_json else [])
    assert _original("compare_dirs", argv, monkeypatch) == 0
    want = capsys.readouterr().out
    assert _script("torch_compare_dirs").main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    if as_json:
        assert _strict(got)["files"]["01.png"]["psnr"] == "inf"


# --- focus map compare ----------------------------------------------------------------


def test_focus_map_compare_on_stand_in_scenes(tmp_path):
    """A seeded 6x6 stand-in for the 'cornell' scene (the real captured
    scenes are not in the repository): the two files equal the port's API
    renders of the full trajectory's view 0 and of the single position."""
    root = tmp_path / "inputs"
    d = root / "cornell"
    d.mkdir(parents=True)
    tex = np.random.default_rng(8).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    for c in range(6):
        for r in range(6):
            img = np.full((32, 48, 4), 255, np.uint8)
            img[:, :, :3] = tex[r * 2:r * 2 + 32, c * 2:c * 2 + 48]
            codec.encode_png(str(d / f"{c}_{r}.png"), img)
    fmc = _script("torch_focus_map_compare")
    out = tmp_path / "comparison"
    assert fmc.main(["--input-root", str(root), "--out", str(out), "--scenes", "cornell",
                     "--device", "cpu"]) == 0
    f_start, f_end, aspect = fmc.SCENES["cornell"]
    interp = Interpolator(load_light_field(str(d), progress=False), device="cpu",
                          progress=False,
                          config=RenderConfig(method="STD", effect=7.0, aspect=aspect))
    for traj, path in (("0.071,0.071,0.93,0.93", out / "cornellC" / "0.png"),
                       ("0.071,0.071,0.071,0.071", out / "cornell" / "0.png")):
        want = interp.interpolate(traj, focus=f_start, focus_range=f_end,
                                  progress=False).views[0]
        np.testing.assert_array_equal(codec.decode(str(path))[..., :3], want)
    assert fmc.main(["--input-root", str(root), "--scenes", "nowhere",
                     "--device", "cpu"]) == 1


# --- every script refuses to run without the card it defaults to ------------------------

DEFAULT_DEVICE_ARGV = {
    "torch_quality_gate": [],
    "torch_bench_8k": [],
    "torch_map_refresh_quality": [],
    "torch_render_video": ["-i", "in", "-o", "out", "-t", "0,0,1,1"],
    "torch_validate_batching": [],
    "torch_views_to_quilt": ["views"],
    "torch_image_quality_metrics": ["a.png", "b.png"],
    "torch_compare_dirs": ["a", "b"],
    "torch_focus_map_compare": ["--input-root", "in"],
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_ARGV))
def test_script_defaults_to_the_card_and_raises_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _script(name).main(DEFAULT_DEVICE_ARGV[name])


def test_8k_band_oracle_equals_the_oracle_on_its_rows(render_96x160):
    """The band evaluation of the estimate and the filter equals the
    oracle's whole-frame functions on the band's rows."""
    from lfinterpolator_tpu_torch import state
    from lfinterpolator_tpu_torch.ops import reference

    bench, images, res = render_96x160
    p = state.allfocus_params(bench.TRAJ, cols=8, rows=8, height=96, width=160,
                              config=RenderConfig(focus=bench.FOCUS, focus_range=bench.FRANGE))
    r0, rc = bench.band_rows(96), bench.BAND_ROWS
    ids = p.focus_ids[::4]  # 8 of the 32 focus views: the oracle is slow
    full = reference.focus_map_estimate(images, p.offsets, ids, bench.FOCUS,
                                        bench.FRANGE, p.radius, steps=bench.STEPS)
    np.testing.assert_array_equal(
        bench.oracle_band_map0(images, p.offsets, ids, p.radius, r0, rc),
        full[r0:r0 + rc])
    np.testing.assert_array_equal(
        bench.oracle_band_filter(full, (3, 2), r0, rc),
        reference.focus_map_filter(full, (3, 2))[r0:r0 + rc])
