"""The port's quilt output on the CPU, against the JAX package and the
oracle montage.

Tolerances: quilts of native tiles bit-equal to the oracle montage
(``reference.blend_fixed`` / ``blend_allfocus``, tiled) and to the JAX
two-stage quilt; within 1 LSB of JAX's direct-to-canvas
``render_fixed_quilt_padded`` (an MXU sum, ``blend_pallas.py:384``);
resized tiles within 1 LSB of ``jax.image.resize`` (float32 sums in
another order), with the share of exact bytes printed.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfinterpolator_tpu import api as jax_api
from lfinterpolator_tpu import cli as jax_cli
from lfinterpolator_tpu.core.config import RenderConfig
from lfinterpolator_tpu.io import codec
from lfinterpolator_tpu.io.loader import LightField as JaxLightField
from lfinterpolator_tpu.ops import blend_pallas, reference
from lfinterpolator_tpu.ops import quilt as jax_quilt
from lfinterpolator_tpu_torch import api, cli
from lfinterpolator_tpu_torch import io as port_io
from lfinterpolator_tpu_torch.api import Interpolator, QuiltResult
from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.ops import quilt, quilt_torch
from lfinterpolator_tpu_torch.state import render_params, to_device_state
from lfinterpolator_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _montage(views, cols, rows):
    """[V, H, W, C] -> [rows*H, cols*W, C]: view i at (i // cols, i % cols)."""
    h, w, c = views.shape[1:]
    out = np.zeros((rows * h, cols * w, c), views.dtype)
    for i in range(cols * rows):
        r, cl = divmod(i, cols)
        out[r * h:(r + 1) * h, cl * w:(cl + 1) * w] = views[i]
    return out


# (V, C, H, W, cols, rows): tiles the TPU copy takes (h % 8 == 0,
# w % 128 == 0) and ones it does not
ASSEMBLIES = [
    (45, 3, 8, 128, 5, 9),
    (64, 3, 16, 256, 5, 9),
    (45, 3, 9, 70, 5, 9),
    (6, 3, 8, 128, 2, 3),
    (7, 1, 5, 13, 2, 3),
]


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("case", ASSEMBLIES, ids=lambda c: f"{c[2]}x{c[3]}_{c[4]}x{c[5]}")
def test_assemble_equals_jax(case, interpret, monkeypatch):
    v, c, h, w, cols, rows = case
    if interpret:
        monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")
    views = np.random.default_rng(v + h).integers(0, 256, (v, c, h, w), dtype=np.uint8)
    got = quilt.assemble_quilt(torch.from_numpy(views), cols, rows)
    want = np.asarray(jax_quilt.assemble_quilt(jnp.asarray(views), cols=cols, rows=rows))
    assert got.shape == (c, rows * h, cols * w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(quilt_torch.to_hwc(got).numpy(),
                                  np.asarray(jax_quilt.to_hwc(jnp.asarray(want))))
    np.testing.assert_array_equal(
        quilt_torch.to_hwc(got).numpy(), _montage(views.transpose(0, 2, 3, 1), cols, rows))


def test_assemble_needs_enough_views():
    views = torch.zeros((44, 3, 4, 4), dtype=torch.uint8)
    for fn in (quilt.assemble_quilt, quilt.quilt_copy, quilt_torch.montage):
        with pytest.raises(ValueError, match="Quilt needs 45 views, got 44"):
            fn(views, 5, 9)
    with pytest.raises(ValueError, match="Quilt needs 45 views"):
        quilt.quilt_blend(torch.zeros((4, 3, 4, 4), dtype=torch.uint8),
                          torch.zeros((44, 4), dtype=torch.float32),
                          torch.zeros((4, 2), dtype=torch.int32))


# (H, W) -> (tile H, tile W): a downscale, a 2x downscale, an upscale, and
# one axis only
RESIZES = [((96, 160), (37, 70)), ((96, 160), (48, 80)), ((24, 40), (60, 90)),
           ((48, 64), (48, 30))]


@pytest.mark.parametrize("case", RESIZES, ids=["down", "half", "up", "one_axis"])
def test_resize_within_one_lsb_of_jax(case, capsys):
    (h, w), (th, tw) = case
    views = np.random.default_rng(h + tw).integers(0, 256, (45, 3, h, w), dtype=np.uint8)
    got = quilt.assemble_quilt(torch.from_numpy(views), 5, 9, (th, tw)).numpy()
    want = np.asarray(jax_quilt.assemble_quilt(jnp.asarray(views), tile_size=(th, tw)))
    assert got.shape == want.shape == (3, 9 * th, 5 * tw)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    with capsys.disabled():
        print(f"\nresize {h}x{w} -> {th}x{tw}: {np.mean(diff == 0):.6f} of "
              "bytes equal jax.image.resize")


def test_resize_weights_match_jax_compute_weight_mat():
    from jax._src.image import scale

    for n_in, n_out in ((160, 70), (96, 48), (24, 60), (1920, 1080), (7, 7)):
        want = np.asarray(scale.compute_weight_mat(
            n_in, n_out, jnp.float32(n_out / n_in), jnp.float32(0),
            scale._fill_triangle_kernel, True))
        got = quilt_torch.resize_weights(n_in, n_out)
        assert got.shape == (n_out, n_in) and got.dtype == np.float32
        np.testing.assert_allclose(got.T, want, rtol=0, atol=2e-7)


def _scene(cols, rows, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)


@pytest.mark.parametrize("focus", [0.25, -0.6])
def test_quilt_only_render_equals_oracle_and_jax_fused(focus, monkeypatch):
    cols, rows, h, w = 4, 4, 16, 128
    images = _scene(cols, rows, h, w)
    wm, fo = render_params("0,0,1,1", cols=cols, rows=rows, height=h, width=w,
                           focus=focus)
    got = quilt.quilt_blend(*to_device_state(images, wm, fo, "cpu"))
    want = _montage(reference.blend_fixed(images, wm[:45], fo), 5, 9)
    np.testing.assert_array_equal(quilt_torch.to_hwc(got).numpy(), want)
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")
    assert jax_quilt.supports_fused_render(h, w, cols * rows)
    px, py = blend_pallas.shift_bound(fo.astype(np.float32), (1.0, 1.0), h, w)
    planar = jnp.asarray(images[..., :3].transpose(0, 3, 1, 2))
    fused = np.asarray(jax_quilt.render_fixed_quilt_padded(
        blend_pallas.pad_images(planar, px, py), jnp.asarray(wm), jnp.asarray(fo),
        h=h, w=w, px=px, py=py))
    assert np.abs(got.numpy().astype(int) - fused.astype(int)).max() <= 1


CONFIG = RenderConfig(focus_map_views=4, focus_steps=8)


@pytest.mark.parametrize(
    "kw",
    [dict(method="TEN"), dict(method="STD"), dict(method="TEN", focus_range=0.3),
     dict(method="STD", focus_range=0.3), dict(method="TEN", tile_size=(30, 50)),
     dict(method="TEN", cols=2, rows=3), dict(method="TEN", tile_size=(48, 64))],
    ids=["fused", "std", "allfocus_ten", "allfocus_std", "resized", "2x3", "native_tile"],
)
def test_render_quilt_matches_jax(small_lf, kw):
    images, (cols, rows) = small_lf
    lf = LightField(images, cols, rows)
    got = Interpolator(lf, config=CONFIG, device="cpu", progress=False).render_quilt(
        "0,0,1,1", focus=0.1, progress=False, **kw)
    want = jax_api.Interpolator(JaxLightField(images, cols, rows), config=CONFIG,
                                progress=False).render_quilt(
        "0,0,1,1", focus=0.1, progress=False, **kw)
    assert isinstance(got, QuiltResult)
    assert got.fused is (kw.get("method") == "TEN" and "focus_range" not in kw
                         and kw.get("tile_size", (48, 64)) == (48, 64))
    assert got.quilt.shape == want.quilt.shape and got.quilt.dtype == np.uint8
    qc, qr = kw.get("cols", 5), kw.get("rows", 9)
    th, tw = kw.get("tile_size", (48, 64))
    assert got.quilt.shape == (qr * th, qc * tw, 3)
    if (th, tw) == (48, 64):
        np.testing.assert_array_equal(got.quilt, want.quilt)
        # the oracle montage of the interpolate() views
        res = Interpolator(lf, config=CONFIG, device="cpu", progress=False).interpolate(
            "0,0,1,1", focus=0.1, focus_range=kw.get("focus_range", 0.0),
            method=kw["method"], progress=False)
        np.testing.assert_array_equal(got.quilt, _montage(res.views, qc, qr))
    else:
        assert np.abs(got.quilt.astype(int) - want.quilt.astype(int)).max() <= 1


@pytest.mark.parametrize(
    "kw",
    [dict(method="TEN"), dict(method="STD"), dict(method="TEN", focus_range=0.3),
     dict(method="TEN", tile_size=(30, 50))],
    ids=["fused", "std", "allfocus", "resized"],
)
def test_render_quilt_downloads_its_canvas_whole_once_a_call(small_lf, kw):
    """Either route hands its canvas to the Interpolator's downloader as
    one whole frame (one ``download bands`` a call), and the quilt is a
    C-contiguous array of its own: a kept quilt survives a later call."""
    images, (cols, rows) = small_lf
    interp = Interpolator(LightField(images, cols, rows), config=CONFIG, device="cpu",
                          progress=False)
    kept = []
    for focus in (0.1, 0.4):
        before = profiling.launch_counts()
        res = interp.render_quilt("0,0,1,1", focus=focus, cols=3, rows=2, progress=False,
                                  **kw)
        counted = profiling.launch_counts() - before
        assert counted["download bands"] == 1
        assert res.quilt.dtype == np.uint8 and res.quilt.flags.c_contiguous
        kept.append((res.quilt, res.quilt.copy()))
    assert not np.shares_memory(kept[0][0], kept[1][0])
    assert not np.array_equal(kept[0][1], kept[1][1])
    for quilt_np, copy in kept:
        np.testing.assert_array_equal(quilt_np, copy)


def test_render_quilt_benchmark_and_errors(small_lf, tmp_path):
    images, (cols, rows) = small_lf
    interp = Interpolator(LightField(images, cols, rows), device="cpu", progress=False)
    for method in ("TEN", "STD"):
        res = interp.render_quilt("0,0,1,1", method=method, benchmark_runs=2,
                                  progress=False)
        assert len(res.run_times_s) == 2 and res.avg_ms > 0 and res.gigapixels_per_s > 0
    path = res.save(str(tmp_path / "q" / "quilt.png"))
    np.testing.assert_array_equal(port_io.decode(path)[..., :3], res.quilt)
    few = Interpolator(LightField(images, cols, rows), device="cpu", progress=False,
                       config=RenderConfig(view_count=44))
    with pytest.raises(ValueError, match=r"Quilt needs 45 views \(5x9\), but view_count is 44"):
        few.render_quilt("0,0,1,1")
    with pytest.raises(ValueError, match="tile size must be positive"):
        interp.render_quilt("0,0,1,1", tile_size=(0, 10))


def test_save_quilt_assembles_the_views(small_lf, tmp_path):
    images, (cols, rows) = small_lf
    interp = Interpolator(LightField(images, cols, rows), device="cpu", progress=False)
    res = interp.interpolate("0,0,1,1", focus=0.2, method="TEN", progress=False)
    assert res.device == "cpu"
    path = res.save_quilt(str(tmp_path / "quilt.png"))
    np.testing.assert_array_equal(port_io.decode(path)[..., :3], _montage(res.views, 5, 9))
    path = res.save_quilt(str(tmp_path / "small.png"), cols=2, rows=3, tile_size=(20, 30))
    want = quilt_torch.to_hwc(quilt_torch.assemble_quilt(
        torch.from_numpy(res.views).permute(0, 3, 1, 2), 2, 3, (20, 30))).numpy()
    np.testing.assert_array_equal(port_io.decode(path)[..., :3], want)
    short = dataclasses.replace(res, views=res.views[:8])
    with pytest.raises(ValueError, match="Quilt needs 45 views, got 8"):
        short.save_quilt(str(tmp_path / "no.png"))


@pytest.fixture
def scene_dir(tmp_path, small_lf):
    images, (cols, rows) = small_lf
    d = tmp_path / "scene"
    d.mkdir()
    for c in range(cols):
        for r in range(rows):
            codec.encode_png(str(d / f"{c:02d}_{r:02d}.png"), images[c * rows + r])
    return str(d)


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize(
    "flags, files",
    [(["--quilt-only"], ["quilt.png"]),
     (["--quilt-only", "-m", "STD"], ["quilt.png"]),
     (["--quilt"], [f"{i:02d}.png" for i in range(64)] + ["quilt.png"]),
     (["--quilt-tile", "24x40"], [f"{i:02d}.png" for i in range(64)] + ["quilt.png"]),
     (["--quilt-only", "--quilt-tile", "30x50"], ["quilt.png"])],
    ids=["only", "only_std", "quilt", "tile", "only_tile"],
)
def test_cli_quilt_flags_match_jax_cli(scene_dir, tmp_path, capsys, flags, files):
    out_port, out_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    common = ["-i", scene_dir, "-t", "0,0,1,1", "-f", "0.2", "-m", "TEN", "--json",
              "--no-progress"] + flags
    assert cli.main(common + ["-o", out_port, "--device", "cpu"]) == 0
    port_json = _json_line(capsys)
    assert jax_cli.main(common + ["-o", out_jax]) == 0
    jax_json = _json_line(capsys)
    assert port_json.keys() == jax_json.keys()
    assert port_json["files_written"] == len(files)
    assert sorted(os.listdir(out_port)) == sorted(os.listdir(out_jax)) == sorted(files)
    a = port_io.decode(os.path.join(out_port, "quilt.png"))
    b = codec.decode(os.path.join(out_jax, "quilt.png"))
    assert a.shape == b.shape and (a[..., 3] == 255).all()
    if "--quilt-only" in flags:
        assert port_json["quilt"] == jax_json["quilt"] == [a.shape[1], a.shape[0]]
        assert port_json["fused"] is ("STD" not in flags and "--quilt-tile" not in flags)
    resized = "--quilt-tile" in flags
    assert np.abs(a.astype(int) - b.astype(int)).max() <= (1 if resized else 0)
    if "--quilt" in flags:  # the quilt is the montage of the written views
        views = np.stack([port_io.decode(os.path.join(out_port, f"{i:02d}.png"))
                          for i in range(45)])
        np.testing.assert_array_equal(a, _montage(views, 5, 9))


def test_cli_bad_quilt_tile_exits_1_before_the_load(tmp_path, capsys):
    for tile in ("0x5", "12", "axb", "3x-4"):
        argv = ["-i", str(tmp_path / "missing"), "-o", str(tmp_path / "o"),
                "-t", "0,0,1,1", "-m", "TEN", "--quilt-tile", tile, "--device", "cpu"]
        assert cli.main(argv) == 1
        err = capsys.readouterr().err.strip()
        assert err.startswith("Bad --quilt-tile") and len(err.splitlines()) == 1
    assert not os.path.exists(tmp_path / "o")


def test_cli_quilt_skipped_with_too_few_views(scene_dir, tmp_path, capsys, monkeypatch):
    """The CLI renders the config's views; with fewer than 45 it writes the
    views, says the quilt was skipped and exits 0 (``cli.py:189-195``)."""
    render = api.Interpolator.interpolate

    def fewer(self, *args, **kwargs):
        res = render(self, *args, **kwargs)
        return dataclasses.replace(res, views=res.views[:8])

    monkeypatch.setattr(api.Interpolator, "interpolate", fewer)
    out = tmp_path / "o"
    argv = ["-i", scene_dir, "-o", str(out), "-t", "0,0,1,1", "-m", "TEN", "--quilt",
            "--device", "cpu", "--no-progress"]
    assert cli.main(argv) == 0
    assert "Quilt skipped: needs >= 45 views" in capsys.readouterr().err
    assert sorted(os.listdir(out)) == [f"{i:02d}.png" for i in range(8)]


@pytest.mark.parametrize("only", [True, False], ids=["only", "quilt"])
def test_cli_quilt_reference_asks_for_reference_tiles(scene_dir, tmp_path, only,
                                                      monkeypatch):
    """--quilt-reference asks for 1080x1920 tiles (scripts/viewsToQuilt.sh:2),
    with or without --quilt-only; --quilt-tile overrides it."""
    seen = []

    def render_quilt(self, trajectory, **kwargs):
        seen.append(kwargs["tile_size"])
        return QuiltResult(np.zeros((9, 5, 3), np.uint8), [], self.config, False)

    def save_quilt(self, path, cols=5, rows=9, tile_size=None):
        seen.append(tile_size)
        return path

    monkeypatch.setattr(api.Interpolator, "render_quilt", render_quilt)
    monkeypatch.setattr(api.RenderResult, "save_quilt", save_quilt)
    base = ["-i", scene_dir, "-o", str(tmp_path / "o"), "-t", "0,0,1,1", "-m", "TEN",
            "--device", "cpu", "--no-progress"] + (["--quilt-only"] if only else [])
    assert cli.main(base + ["--quilt-reference"]) == 0
    assert cli.main(base + ["--quilt-reference", "--quilt-tile", "20x30"]) == 0
    assert seen == [(1080, 1920), (20, 30)]


def test_cli_help_names_the_new_flags(capsys):
    assert cli.main(["-h"]) == 0
    text = capsys.readouterr().out
    for flag in ("--focus-pyramid", "--quilt ", "--quilt-only", "--quilt-tile",
                 "--quilt-reference"):
        assert flag in text


def test_quilt_tiles_follow_geometry(small_lf):
    """The tiles are views 0..44 in montage order for any trajectory."""
    images, (cols, rows) = small_lf
    interp = Interpolator(LightField(images, cols, rows), device="cpu", progress=False)
    q = interp.render_quilt("0.2,0.9,0.7,0.1", focus=-0.3, effect=1.5, method="TEN",
                            progress=False)
    res = interp.interpolate("0.2,0.9,0.7,0.1", focus=-0.3, effect=1.5, method="TEN",
                             progress=False)
    np.testing.assert_array_equal(q.quilt, _montage(res.views, 5, 9))
    assert q.fused and q.config.effect == 1.5


#: The benchmark's Looking Glass configuration (``lfibench/configs/
#: quilt5x9_1080p.json``) at the tests' size: an 8x8 grid, 45 views, TEN.
QUILT_CONFIG = {"cols": 8, "rows": 8, "height": 24, "width": 40, "views": 45, "method": "TEN",
                "effect": 3.0, "aspect": 1.0, "rehearsal": True}


@pytest.mark.parametrize("trajectory, focus", [("0,0.25,1,0.25", 0.3), ("0,0.9,1,0.9", 0.05)])
def test_a_looking_glass_quilt_holds_to_the_benchmark_reference_tile_by_tile(trajectory, focus):
    """The fused route on the plain path: every tile of a 5x9 quilt of an
    8x8 grid's 45 views (horizontal sweeps, the benchmark's quilt traffic)
    within the near-tie rule of the plain reference's exact sums for its
    view, tile i at (i // 5, i % 5); two tiles swapped, or one byte moved
    by 2, break the rule."""
    from lfibench.reference import render as bench_reference
    from lfibench.scene import OcclusionScene, plane_foci

    h, w = QUILT_CONFIG["height"], QUILT_CONFIG["width"]
    images = OcclusionScene(8, 8, h, w, plane_foci(0.1, 0.3, 32), [4, 3], 21, "cpu").frame()
    interp = Interpolator(LightField(images.numpy(), 8, 8), config=RenderConfig(view_count=45),
                          device="cpu", progress=False)
    res = interp.render_quilt(trajectory, focus=focus, method="TEN", cols=5, rows=9,
                              progress=False)
    assert res.fused and res.quilt.shape == (9 * h, 5 * w, 3)
    ref = bench_reference.render(QUILT_CONFIG, images.permute(0, 3, 1, 2).contiguous(),
                                 trajectory, focus, 0.0)

    def breaks(canvas, i):
        r, c = divmod(i, 5)
        tile = torch.from_numpy(np.ascontiguousarray(canvas[r * h:(r + 1) * h,
                                                            c * w:(c + 1) * w]))
        one = {"stack": ref["stack"], "weights": ref["weights"][i:i + 1]}
        return bench_reference.compare(one, tile[None], None)["view_bytes_off_rule"]

    assert [breaks(res.quilt, i) for i in range(45)] == [0] * 45
    swapped = res.quilt.copy()
    swapped[:h, w:2 * w], swapped[h:2 * h, :w] = res.quilt[h:2 * h, :w], res.quilt[:h, w:2 * w]
    assert breaks(swapped, 1) > 0 and breaks(swapped, 5) > 0
    off = res.quilt.copy()
    off[5 * h + 3, 2 * w + 7, 1] ^= 2  # view 27
    assert [i for i in range(45) if breaks(off, i)] == [27]
