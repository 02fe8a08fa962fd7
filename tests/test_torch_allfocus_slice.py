"""The port's all-in-focus render end to end on the CPU, against the JAX
package: Interpolator against Interpolator, CLI against CLI.

Tolerances: maps bit-exact against the JAX package (and, for the exact
rule, against reference.focus_map_estimate / focus_map_filter); views
bit-equal to reference.blend_allfocus on the port's maps and within 1 LSB
of the JAX package, the class of its blend contraction
(blend_pallas.py:261-270).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lfinterpolator_tpu import api as jax_api
from lfinterpolator_tpu import cli as jax_cli
from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.core.config import RenderConfig
from lfinterpolator_tpu.io import codec
from lfinterpolator_tpu.io.loader import LightField as JaxLightField
from lfinterpolator_tpu.ops import reference
from lfinterpolator_tpu_torch import cli
from lfinterpolator_tpu_torch import io as port_io
from lfinterpolator_tpu_torch.api import Interpolator
from lfinterpolator_tpu_torch.core import capacity
from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.state import allfocus_params

torch.set_num_threads(1)

# 4 focus views, 8 candidates; filter divisor 1 so that map1 != map0
CONFIG = RenderConfig(focus_map_views=4, focus_steps=8, filter_radius_divisor=1)


@pytest.fixture
def scene_dir(tmp_path, small_lf):
    images, (cols, rows) = small_lf
    d = tmp_path / "scene"
    d.mkdir()
    for c in range(cols):
        for r in range(rows):
            codec.encode_png(str(d / f"{c:02d}_{r:02d}.png"), images[c * rows + r])
    return str(d)


def _oracle_maps(images, cols, rows, cfg):
    p = allfocus_params("0,0,1,1", cols=cols, rows=rows, height=images.shape[1],
                        width=images.shape[2], config=cfg)
    map0 = reference.focus_map_estimate(
        images, p.offsets, p.focus_ids, cfg.focus, cfg.focus_range, p.radius,
        steps=cfg.focus_steps,
    )
    return p, map0, reference.focus_map_filter(map0, p.filter_radius)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("method", ["STD", "TEN"])
def test_interpolator_matches_jax_and_oracle(small_lf, method, exact):
    images, (cols, rows) = small_lf
    lf = LightField(images, cols, rows)
    cfg = dataclasses.replace(CONFIG, exact_focus_taps=exact)
    got = Interpolator(lf, config=cfg, device="cpu", progress=False).interpolate(
        "0,0,1,1", focus=0.1, focus_range=0.3, method=method, progress=False
    )
    want = jax_api.Interpolator(JaxLightField(images, cols, rows), config=cfg,
                                progress=False).interpolate(
        "0,0,1,1", focus=0.1, focus_range=0.3, method=method, progress=False
    )
    assert got.views.shape == want.views.shape == (64, 48, 64, 3)
    assert got.maps.shape == (2, 48, 64) and got.maps.dtype == np.uint8
    np.testing.assert_array_equal(got.maps, want.maps)
    assert (got.maps[0] != got.maps[1]).any()
    assert len(np.unique(got.maps[0])) > 1
    assert np.abs(got.views.astype(int) - want.views.astype(int)).max() <= 1
    run_cfg = dataclasses.replace(cfg, focus=0.1, focus_range=0.3)
    p, map0, map1 = _oracle_maps(images, cols, rows, run_cfg)
    if exact:
        np.testing.assert_array_equal(got.maps, np.stack([map0, map1]))
    fmap = got.maps[1] if method == "STD" else got.maps[0]
    np.testing.assert_array_equal(
        got.views,
        reference.blend_allfocus(images, p.weights.astype(np.float16), p.offsets,
                                 fmap, 0.1, 0.3),
    )


def test_allfocus_benchmark_runs(small_lf):
    images, (cols, rows) = small_lf
    interp = Interpolator(LightField(images, cols, rows),
                          config=dataclasses.replace(CONFIG, view_count=8),
                          device="cpu", progress=False)
    res = interp.interpolate("0,0,1,1", focus=0.1, focus_range=0.3,
                             method="TEN", benchmark_runs=2, progress=False)
    assert len(res.run_times_s) == 2 and res.avg_ms > 0
    assert res.views.shape == (8, 48, 64, 3) and res.maps.shape == (2, 48, 64)


@pytest.mark.parametrize(
    "cols, rows, h, w, focus, frange, cfg",
    [
        (4, 4, 48, 64, 0.1, 0.3, CONFIG),
        (3, 5, 45, 70, -0.35, 2.0, RenderConfig(focus_map_views=9, effect=1.5,
                                                aspect=0.5, view_count=7)),
        (4, 4, 48, 64, 0.0, 1e-4, RenderConfig(focus_map_views=16, focus_steps=3)),
    ],
    ids=["4x4", "3x5_aspect", "tiny_range"],
)
def test_allfocus_params_match_the_jax_construction(
    cols, rows, h, w, focus, frange, cfg, monkeypatch
):
    """What lfinterpolator_tpu/api.py:593-637 hands its render, caught at
    pipeline.render_all_focus, against state.allfocus_params."""
    seen = {}

    class Caught(Exception):
        pass

    def spy(images, weights, offsets, f, r, ids, **kwargs):
        seen.update(weights=np.asarray(weights), offsets=np.asarray(offsets),
                    focus=float(f), range=float(r), ids=np.asarray(ids), **kwargs)
        raise Caught

    monkeypatch.setattr(jax_api.pipeline, "render_all_focus", spy)
    lf = JaxLightField(np.zeros((cols * rows, h, w, 4), np.uint8), cols, rows)
    with pytest.raises(Caught):
        jax_api.Interpolator(lf, config=cfg, progress=False).interpolate(
            "0,0,1,1", focus=focus, focus_range=frange, progress=False
        )
    run_cfg = dataclasses.replace(cfg, focus=focus, focus_range=frange)
    p = allfocus_params("0,0,1,1", cols=cols, rows=rows, height=h, width=w,
                        config=run_cfg)
    assert p.weights.dtype == np.float32 and p.offsets.dtype == np.float32
    np.testing.assert_array_equal(p.weights, seen["weights"])
    np.testing.assert_array_equal(p.offsets, seen["offsets"])
    np.testing.assert_array_equal(p.focus_ids, seen["ids"])
    assert p.radius == seen["radius"] and p.filter_radius == seen["filter_radius"]
    assert len(p.tables.candidates) == seen["steps"] == cfg.focus_steps
    np.testing.assert_array_equal(
        p.tables.candidates,
        geometry.focus_candidates(seen["focus"], seen["range"], cfg.focus_steps),
    )


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_cli_matches_jax_cli(scene_dir, small_lf, tmp_path, capsys, fast):
    out_port, out_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    common = ["-i", scene_dir, "-t", "0.0,0.0,1.0,1.0", "-f", "0.1", "-r", "0.3",
              "-m", "TEN", "--focus-views", "4", "--json", "--no-progress"]
    common += ["--fast-focus"] if fast else []
    assert cli.main(common + ["-o", out_port, "--device", "cpu"]) == 0
    port_json = _json_line(capsys)
    assert jax_cli.main(common + ["-o", out_jax]) == 0
    jax_json = _json_line(capsys)
    assert port_json.keys() == jax_json.keys()
    assert port_json["files_written"] == jax_json["files_written"] == 66
    names = sorted(os.listdir(out_port))
    want_names = sorted([f"{i:02d}.png" for i in range(64)] + ["map0.png", "map1.png"])
    assert names == sorted(os.listdir(out_jax)) == want_names
    for name in names:
        a = port_io.decode(os.path.join(out_port, name))
        b = codec.decode(os.path.join(out_jax, name))
        if name.startswith("map"):
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert (a[..., 3] == 255).all()
    # the CLI passed its flags on: its files are the API's render
    images, (cols, rows) = small_lf
    res = Interpolator(
        LightField(images, cols, rows), device="cpu", progress=False,
        config=RenderConfig(focus_map_views=4, exact_focus_taps=not fast),
    ).interpolate("0,0,1,1", focus=0.1, focus_range=0.3, method="TEN",
                  progress=False)
    for i in (0, 63):
        np.testing.assert_array_equal(
            port_io.decode(os.path.join(out_port, f"{i:02d}.png"))[..., :3],
            res.views[i],
        )
    for i in (0, 1):
        np.testing.assert_array_equal(
            port_io.decode(os.path.join(out_port, f"map{i}.png"))[..., :3],
            np.repeat(res.maps[i][..., None], 3, axis=-1),
        )


def test_check_memory_counts_the_allfocus_peak(small_lf, monkeypatch):
    """The all-focus render's peak beyond the stack, now sized by the
    capacity plan (core/capacity.py): the K focus views gathered and as
    RGBx words, the maps and the filter's integral image while estimating;
    then the maps beside every view's output and its download copy. Both
    methods blend on the kernel, so STD adds no plain temporaries."""
    images, (cols, rows) = small_lf
    interp = Interpolator(LightField(images, cols, rows), device="cpu",
                          progress=False)
    monkeypatch.setattr(capacity, "_headroom", lambda budget: 0)
    v, k, c, h, w = 64, 8, 3, 48, 64
    need = max(k * (c + 4) * h * w + 48 * h * w, 2 * h * w + 2 * v * c * h * w)
    monkeypatch.setenv("LFI_HBM_BYTES", str(need))
    for method in ("TEN", "STD"):
        assert not interp._plan(v, method, k, 0, False).batched
    monkeypatch.setenv("LFI_HBM_BYTES", str(need - 1))
    for method in ("TEN", "STD"):
        assert interp._plan(v, method, k, 0, False).batched
    monkeypatch.setenv("LFI_HBM_BYTES", str(k * (c + 4) * h * w + 48 * h * w - 1))
    for method in ("TEN", "STD"):
        with pytest.raises(ValueError, match="too large for one device"):
            interp._plan(v, method, k, 0, False)
