"""The port's coarse-to-fine focus estimate (``--focus-pyramid``) on the
CPU, against the JAX package.

Tolerances: the host geometry and the presence words equal the JAX
functions exactly; maps are bit-exact against
``estimate_pallas.estimate_fused_pyramid`` in interpret mode and against
the masked XLA sweep ``focus.estimate_focus_map(present=...)``; views
within 1 LSB of the JAX pipeline (its blend's class,
``blend_pallas.py:261-270``) and bit-equal to ``reference.blend_allfocus``
on the port's map.
"""

import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.core.config import RenderConfig
from lfinterpolator_tpu.io import codec
from lfinterpolator_tpu.models import pipeline as jax_pipeline
from lfinterpolator_tpu.ops import estimate_pallas as ep
from lfinterpolator_tpu.ops import focus as focus_ops
from lfinterpolator_tpu.ops import reference
from lfinterpolator_tpu_torch import cli
from lfinterpolator_tpu_torch import io as port_io
from lfinterpolator_tpu_torch.api import Interpolator
from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.models import pipeline
from lfinterpolator_tpu_torch.ops import estimate_geometry as eg
from lfinterpolator_tpu_torch.ops import focus_estimate, focus_torch
from lfinterpolator_tpu_torch.ops.estimate_geometry import FocusTables
from lfinterpolator_tpu_torch.state import allfocus_params, focus_tables

torch.set_num_threads(1)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")


# (H, W, K, steps, radius, focus, range): widths below 256, between 256 and
# 512 (no coarse pass), and above; K = 8 and 32; ragged heights
GEOMETRIES = [
    (96, 512, 8, 8, (4, 2), 0.0, 0.21),
    (48, 200, 8, 8, (2, 2), 0.1, 0.3),
    (40, 384, 8, 8, (6, 2), 0.1, 0.3),
    (270, 480, 32, 32, (4, 2), 0.1, 0.3),
    (540, 960, 32, 32, (10, 6), 0.1, 0.3),
    (1080, 1920, 32, 32, (20, 10), 0.1, 0.3),
    (1080, 1920, 8, 16, (20, 10), -0.5, 2.0),
    (2160, 3840, 32, 32, (40, 20), 0.1, 0.3),
    (37, 530, 32, 6, (3, 1), 0.3, 0.1),
    (300, 1000, 8, 2, (5, 3), 0.0, 1.0),
]


def _offsets(h, w, cols=8, rows=8, aspect=1.0):
    se = geometry.parse_trajectory("0,0,1,1", (cols, rows))
    return geometry.compute_offsets(cols, rows, w, h, aspect,
                                    geometry.trajectory_center(se))


@pytest.mark.parametrize("case", GEOMETRIES, ids=lambda c: f"{c[0]}x{c[1]}_k{c[2]}_s{c[3]}")
def test_geometry_copies_equal_the_jax_functions(case):
    h, w, k, steps, radius, focus, frange = case
    offsets = _offsets(h, w)
    pad = eg.shift_pad_bound(offsets, focus, frange, radius, h, w)
    assert pad == focus_ops.shift_pad_bound(offsets, focus, frange, radius, h, w)
    for sc in (1, 2, 4):
        assert eg.chunk_spans(offsets, focus, frange, steps, sc) == ep.chunk_spans(
            offsets, focus, frange, steps, sc)
    spans = eg.chunk_spans(offsets, focus, frange, steps, 4)
    pxe, pye = max(pad[0], radius[0] + 1), max(pad[1], radius[1] + 1)
    for w128 in (256, 384, 512, 1920, 3840, eg.align(w, 128)):
        assert eg._wchunks(w128) == ep._wchunks(w128)
    assert eg.cfg_for(h, w, k, steps, radius, *spans) == ep._cfg_for(
        h, w, k, steps, radius, *spans, exact_taps=True)
    assert eg.coarse_params(radius, pxe, pye, *spans, 2) == ep._coarse_params(
        radius, pxe, pye, *spans, 2)
    want = ep.supports_pyramid(h, w, k, steps, radius, *spans, pxe, pye)
    assert eg.supports_pyramid(h, w, k, steps, radius, *spans, pxe, pye) == want
    plan = eg.pyramid_plan(h, w, k, steps, radius, spans, (pxe, pye))
    assert (plan is not None) == want
    if plan is not None:
        tb, _, _, _, sc, wco = ep._cfg_for(h, w, k, steps, radius, *spans)
        assert (plan.tb, plan.wco, plan.sc) == (tb, wco, sc)
        assert plan.nb * plan.tb >= h and plan.n_wc * plan.wco >= w
        assert plan.tb % 8 == 0 and plan.wco % 32 == 0  # the kernel's blocks


def test_cfg_candidates_equal_in_order():
    """The whole preference order, not only its first fit."""
    for h8, w128, steps, ry, rx, sy, sx in itertools.product(
            (48, 96, 1080), (256, 640, 1920), (8, 32), (2, 10), (4, 20),
            (16, 32), (16, 40)):
        assert list(eg._cfg_candidates(h8, w128, steps, ry, rx, sy, sx, 40)) == list(
            ep._cfg_candidates(h8, w128, steps, ry, rx, sy, sx, 40,
                               tile_tb_first=True))


def _structured(rng, h, w, k, sel_off, frange, steps):
    """Three depth bands whose per-view shifts sit on the candidate grid
    (``tests/test_estimate_pallas.py::_structured_selected``), so the coarse
    map is coherent and the presence words prune."""
    m = 64
    tex = rng.integers(0, 256, (3, h + 2 * m, w + 2 * m), dtype=np.uint8)
    t = tex.astype(np.float32)
    tex = ((t + np.roll(t, 1, 1) + np.roll(t, 2, 2)) / 2).astype(np.uint8)
    step = frange / (steps - 1)
    planes = (0.0, step * (steps // 2), step * (steps - 1))
    band = h // 3
    out = np.empty((k, 3, h, w), np.uint8)
    for v in range(k):
        y0 = 0
        for f, hb in zip(planes, (band, band, h - 2 * band)):
            dx = int(round(-f * sel_off[v, 0])) + m
            dy = int(round(-f * sel_off[v, 1])) + m
            out[v, :, y0:y0 + hb] = tex[:, dy + y0:dy + y0 + hb, dx:dx + w]
            y0 += hb
    return out


@pytest.fixture(scope="module")
def setup():
    """The JAX tests' pyramid setup (``test_estimate_pallas.py:166-181``):
    96x512, K = 8, 8 candidates, radius (4, 2), aspect 1.3."""
    h, w, k, steps, focus, frange, radius = 96, 512, 8, 8, 0.0, 0.21, (4, 2)
    se = np.array([0, 0, 3.0, 3.0], np.float32)
    offsets = geometry.compute_offsets(4, 4, w, h, 1.3, geometry.trajectory_center(se))
    ids = np.asarray(geometry.select_focus_views(se, 4, 4, k))
    sel_off = np.asarray(offsets)[ids]
    sel = _structured(np.random.default_rng(1234), h, w, k, sel_off, frange, steps)
    pad = eg.shift_pad_bound(offsets, focus, frange, radius, h, w)
    pad = (max(pad[0], radius[0] + 1), max(pad[1], radius[1] + 1))
    spans = eg.chunk_spans(offsets, focus, frange, steps, 4)
    plan = eg.pyramid_plan(h, w, k, steps, radius, spans, pad)
    tables = FocusTables(*(torch.from_numpy(a) for a in focus_tables(focus, frange, steps)))
    return dict(sel=sel, sel_off=sel_off, focus=focus, frange=frange, steps=steps,
                radius=radius, pad=pad, spans=spans, plan=plan, tables=tables,
                h=h, w=w)


def _jax_pyramid(s, refine=1):
    return np.asarray(ep.estimate_fused_pyramid(
        jnp.asarray(s["sel"]), jnp.asarray(s["sel_off"]), jnp.float32(s["focus"]),
        jnp.float32(s["frange"]), h_out=s["h"], w=s["w"], radius=s["radius"],
        steps=s["steps"], px=s["pad"][0], py=s["pad"][1], span_y=s["spans"][0],
        span_x=s["spans"][1], scale=2, refine=refine))[:s["h"], :s["w"]]


def _port_args(s):
    return (torch.from_numpy(s["sel"]), torch.from_numpy(s["sel_off"]), s["tables"],
            s["radius"])


def test_presence_equals_jax(setup):
    s, plan = setup, setup["plan"]
    rng = np.random.default_rng(5)
    hc, wc = -(-s["h"] // 2), -(-s["w"] // 2)
    bytes_ = focus_tables(s["focus"], s["frange"], s["steps"]).candidate_bytes
    coarse_maps = [
        bytes_[rng.integers(0, s["steps"], (hc, wc))],  # any candidate anywhere
        np.repeat(bytes_[rng.integers(0, s["steps"], (hc // 8 + 1, 1))], 8, 0)[:hc]
        .repeat(wc, 1),  # banded: prunes
        rng.integers(0, 256, (hc, wc), dtype=np.uint8),  # every byte
    ]
    for refine in (0, 1, 3):
        p = plan._replace(refine=refine)
        for coarse in coarse_maps:
            want = np.asarray(ep._presence_from_coarse(
                jnp.asarray(coarse), steps=s["steps"], sc=p.sc, nb=p.nb, tb=p.tb,
                n_wc=p.n_wc, wco=p.wco, scale=2, refine=refine))
            got = focus_torch.presence_from_coarse(torch.from_numpy(coarse), p, s["steps"])
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_pyramid_equals_jax_in_interpret_mode(setup, interpret):
    s = setup
    got = focus_torch.estimate_pyramid(*_port_args(s), s["plan"])
    np.testing.assert_array_equal(got.numpy(), _jax_pyramid(s))
    # the wrapper's CPU path is the plain version
    assert torch.equal(focus_estimate.focus_estimate_pyramid(*_port_args(s), s["plan"]),
                       got)
    # the table prunes here: not every (block, candidate) pair is searched
    coarse = focus_torch.estimate_focus_map(
        torch.from_numpy(s["sel"][:, :, ::2, ::2]), torch.from_numpy(s["sel_off"]) / 2,
        s["tables"], s["plan"].radius_c)
    pres = focus_torch.presence_from_coarse(coarse, s["plan"], s["steps"])
    present = focus_torch.expand_presence(pres, s["plan"], s["steps"], s["h"], s["w"])
    assert 0 < present.float().mean() < 1


def test_presence_estimate_equals_the_masked_xla_oracle(setup):
    s = setup
    rng = np.random.default_rng(11)
    plan = s["plan"]
    pres = torch.from_numpy(rng.integers(
        0, 2**plan.sc, (plan.nb, plan.n_wc, s["steps"] // plan.sc), dtype=np.int32))
    got = focus_estimate.focus_estimate(*_port_args(s), True, pres, plan)
    present = focus_torch.expand_presence(pres, plan, s["steps"], s["h"], s["w"])
    want = focus_ops.estimate_focus_map(
        jnp.asarray(s["sel"]), jnp.asarray(s["sel_off"]), jnp.float32(s["focus"]),
        jnp.float32(s["frange"]), s["radius"], steps=s["steps"], pad=s["pad"],
        present=jnp.asarray(present.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.equal(got, focus_torch.estimate_focus_map(*_port_args(s)))


def test_refine_of_all_steps_equals_the_exact_estimate(setup):
    s = setup
    got = focus_torch.estimate_pyramid(*_port_args(s), s["plan"]._replace(refine=s["steps"]))
    assert torch.equal(got, focus_torch.estimate_focus_map(*_port_args(s)))


def test_unsupported_width_takes_the_exact_sweep(small_lf):
    images, (cols, rows) = small_lf  # 48x64: no pyramid config
    cfg = RenderConfig(focus_map_views=4, focus_steps=8, focus_pyramid=True)
    run_cfg = RenderConfig(focus=0.1, focus_range=0.3, focus_map_views=4,
                           focus_steps=8, focus_pyramid=True)
    assert allfocus_params("0,0,1,1", cols=cols, rows=rows, height=48, width=64,
                           config=run_cfg).pyramid is None
    lf = LightField(images, cols, rows)
    got = Interpolator(lf, config=cfg, device="cpu", progress=False).interpolate(
        "0,0,1,1", focus=0.1, focus_range=0.3, method="TEN", progress=False)
    exact = Interpolator(lf, config=RenderConfig(focus_map_views=4, focus_steps=8),
                         device="cpu", progress=False).interpolate(
        "0,0,1,1", focus=0.1, focus_range=0.3, method="TEN", progress=False)
    np.testing.assert_array_equal(got.maps, exact.maps)
    # --fast-focus with the flag: the fast sweep, no pyramid
    fast = RenderConfig(focus=0.1, focus_range=0.3, focus_map_views=8,
                        focus_steps=8, focus_pyramid=True, exact_focus_taps=False)
    assert allfocus_params("0,0,1,1", cols=4, rows=4, height=96, width=512,
                           config=fast).pyramid is None


def test_pipeline_pyramid_matches_the_jax_pipeline(setup, interpret):
    """``test_estimate_pallas.py::test_pyramid_through_render_all_focus_jit``
    through both pipelines: maps bit-exact, views within 1 LSB of JAX and
    bit-equal to the oracle on the port's map."""
    s = setup
    k = s["sel"].shape[0]
    weights = np.full((4, k), 1.0 / k, np.float32)
    ids = np.arange(k, dtype=np.int32)
    views_j, maps_j = jax_pipeline.render_all_focus(
        jnp.asarray(s["sel"]), jnp.asarray(weights), jnp.asarray(s["sel_off"]),
        jnp.float32(s["focus"]), jnp.float32(s["frange"]), jnp.asarray(ids),
        method="STD", radius=s["radius"], filter_radius=(1, 1), steps=s["steps"],
        pad=s["pad"], spans=(int(s["spans"][0]), int(s["spans"][1])), pyramid=(2, 1))
    tables = FocusTables(*(torch.from_numpy(a) for a in focus_tables(
        s["focus"], s["frange"], s["steps"])))
    views, maps = pipeline.render_all_focus(
        torch.from_numpy(s["sel"]), torch.from_numpy(weights),
        torch.from_numpy(s["sel_off"]), torch.from_numpy(ids.astype(np.int64)), tables,
        method="STD", radius=s["radius"], filter_radius=(1, 1), pyramid=s["plan"])
    np.testing.assert_array_equal(maps.numpy(), np.asarray(maps_j))
    assert np.abs(views.numpy().astype(int) - np.asarray(views_j).astype(int)).max() <= 1
    rgba = np.concatenate([s["sel"].transpose(0, 2, 3, 1),
                           np.full((k, s["h"], s["w"], 1), 255, np.uint8)], axis=-1)
    np.testing.assert_array_equal(
        views.permute(0, 2, 3, 1).numpy(),
        reference.blend_allfocus(rgba, weights.astype(np.float16), s["sel_off"],
                                 maps[1].numpy(), s["focus"], s["frange"]))


def test_cli_focus_pyramid_writes_both_maps(tmp_path, capsys):
    """-r --focus-pyramid through the port's CLI on a 4x4 grid at 96x512, a
    geometry the pyramid takes: the files are the API's pyramid render."""
    cols = rows = 4
    h, w = 96, 512
    rng = np.random.default_rng(3)
    tex = rng.integers(0, 256, (h + 8, w + 8, 3), dtype=np.uint8)
    images = np.zeros((cols * rows, h, w, 4), np.uint8)
    images[..., 3] = 255
    scene = tmp_path / "scene"
    scene.mkdir()
    for c in range(cols):
        for r in range(rows):
            images[c * rows + r, ..., :3] = tex[r * 2:r * 2 + h, c * 2:c * 2 + w]
            codec.encode_png(str(scene / f"{c:02d}_{r:02d}.png"), images[c * rows + r])
    out = tmp_path / "out"
    argv = ["-i", str(scene), "-o", str(out), "-t", "0,0,1,1", "-m", "TEN", "-f", "0.1",
            "-r", "0.3", "--focus-views", "8", "--focus-pyramid", "--device", "cpu",
            "--json", "--no-progress"]
    assert cli.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["files_written"] == 66
    cfg = RenderConfig(focus_map_views=8, focus_pyramid=True)
    res = Interpolator(LightField(images, cols, rows), config=cfg, device="cpu",
                       progress=False).interpolate(
        "0,0,1,1", focus=0.1, focus_range=0.3, method="TEN", progress=False)
    for i in (0, 1):
        np.testing.assert_array_equal(
            port_io.decode(os.path.join(out, f"map{i}.png"))[..., 0], res.maps[i])
    np.testing.assert_array_equal(
        port_io.decode(os.path.join(out, "63.png"))[..., :3], res.views[63])
    assert allfocus_params("0,0,1,1", cols=cols, rows=rows, height=h, width=w,
                           config=RenderConfig(focus=0.1, focus_range=0.3,
                                               focus_map_views=8, focus_pyramid=True)
                           ).pyramid is not None
