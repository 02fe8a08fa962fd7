"""The port's StreamingRenderer against the JAX package's, mirroring
tests/test_streaming.py, and K2's counterpart: the clamp-shift that
``shift_pallas.shift_tiled_4d`` computes is ``blend_torch.shift_stack``,
the plain version of ``shift_blend``'s operand load.

Tolerances: the port's frames are bit-equal to the NumPy oracle and to
its own non-streaming pipeline; fixed-focus frames within 1 LSB of JAX's
stream (its TEN frames run ``shift_tiled_4d`` + ``blend_tiled`` in
interpret mode); maps and all-focus views equal to JAX's XLA route; the
shifted stack equal to ``shift_tiled_4d``'s byte for byte.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfinterpolator_tpu.core.config import RenderConfig as JaxRenderConfig
from lfinterpolator_tpu.ops import reference, shift_pallas
from lfinterpolator_tpu.streaming import StreamingRenderer as JaxStreamingRenderer
from lfinterpolator_tpu_torch import StreamingRenderer, state
from lfinterpolator_tpu_torch.core.config import RenderConfig
from lfinterpolator_tpu_torch.models import pipeline
from lfinterpolator_tpu_torch.ops import blend_torch
from lfinterpolator_tpu_torch.streaming import StreamStats

torch.set_num_threads(1)


def _frames(rng, n, g, h, w):
    return [rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8) for _ in range(n)]


def _pair(h, w, v=4, **cfg):
    """The port's and JAX's renderer of a 2x2 grid."""
    port = StreamingRenderer(2, 2, w, h, "0.0,0.0,1.0,1.0", device="cpu",
                             config=RenderConfig(view_count=v, **cfg))
    jax = JaxStreamingRenderer(2, 2, w, h, "0.0,0.0,1.0,1.0",
                               config=JaxRenderConfig(view_count=v, **cfg))
    return port, jax


@pytest.mark.parametrize("method, h, w", [("STD", 16, 32), ("TEN", 32, 256)],
                         ids=["std", "ten_k2"])
def test_stream_matches_jax_and_oracle(rng, monkeypatch, method, h, w):
    """TEN at 32x256 takes JAX's K2 route (shift_tiled_4d, interpret mode)."""
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")
    frames = _frames(rng, 3, 4, h, w)
    port, jax = _pair(h, w, focus=0.4, method=method)
    if method == "TEN":
        assert jax._use_pallas and jax._use_tiled
    got = list(port.render_stream(iter(frames)))
    want = list(jax.render_stream(iter(frames)))
    assert len(got) == len(want) == 3
    wm, fo = state.render_params("0.0,0.0,1.0,1.0", cols=2, rows=2, height=h,
                                 width=w, focus=0.4, views=4)
    for frame, g, j in zip(frames, got, want):
        assert g.shape == (4, h, w, 3) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, reference.blend_fixed(frame, wm, fo))
        assert np.abs(g.astype(int) - j.astype(int)).max() <= 1


@pytest.mark.parametrize("method", ["STD", "TEN"])
@pytest.mark.parametrize("refresh", [1, 2])
def test_stream_allfocus_matches_jax(rng, method, refresh):
    """Frames t's maps are the maps of frame (t // N) * N; the views blend
    frame t with them. Refresh frames equal the refresh-1 stream."""
    n, h, w = 4, 16, 32
    frames = _frames(rng, n, 4, h, w)
    cfg = dict(focus=0.1, focus_range=0.4, focus_map_views=4, focus_steps=8,
               method=method, focus_map_refresh=refresh)
    port, jax = _pair(h, w, **cfg)
    got = list(port.render_stream(iter(frames)))
    want = list(jax.render_stream(iter(frames)))
    assert len(got) == len(want) == n
    p = port._params
    weights, offsets, ids, tables = state.upload_allfocus(p, "cpu")
    for t, ((views, maps), (jv, jm)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(maps, jm)
        np.testing.assert_array_equal(views, jv)
        anchor = blend_torch.to_planar(torch.from_numpy(frames[t - t % refresh]))
        want_maps = pipeline.compute_focus_maps(
            anchor, offsets, ids, tables, radius=p.radius,
            filter_radius=p.filter_radius)
        np.testing.assert_array_equal(maps, want_maps.numpy())
        want_views = pipeline.blend_all_focus(
            blend_torch.to_planar(torch.from_numpy(frames[t])), weights, offsets,
            want_maps, tables.decode, method=method)
        np.testing.assert_array_equal(views, blend_torch.from_planar(want_views).numpy())
    if refresh == 2:
        assert np.array_equal(got[1][1], got[0][1])
        assert not np.array_equal(got[2][1], got[1][1])


def test_stream_empty_and_decode_errors(rng):
    port = StreamingRenderer(2, 2, 16, 8, "0,0,1,1", device="cpu",
                             config=RenderConfig(view_count=2))
    assert list(port.render_stream(iter([]))) == []

    def frames():
        yield rng.integers(0, 256, size=(4, 8, 16, 4), dtype=np.uint8)
        raise RuntimeError("corrupt frame 2")

    with pytest.raises(RuntimeError, match="corrupt frame 2"):
        list(port.render_stream(frames()))


def test_cuda_stream_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kwargs in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamingRenderer(2, 2, 16, 8, "0,0,1,1", **kwargs)
    with pytest.raises(ValueError, match="cpu or cuda"):
        StreamingRenderer(2, 2, 16, 8, "0,0,1,1", device="meta")


def test_render_to_dir_resume_and_stray_pngs(tmp_path, rng):
    frames = _frames(rng, 3, 4, 12, 16)
    port = StreamingRenderer(2, 2, 16, 12, "0,0,1,1", device="cpu",
                             config=RenderConfig(view_count=2))
    out = str(tmp_path / "stream")
    stray = tmp_path / "stream" / "frame_00001"
    stray.mkdir(parents=True)
    (stray / "quilt.png").write_bytes(b"junk")  # as many PNGs, wrong names
    (stray / "05.png").write_bytes(b"junk")
    stats = port.render_to_dir(iter(frames[:2]), out, resume=True)
    assert isinstance(stats, StreamStats)
    assert (stats.frames, stats.skipped, stats.rendered) == (2, 0, 2) and stats.fps > 0
    calls = []

    def thunk(f):
        return lambda: calls.append(1) or f

    stats = port.render_to_dir([thunk(f) for f in frames], out, resume=True)
    assert (stats.frames, stats.skipped) == (3, 2) and len(calls) == 1
    assert sorted(os.listdir(out)) == ["frame_00000", "frame_00001", "frame_00002"]
    got = list(port.render_stream(iter(frames)))
    from lfinterpolator_tpu_torch import io

    for i in range(3):
        for v in range(2):
            png = io.decode(os.path.join(out, f"frame_{i:05d}", f"{v:02d}.png"))
            np.testing.assert_array_equal(png[..., :3], got[i][v])
    assert not any(n.endswith(".tmp") for d, _, ns in os.walk(out) for n in ns)


def test_render_to_dir_allfocus_writes_maps(tmp_path, rng):
    frames = _frames(rng, 2, 4, 16, 32)
    port = StreamingRenderer(2, 2, 32, 16, "0,0,1,1", device="cpu", config=RenderConfig(
        view_count=2, focus_range=0.4, focus_map_views=4, focus_steps=4))
    out = str(tmp_path / "af")
    assert port.render_to_dir(iter(frames), out).frames == 2
    for i in range(2):
        assert sorted(os.listdir(os.path.join(out, f"frame_{i:05d}"))) == [
            "00.png", "01.png", "map0.png", "map1.png"]
    assert port.render_to_dir(iter(frames), out, resume=True).skipped == 2


@pytest.mark.parametrize("h, w", [(37, 200), (33, 300)], ids=["37x200", "33x300"])
def test_k2_shift_tiled_equals_the_operand_load(monkeypatch, h, w):
    """K2 (``shift_tiled_4d``, interpret mode, on the tile-padded stack,
    cropped to H x W) equals ``blend_torch.shift_stack``, what
    ``shift_blend``'s operand load reads, at geometries off the (8, 128)
    tiles and with shifts far past the image (clip bounds = image size)."""
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(h * w)
    images = rng.integers(0, 256, (5, 3, h, w), dtype=np.uint8)
    shifts = np.stack([rng.integers(-3 * w, 3 * w, 5), rng.integers(-3 * h, 3 * h, 5)],
                      axis=1).astype(np.int32)
    shifts[0] = (w + 7, -h - 9)  # past both bounds
    shifts[1] = (-5, 3)  # inside
    assert shift_pallas.supports(h, w) and (h % 8, w % 128) != (0, 0)
    want = shift_pallas.shift_tiled_4d(
        shift_pallas.pad_to_tiles(jnp.asarray(images)), jnp.asarray(shifts),
        h=h, w=w, px=w, py=h)
    got = blend_torch.shift_stack(torch.from_numpy(images), torch.from_numpy(shifts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :, :h, :w])
