"""The port's focus estimate and filter (ops/focus_torch.py, the plain
version that ops/focus_estimate.py takes on CPU tensors) and its host
tables (state.focus_tables) against the JAX package and the NumPy oracle.

Tolerance: bit-exact throughout. Maps are bytes chosen by an integer
argmin, so there is no rounding class to allow for:
  * exact taps against reference.focus_map_estimate, against
    focus.estimate_focus_map(pad=shift_pad_bound(...)) and against the
    fused Pallas kernel estimate_pallas.estimate_fused (interpret mode);
  * fast taps against focus.estimate_focus_map(exact_taps=False) and
    estimate_pallas.estimate_fast_fused (interpret mode);
  * the filter against reference.focus_map_filter and focus.filter_focus_map;
  * the tables against the oracle's expressions, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.ops import blend_xla, reference
from lfinterpolator_tpu.ops import estimate_pallas as ep
from lfinterpolator_tpu.ops import focus as focus_ops
from lfinterpolator_tpu_torch.ops import focus_estimate, focus_torch
from lfinterpolator_tpu_torch.state import FocusTables, focus_tables

torch.set_num_threads(1)

# (cols, rows, H, W, K, steps, focus, range, radius, aspect)
CASES = {
    "odd": (4, 4, 37, 53, 5, 6, 0.1, 0.4, (4, 2), 1.3),
    "neg_focus": (4, 4, 40, 64, 8, 8, -0.3, 0.5, (4, 2), 1.0),
    # shifts up to ~3.5x the offsets: taps far past every border
    "border": (4, 4, 24, 40, 6, 5, 1.5, 2.0, (6, 3), 1.0),
    "k1": (3, 5, 21, 33, 1, 4, 0.2, 0.3, (2, 2), 1.0),
    "steps2": (4, 4, 30, 44, 4, 2, -0.1, 0.6, (3, 1), 1.0),
    # shifts cross zero inside the image: the two tap rules part ways
    "sign_change": (4, 4, 48, 64, 8, 8, -0.4, 0.6, (4, 2), 1.0),
}


def _case(name, seed=0):
    cols, rows, h, w, k, steps, focus, frange, radius, aspect = CASES[name]
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)
    se = geometry.parse_trajectory("0,0,1,1", (cols, rows))
    offsets = geometry.compute_offsets(
        cols, rows, w, h, aspect, geometry.trajectory_center(se)
    )
    ids = geometry.select_focus_views(se, cols, rows, k)
    return images, offsets, ids, steps, focus, frange, radius


def _port(images, offsets, ids, steps, focus, frange, radius, exact):
    selected = np.ascontiguousarray(images[ids][..., :3].transpose(0, 3, 1, 2))
    tables = FocusTables(*(torch.from_numpy(t) for t in focus_tables(focus, frange, steps)))
    return focus_torch.estimate_focus_map(
        torch.from_numpy(selected), torch.from_numpy(offsets[ids]), tables,
        radius, exact,
    ).numpy()


def _jax_xla(images, offsets, ids, steps, focus, frange, radius, exact):
    h, w = images.shape[1:3]
    selected = jnp.asarray(images[ids][..., :3].transpose(0, 3, 1, 2))
    return np.asarray(focus_ops.estimate_focus_map(
        selected, jnp.asarray(offsets[ids]), jnp.float32(focus),
        jnp.float32(frange), radius, steps=steps,
        pad=focus_ops.shift_pad_bound(offsets, focus, frange, radius, h, w),
        exact_taps=exact,
    ))


@pytest.mark.parametrize("name", sorted(CASES))
def test_exact_estimate_matches_oracle(name):
    images, offsets, ids, steps, focus, frange, radius = _case(name)
    got = _port(images, offsets, ids, steps, focus, frange, radius, True)
    want = reference.focus_map_estimate(
        images, offsets, ids, focus, frange, radius, steps=steps
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_estimate_matches_jax_sweep(name, exact):
    args = _case(name)
    np.testing.assert_array_equal(
        _port(*args, exact), _jax_xla(*args, exact)
    )


def test_tap_rules_differ_where_coordinates_change_sign():
    args = _case("sign_change")
    exact, fast = _port(*args, True), _port(*args, False)
    assert (exact != fast).any()
    np.testing.assert_array_equal(fast, _jax_xla(*args, False))


# (H, W, K, steps, focus, range, radius): geometries the fused kernels take
PALLAS_CASES = [
    (16, 256, 2, 4, 0.1, 0.4, (4, 2)),
    (40, 256, 4, 8, -0.3, 0.5, (4, 2)),
]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("case", PALLAS_CASES, ids=["base", "neg_focus"])
def test_estimate_matches_pallas_kernels(case, exact, monkeypatch):
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")
    h, w, k, steps, focus, frange, radius = case
    rng = np.random.default_rng(7)
    se = np.array([0, 0, 3.0, 3.0], np.float32)
    offsets = geometry.compute_offsets(4, 4, w, h, 1.3, geometry.trajectory_center(se))
    ids = geometry.select_focus_views(se, 4, 4, k)
    images = rng.integers(0, 256, (16, h, w, 4), dtype=np.uint8)
    pad = focus_ops.shift_pad_bound(offsets, focus, frange, radius, h, w)
    spans = ep.chunk_spans(offsets, focus, frange, steps, 4)
    assert (ep.supports if exact else ep.supports_fast)(
        h, w, k, steps, radius, spans[0], spans[1]
    )
    fn = ep.estimate_fused if exact else ep.estimate_fast_fused
    want = np.asarray(fn(
        jnp.asarray(images[ids][..., :3].transpose(0, 3, 1, 2)),
        jnp.asarray(offsets[ids]), jnp.float32(focus), jnp.float32(frange),
        h_out=h, w=w, radius=radius, steps=steps, px=pad[0], py=pad[1],
        span_y=spans[0], span_x=spans[1],
    ))[:h, :w]
    got = _port(images, offsets, ids, steps, focus, frange, radius, exact)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_wrapper_takes_the_plain_version_on_cpu(exact):
    images, offsets, ids, steps, focus, frange, radius = _case("odd")
    selected = torch.from_numpy(
        np.ascontiguousarray(images[ids][..., :3].transpose(0, 3, 1, 2))
    )
    tables = FocusTables(*(torch.from_numpy(t) for t in focus_tables(focus, frange, steps)))
    before = dict(focus_estimate.launches)
    got = focus_estimate.focus_estimate(
        selected, torch.from_numpy(offsets[ids]), tables, radius, exact
    )
    assert focus_estimate.launches == before  # no kernel ran
    np.testing.assert_array_equal(
        got.numpy(), _port(images, offsets, ids, steps, focus, frange, radius, exact)
    )
    with pytest.raises(ValueError, match=r"\[K, C, H, W\] uint8"):
        focus_estimate.focus_estimate(selected.float(), torch.from_numpy(offsets[ids]),
                                      tables, radius, exact)
    with pytest.raises(ValueError, match="sel_offsets"):
        focus_estimate.focus_estimate(selected, torch.from_numpy(offsets), tables,
                                      radius, exact)


def test_rgbx_layout():
    rng = np.random.default_rng(2)
    sel = rng.integers(0, 256, (3, 3, 5, 7), dtype=np.uint8)
    words = focus_estimate.rgbx(torch.from_numpy(sel))
    assert words.dtype == torch.int32 and tuple(words.shape) == (3, 5, 7)
    raw = words.numpy().view(np.uint8).reshape(3, 5, 7, 4)
    np.testing.assert_array_equal(raw[..., :3], sel.transpose(0, 2, 3, 1))
    assert (raw[..., 3] == 0).all()


@pytest.mark.parametrize("radius", [(0, 0), (2, 1), (1, 3), (3, 2)])
@pytest.mark.parametrize("shape", [(37, 53), (5, 4), (48, 64)])
def test_filter_matches_oracle_and_jax(shape, radius):
    rng = np.random.default_rng(sum(shape) + sum(radius))
    fmap = rng.integers(0, 256, shape, dtype=np.uint8)
    got = focus_torch.filter_focus_map(torch.from_numpy(fmap), radius).numpy()
    np.testing.assert_array_equal(got, reference.focus_map_filter(fmap, radius))
    np.testing.assert_array_equal(
        got, np.asarray(focus_ops.filter_focus_map(jnp.asarray(fmap), radius))
    )


def test_filter_of_radius_zero_is_a_copy():
    fmap = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    out = focus_torch.filter_focus_map(fmap, (0, 3))
    assert torch.equal(out, fmap) and out.data_ptr() != fmap.data_ptr()


def _pairs(n, seed):
    """Focus values of both signs; ranges from near 0 to well above 1."""
    rng = np.random.default_rng(seed)
    focus = rng.uniform(-4.0, 4.0, n).astype(np.float32)
    frange = (10.0 ** rng.uniform(-7.0, 1.5, n)).astype(np.float32)
    focus[:8] = [0.0, -0.0, 0.1, -0.35, 5.0, -1e-6, 1e-6, 0.2]
    frange[:8] = [0.3, 1.0, 0.3, 2.0, 1e-7, 1e-3, 3.7, 255.0]
    return focus, frange


@pytest.mark.parametrize("steps", [2, 32, 33])
def test_host_tables_match_the_oracle_expressions(steps):
    focus, frange = _pairs(10_000, steps)
    # JAX's own encode of the estimator's levels (div_exact/no_fma), vmapped
    levels = np.asarray(jax.jit(jax.vmap(
        lambda f, r: blend_xla.quantized_levels(f, r, steps)[0]
    ))(jnp.asarray(focus), jnp.asarray(frange)))
    checked = 0
    for i, (f, r) in enumerate(zip(focus.tolist(), frange.tolist())):
        t = focus_tables(f, r, steps)
        assert t.candidates.dtype == np.float32 and t.decode.dtype == np.float32
        assert t.candidate_bytes.dtype == np.uint8
        np.testing.assert_array_equal(
            t.decode, reference.focus_values_from_map(np.arange(256), f, r)
        )
        cands = geometry.focus_candidates(f, r, steps)
        np.testing.assert_array_equal(t.candidates, cands)
        # reference.py:218-219, for a best focus equal to each candidate
        encode = geometry.round_half_away(
            (cands - np.float32(f)) / np.float32(r) * np.float32(255)
        )
        np.testing.assert_array_equal(t.candidate_bytes, encode.astype(np.uint8))
        if encode.max() <= 255:  # a range below the focus's f32 spacing
            # overflows the byte, where the two casts part ways
            np.testing.assert_array_equal(t.candidate_bytes, levels[i])
            checked += 1
    assert checked > 5_000
