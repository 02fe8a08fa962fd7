"""Interpolator.interpolate_batch of the port against the JAX package's,
as tests/test_api_cli.py:199-290 tests the JAX one.

Tolerances: each result is bit-equal to the port's solo render of its
trajectory (and so to the NumPy oracle); maps exactly equal to JAX's;
fixed-focus views within 1 LSB of JAX's batch (its TEN route runs its
Pallas kernels in interpret mode), all-focus views equal to its XLA route.
"""

import numpy as np
import pytest
import torch

from lfinterpolator_tpu.api import Interpolator as JaxInterpolator
from lfinterpolator_tpu.core.config import RenderConfig as JaxRenderConfig
from lfinterpolator_tpu.io.loader import LightField as JaxLightField
from lfinterpolator_tpu_torch.api import Interpolator, _group_by_center
from lfinterpolator_tpu_torch.core.config import RenderConfig
from lfinterpolator_tpu_torch.io import LightField

torch.set_num_threads(1)

SAME_CENTER = ["0.0,0.0,1.0,1.0", "0.2,0.2,0.8,0.8", "0.5,0.5,0.5,0.5"]
# centers (0.5,0.5), (0.25,0.25), (0.5,0.5): two groups, caller's order kept
MIXED = ["0.0,0.0,1.0,1.0", "0.0,0.0,0.5,0.5", "0.2,0.2,0.8,0.8"]
KW = dict(view_count=4, focus_map_views=8, focus_steps=8)


def _both(small_lf, method):
    images, (cols, rows) = small_lf
    port = Interpolator(LightField(images, cols, rows), device="cpu", progress=False,
                        config=RenderConfig(method=method, **KW))
    jax = JaxInterpolator(JaxLightField(images, cols, rows), progress=False,
                          config=JaxRenderConfig(method=method, **KW))
    return port, jax


def _check(port, jax, trajs, tol, **kw):
    got = port.interpolate_batch(trajs, progress=False, **kw)
    want = jax.interpolate_batch(trajs, progress=False, **kw)
    assert len(got) == len(want) == len(trajs)
    for t, g, w in zip(trajs, got, want):
        solo = port.interpolate(t, progress=False, **kw)
        np.testing.assert_array_equal(g.views, solo.views, err_msg=t)
        assert np.abs(g.views.astype(int) - w.views.astype(int)).max() <= tol, t
        if kw.get("focus_range"):
            np.testing.assert_array_equal(g.maps, solo.maps, err_msg=t)
            np.testing.assert_array_equal(g.maps, w.maps, err_msg=t)
        else:
            assert g.maps is None
    return got


@pytest.mark.parametrize("trajs", [SAME_CENTER, MIXED], ids=["same_center", "mixed"])
@pytest.mark.parametrize("method", ["TEN", "STD"])
def test_fixed_batch_matches_jax_and_solo(small_lf, monkeypatch, method, trajs):
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")
    _check(*_both(small_lf, method), trajs, 1, focus=0.3)


@pytest.mark.parametrize("method", ["TEN", "STD"])
def test_allfocus_batch_shares_maps_per_group(small_lf, monkeypatch, method):
    """One estimate per center group; the group's results carry its maps."""
    port, jax = _both(small_lf, method)
    calls = []
    real = port._allfocus_step
    monkeypatch.setattr(port, "_allfocus_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = port.interpolate_batch(MIXED, focus=0.1, focus_range=0.2, progress=False)
    assert len(calls) == 2  # two center groups, one estimate each
    assert got[0].maps is got[2].maps
    assert not np.array_equal(got[0].maps, got[1].maps)
    _check(port, jax, MIXED, 0, focus=0.1, focus_range=0.2)


def test_center_tolerance_merges_jittered_centers(small_lf):
    """The jittered pair shares the first member's maps; the far center
    stays its own group; tolerance 0 keeps every center apart."""
    port, jax = _both(small_lf, "STD")
    trajs = ["0.0,0.0,1.0,1.0", "0.0,0.0,1.002,1.002", "0.5,0.5,1.0,1.0"]
    kw = dict(focus=0.1, focus_range=0.2)
    exact = port.interpolate_batch(trajs, progress=False, **kw)
    assert len({r.maps.tobytes() for r in exact}) == 3
    merged = port.interpolate_batch(trajs, center_tolerance=0.01, progress=False, **kw)
    want = jax.interpolate_batch(trajs, center_tolerance=0.01, progress=False, **kw)
    for g, w in zip(merged, want):
        np.testing.assert_array_equal(g.maps, w.maps)
        np.testing.assert_array_equal(g.views, w.views)
    np.testing.assert_array_equal(merged[0].maps, merged[1].maps)
    np.testing.assert_array_equal(merged[0].views, exact[0].views)
    assert merged[2].maps.tobytes() == exact[2].maps.tobytes()
    assert merged[1].maps.tobytes() != exact[1].maps.tobytes()
    one = port.interpolate_batch(trajs, center_tolerance=10.0, progress=False, **kw)
    assert len({r.maps.tobytes() for r in one}) == 1


def test_group_by_center():
    c = np.array([[1, 1], [1.5, 1.5], [1, 1], [1.004, 1.0], [1.5, 1.5]], np.float32)
    assert _group_by_center(c, 0.0) == [[0, 2], [1, 4], [3]]
    assert _group_by_center(c, 0.01) == [[0, 2, 3], [1, 4]]
    assert _group_by_center(c[:0], 0.0) == []


@pytest.mark.parametrize("kw", [{}, dict(focus=0.1, focus_range=0.2)],
                         ids=["fixed", "allfocus"])
def test_empty_batch(small_lf, kw):
    """No trajectories, no results: the port returns [] by intent (its
    docstring says so) and touches no device. The JAX package raises from
    np.stack instead; that is the reference's accident, recorded here, not a
    behaviour the port copies."""
    port, jax = _both(small_lf, "TEN")
    assert port.interpolate_batch([], progress=False, **kw) == []
    with pytest.raises(ValueError, match="need at least one array"):
        jax.interpolate_batch([], progress=False, **kw)
