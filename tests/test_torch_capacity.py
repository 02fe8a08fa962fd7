"""The port's capacity plan and view-batched arm (core/capacity.py, api.py),
mirroring tests/test_capacity.py where its arms exist in the port.

`LFI_HBM_BYTES` forces small budgets (bytes beyond the resident stack) so
the plan picks view batches on the small fixture. Tolerances: a batched
render is bit-equal to the unbatched one and to the NumPy oracle, maps
exactly equal to the JAX package's; views within 1 LSB of JAX's fixed-focus
routes (its Pallas kernels in interpret mode, its XLA einsum: both sum in
their own order) and equal to its all-focus XLA route.
"""

import numpy as np
import pytest
import torch

from lfinterpolator_tpu.api import Interpolator as JaxInterpolator
from lfinterpolator_tpu.core.config import RenderConfig as JaxRenderConfig
from lfinterpolator_tpu.io.loader import LightField as JaxLightField
from lfinterpolator_tpu_torch import state
from lfinterpolator_tpu_torch.api import Interpolator
from lfinterpolator_tpu_torch.core import capacity
from lfinterpolator_tpu_torch.core.config import RenderConfig
from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.models import pipeline
from lfinterpolator_tpu_torch.ops import focus_estimate
from lfinterpolator_tpu_torch.streaming import StreamingRenderer

torch.set_num_threads(1)

# the small_lf fixture (tests/conftest.py)
G, C, H, W = 16, 3, 48, 64


def _scan(v, method, focus_views=0):
    """(budget, plan) at falling budgets until even one view does not fit."""
    full = capacity.plan_render(G, C, H, W, v, method=method, focus_views=focus_views,
                                budget=1 << 40).bytes_unbatched
    out = []
    for b in range(2 * full, 0, -max(1, full // 400)):
        try:
            out.append((b, capacity.plan_render(G, C, H, W, v, method=method,
                                                focus_views=focus_views, budget=b)))
        except ValueError:
            return out
    pytest.fail("the scan never reached the infeasible regime")


def _first(plans, pred):
    return next((b, p) for b, p in plans if pred(p))


@pytest.mark.parametrize("method, k", [("TEN", 0), ("STD", 0), ("TEN", 8), ("STD", 8)],
                         ids=["fixed_ten", "fixed_std", "allfocus_ten", "allfocus_std"])
def test_plan_arms_are_ordered_by_budget(method, k):
    """Falling budgets move from one pass to view batches that never grow,
    and then to ValueError."""
    plans = _scan(64, method, k)
    batched = [p.batched for _, p in plans]
    assert batched == sorted(batched) and batched[0] is False and batched[-1] is True
    vbs = [p.view_batch for _, p in plans if p.batched]
    assert vbs == sorted(vbs, reverse=True) and min(vbs) >= 1 and max(vbs) < 64
    if not k:  # all in focus, the estimate phase ends the scan earlier
        assert min(vbs) == 1
    assert all(p.bytes_unbatched == plans[0][1].bytes_unbatched for _, p in plans)


def test_plan_arithmetic():
    n = C * H * W
    # TEN: each view's output and its download copy
    assert capacity.plan_render(G, C, H, W, 64, method="TEN",
                                budget=1 << 40).bytes_unbatched == 2 * 64 * n
    # STD adds the plain ops' temporaries
    assert capacity.plan_render(G, C, H, W, 64, method="STD", budget=1 << 40
                                ).bytes_unbatched == 2 * 64 * n + state_temp(64)
    # all in focus: the estimate phase can set the peak
    # ... with the estimate kernels' scratch: the maps of a chunk of
    # candidates and the running best
    est = 32 * (C + 4) * H * W + 48 * H * W + focus_estimate.SCRATCH_BYTES_PER_PIXEL * H * W
    assert focus_estimate.SCRATCH_BYTES_PER_PIXEL == 44
    assert capacity.estimate_bytes(32, C, H, W) == est and capacity.estimate_bytes(0, C, H, W) == 0
    # one chunk holds all 32 headline candidates, and never less than one
    assert focus_estimate.map_chunk(1080, 1920, (20, 10), 32) == 32
    assert focus_estimate.map_chunk(1080, 1920, (20, 10), 256) == 38
    assert focus_estimate.map_chunk(4, 4, (30, 30), 8) == 1
    assert capacity.plan_render(G, C, H, W, 1, method="TEN", focus_views=32,
                                budget=1 << 40).bytes_unbatched == est


def state_temp(v):
    from lfinterpolator_tpu_torch.ops import blend_torch

    return blend_torch.temp_bytes(G, v, C, H, W)


def test_device_hbm_bytes_env_and_cpu(monkeypatch):
    monkeypatch.setenv("LFI_HBM_BYTES", "12345678")
    assert capacity.device_hbm_bytes("cpu") == 12345678
    assert capacity.device_hbm_bytes("cuda") == 12345678  # the override wins
    monkeypatch.delenv("LFI_HBM_BYTES")
    assert capacity.device_hbm_bytes("cpu") == capacity.UNBOUNDED


def test_check_capacity_has_no_mesh_hint():
    capacity.check_capacity(100, "tiny", budget=1 << 30)
    with pytest.raises(ValueError, match="huge thing needs at least") as e:
        capacity.check_capacity(1 << 40, "huge thing", budget=1 << 30)
    assert "mesh" not in str(e.value)


@pytest.fixture
def lf(small_lf):
    images, (cols, rows) = small_lf
    return LightField(images, cols, rows)


@pytest.mark.parametrize("focus_range", [0.0, 0.2], ids=["fixed", "allfocus"])
def test_infeasible_render_raises_before_any_tensor(lf, monkeypatch, focus_range):
    interp = Interpolator(lf, device="cpu", progress=False,
                          config=RenderConfig(view_count=8, focus_map_views=8))

    def no_allocation(*args, **kwargs):
        raise AssertionError("a tensor was allocated before the plan raised")

    for name in ("upload_params", "upload_allfocus"):
        monkeypatch.setattr(state, name, no_allocation)
    monkeypatch.setattr(pipeline, "render_fixed_focus", no_allocation)
    monkeypatch.setenv("LFI_HBM_BYTES", "20000")
    for method in ("TEN", "STD"):
        with pytest.raises(ValueError, match="too large for one device") as e:
            interp.interpolate("0,0,3,3", focus=0.05, focus_range=focus_range,
                               method=method, progress=False)
        assert "mesh" not in str(e.value)


def _jax_render(small_lf, monkeypatch, budget, **kw):
    """JAX's interpolate under the same LFI_HBM_BYTES, where its own plan can
    fit that budget; else (its padded stack alone exceeds the budgets that
    batch the port) unforced. -> (result, whether it ran under the budget)."""
    images, (cols, rows) = small_lf
    cfg = JaxRenderConfig(view_count=kw.pop("views"), focus_map_views=8, focus_steps=8)
    jax_interp = JaxInterpolator(JaxLightField(images, cols, rows), config=cfg,
                                 progress=False)
    monkeypatch.setenv("LFI_HBM_BYTES", str(budget))
    try:
        return jax_interp.interpolate("0,0,3,3", progress=False, **kw), True
    except ValueError as e:
        assert "too large for one device" in str(e)
    finally:
        monkeypatch.delenv("LFI_HBM_BYTES")
    return jax_interp.interpolate("0,0,3,3", progress=False, **kw), False


@pytest.mark.parametrize(
    "method, focus_range, views",
    [("TEN", 0.0, 64), ("STD", 0.0, 64), ("TEN", 0.2, 64), ("STD", 0.2, 64)],
    ids=["fixed_ten", "fixed_std", "allfocus_ten", "allfocus_std"],
)
def test_view_batched_render_equals_unbatched_and_jax(lf, small_lf, monkeypatch,
                                                      method, focus_range, views):
    """A budget that forces view batches (a batch size that does not divide
    the view count) changes no byte of the views or maps."""
    if method == "TEN" and not focus_range:
        monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")  # JAX TEN -> Pallas
    cfg = RenderConfig(view_count=views, focus_map_views=8, focus_steps=8)
    kw = dict(focus=0.05, focus_range=focus_range, method=method)
    ref = Interpolator(lf, config=cfg, device="cpu", progress=False).interpolate(
        "0,0,3,3", progress=False, **kw)
    b, plan = _first(_scan(views, method, 8 if focus_range else 0),
                     lambda p: p.batched and views % p.view_batch and p.view_batch <= 24)
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    interp = Interpolator(lf, config=cfg, device="cpu", progress=False)
    assert interp._plan(views, method, 8 if focus_range else 0, 0, False) == plan
    out = interp.interpolate("0,0,3,3", progress=False, benchmark_runs=1, **kw)
    monkeypatch.delenv("LFI_HBM_BYTES")
    np.testing.assert_array_equal(out.views, ref.views)
    assert len(out.run_times_s) == 1  # the benchmark loop runs the batched step
    want, forced = _jax_render(small_lf, monkeypatch, b, views=views, **kw)
    if focus_range:
        np.testing.assert_array_equal(out.maps, ref.maps)
        np.testing.assert_array_equal(out.maps, want.maps)
    # JAX's fixed routes (Pallas and XLA) sum in their own order: 1 LSB
    tol = 0 if focus_range else 1
    assert np.abs(out.views.astype(int) - want.views.astype(int)).max() <= tol
    # STD at this budget batches on both sides; JAX's TEN needs its padded
    # stack, more than the whole budget
    assert forced == (method == "STD" and not focus_range)


def test_view_batched_interpolate_batch(lf, monkeypatch):
    """interpolate_batch plans each group's stacked rows and falls back to
    view batches when they do not fit."""
    cfg = RenderConfig(method="TEN", view_count=8)
    trajs = ["0,0,3,3", "1,1,2,2", "0,0,3,3"]  # one center -> one group
    ref = Interpolator(lf, config=cfg, device="cpu", progress=False).interpolate_batch(
        trajs, focus=0.05, progress=False)
    b, plan = _first(_scan(24, "TEN"), lambda p: p.batched and p.view_batch <= 7)
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    out = Interpolator(lf, config=cfg, device="cpu", progress=False).interpolate_batch(
        trajs, focus=0.05, progress=False)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.views, r.views)


def test_two_stage_quilt_of_view_batches(lf, monkeypatch):
    """A two-stage quilt whose render batches assembles the host views."""
    cfg = RenderConfig(method="STD")
    ref = Interpolator(lf, config=cfg, device="cpu", progress=False).render_quilt(
        "0,0,3,3", focus=0.05, progress=False)
    canvas = 2 * 45 * C * H * W
    b = next(b for b in range(1 << 24, 0, -997)
             if capacity.plan_render(G, C, H, W, 64, method="STD", extra=canvas,
                                     budget=b).batched)
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    out = Interpolator(lf, config=cfg, device="cpu", progress=False).render_quilt(
        "0,0,3,3", focus=0.05, progress=False)
    np.testing.assert_array_equal(out.quilt, ref.quilt)


def test_streaming_capacity_guard(monkeypatch):
    monkeypatch.setenv("LFI_HBM_BYTES", "500000")
    with pytest.raises(ValueError, match="Streaming 64 views") as e:
        StreamingRenderer(8, 8, 64, 48, "0,0,1,1", device="cpu")
    assert "mesh" not in str(e.value)
    monkeypatch.setenv("LFI_HBM_BYTES", str(1 << 30))
    StreamingRenderer(8, 8, 64, 48, "0,0,1,1", device="cpu")
