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
from lfinterpolator_tpu_torch.utils import profiling

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


class FakeCard:
    """One card's memory as ``torch.cuda.mem_get_info`` (``cudaMemGetInfo``) and
    ``torch.cuda.memory_stats_as_nested_dict`` (the caching allocator)
    report it, with a clock that moves only when a test moves it."""

    def __init__(self, free, reserved=0, allocated=0):
        self.free, self.reserved, self.allocated = free, reserved, allocated
        self.free_reads = 0
        self.now = 100.0

    @property
    def budget(self) -> int:
        return self.free + self.reserved - self.allocated

    def mem_get_info(self, device=None):
        self.free_reads += 1
        return self.free, 80 << 30

    def stats(self, device=None):
        return {"allocated_bytes": {"all": {"current": self.allocated}},
                "reserved_bytes": {"all": {"current": self.reserved}}}

    def allocate(self, nbytes, *, new_segment=True):
        """The caching allocator hands out `nbytes`, from a new segment of
        the card's free memory or from its reserved blocks."""
        self.allocated += nbytes
        if new_segment:
            self.reserved += nbytes
            self.free -= nbytes

    def release(self, nbytes):
        """Tensors of `nbytes` freed and their segments given back to the
        card (``empty_cache``)."""
        self.allocated -= nbytes
        self.reserved -= nbytes
        self.free += nbytes


CARD = torch.device("cuda:0")


@pytest.fixture
def card(monkeypatch):
    """A fake card in place of the free-memory read and the allocator's
    counts; the capacity module's clock and readings, and the table of
    counts, afresh."""
    fake = FakeCard(free=40 << 30, reserved=2 << 30, allocated=1 << 30)
    monkeypatch.setattr(torch.cuda, "mem_get_info", fake.mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", fake.stats)
    monkeypatch.setattr(capacity, "_clock", lambda: fake.now)
    monkeypatch.setattr(capacity, "_readings", {})
    profiling.reset_launch_counts()
    monkeypatch.delenv("LFI_HBM_BYTES", raising=False)
    return fake


def _plan_or_error(v, method, focus_views, **kw):
    try:
        return capacity.plan_render(G, C, H, W, v, method=method, focus_views=focus_views,
                                    **kw)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("method, k", [("TEN", 0), ("STD", 0), ("TEN", 8), ("STD", 8)],
                         ids=["fixed_ten", "fixed_std", "allfocus_ten", "allfocus_std"])
def test_the_cached_budget_plans_as_a_fresh_reading(card, method, k):
    """Over the scan's budgets (one pass, view batches, refused): a reading
    taken while the allocator held more, then tensors freed and segments
    given back, plans exactly as a fresh reading would; free memory is read
    again only where the render's peak is over half the budget."""
    plans = _scan(64, method, k)
    total = plans[0][1].bytes_unbatched
    arms = set()
    for b, _ in plans + [(plans[-1][0] // 2, None), (1, None)]:
        card.free, card.reserved, card.allocated = b + (6 << 20), 3 << 20, 4 << 20
        card.allocate(5 << 20)
        capacity.device_hbm_bytes(CARD)  # the reading
        card.release(5 << 20)
        card.allocate(5 << 20, new_segment=False)
        assert card.budget == b
        reads = card.free_reads
        got = _plan_or_error(64, method, k, device=CARD)
        assert got == _plan_or_error(64, method, k, budget=b)
        assert card.free_reads - reads == (2 * total > b)
        arms.add("refused" if isinstance(got, str) else got.batched)
    assert arms == {False, True, "refused"}


def test_steady_calls_within_a_second_read_free_memory_once(card):
    for _ in range(100):
        plan = capacity.plan_render(G, C, H, W, 64, method="TEN", focus_views=8, device=CARD)
        assert not plan.batched and plan.budget == card.budget - capacity._headroom(card.budget)
        card.now += 0.0099
    assert card.free_reads == profiling.launch_counts()["capacity budget reads"] == 1


@pytest.mark.parametrize("caller", ["plan_render", "check_capacity"])
def test_a_peak_over_half_the_budget_reads_again(card, caller):
    """The same rule for the plan and for the guard of the paths without
    view batches (the stream, the fused quilt, a mesh rank's shard)."""
    capacity.device_hbm_bytes(CARD)
    half = card.budget // 2

    def ask(peak):
        if caller == "check_capacity":
            capacity.check_capacity(peak, "a request", device=CARD)
        else:  # a TEN render's peak is its views and their download copy
            capacity.plan_render(1, 1, 1, 1, peak // 2, method="TEN", device=CARD)

    ask(half - half % 2)
    assert card.free_reads == 1
    ask(half + 2)
    assert card.free_reads == 2
    ask(half - half % 2)
    assert card.free_reads == 2


@pytest.mark.parametrize("arm", ["batched", "refused"])
def test_a_batched_or_refused_plan_reads_again_every_time(card, arm):
    plans = _scan(64, "TEN", 8)
    b = _first(plans, lambda p: p.batched)[0] if arm == "batched" else plans[-1][0] // 2
    card.free, card.reserved, card.allocated = b, 0, 0
    capacity.device_hbm_bytes(CARD)
    for n in range(2, 5):
        got = _plan_or_error(64, "TEN", 8, device=CARD)
        assert got == _plan_or_error(64, "TEN", 8, budget=b)
        assert isinstance(got, str) == (arm == "refused") and card.free_reads == n


def test_a_reading_older_than_a_second_reads_again(card):
    capacity.device_hbm_bytes(CARD)
    card.now += capacity.READING_TTL_S
    capacity.device_hbm_bytes(CARD, 0)
    assert card.free_reads == 1
    card.now += 1e-6
    capacity.device_hbm_bytes(CARD, 0)
    assert card.free_reads == 2
    card.now += 0.5
    capacity.device_hbm_bytes(CARD, 0)
    assert card.free_reads == 2


def test_allocated_growth_lowers_the_budget_without_a_reading(card):
    before = capacity.device_hbm_bytes(CARD)
    card.allocate(300 << 20, new_segment=False)  # from the allocator's reserved blocks
    assert capacity.device_hbm_bytes(CARD, 0) == before - (300 << 20)
    card.allocate(700 << 20)  # a new segment: free and reserved move together
    assert capacity.device_hbm_bytes(CARD, 0) == before - (1000 << 20) == card.budget
    assert card.free_reads == 1


@pytest.mark.parametrize("source", ["env", "budget", "cpu"])
def test_the_override_a_given_budget_and_the_cpu_never_read_the_card(card, monkeypatch,
                                                                     source):
    def no_reading(*args, **kwargs):
        raise AssertionError("the card was read")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_reading)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", no_reading)
    kw = {"device": CARD}
    if source == "env":
        monkeypatch.setenv("LFI_HBM_BYTES", str(1 << 30))
    elif source == "budget":
        kw["budget"] = 1 << 30
    else:
        kw["device"] = "cpu"
    for _ in range(3):
        card.now += 5.0
        b = capacity.UNBOUNDED if source == "cpu" else 1 << 30
        plan = capacity.plan_render(G, C, H, W, 64, method="STD", focus_views=8, **kw)
        assert plan.budget == b - capacity._headroom(b)
        capacity.check_capacity(1 << 20, "a request", **kw)
    assert profiling.launch_counts()["capacity budget reads"] == 0


def test_budget_reads_are_counted_and_reset(card):
    for _ in range(3):
        capacity.device_hbm_bytes(CARD, 0)
        card.now += 2.0
    assert profiling.launch_counts()["capacity budget reads"] == 3 == card.free_reads
    profiling.reset_launch_counts()
    assert profiling.launch_counts()["capacity budget reads"] == 0


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
