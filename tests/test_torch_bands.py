"""A frame downloaded in row bands (``utils/transfer.py``): the band count
of each frame shape, the bands' cover of the rows, the ``download bands``
count, and host results equal to the whole-frame download's.

On the CPU: ``transfer.band_count`` for the benchmark's five frame shapes
(HCI's 512² frame stays whole, the 17×17 grid's 1024² frames take bands),
its limits, ``row_bands`` over every H up to 64, and the banded arm of
``Interpolator.interpolate``, forced to bands on the CPU, against the
whole frame (``interpolate_batch`` stays whole); a TEN all-in-focus
frame estimated band by band (``pipeline.FocusBands``: ``estimate bands``
n, its maps sent last), also with bands thinner than the stencil's ry,
while STD, the pyramid, one band and view batches estimate whole and send
their maps first; the prepared estimate (``focus_estimate.Estimate``)
block by block against the frame. On the card (``cuda`` marker; each test
skips without one): banded downloads, fixed and all in focus, at G = 64
and 1080p-like widths and at G = 289 and 1024² (five passes), into pinned
arrays filled with a sentinel, ``np.array_equal`` to the whole-frame
download, with band counts that do not divide H; the 1080p TEN frame's
banded estimate, exact and fast, against the whole frame. This file
imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_bands.py
"""

import numpy as np
import pytest
import torch

from lfinterpolator_tpu_torch.api import Interpolator
from lfinterpolator_tpu_torch.core import geometry
from lfinterpolator_tpu_torch.core.config import RenderConfig
from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.utils import profiling, transfer

torch.set_num_threads(1)

#: The benchmark's frames: (G, passes over the images, V, C, H, W, all in
#: focus). The passes are ``lfi_blend_grid_passes(G)`` (one up to 96 images,
#: five at 289), which the card's test below reads from the library.
CELLS = {
    "hci9x9_512.allfocus_api": (81, 1, 64, 3, 512, 512, True),
    "lf8x8_1080p.allfocus_api": (64, 1, 64, 3, 1080, 1920, True),
    "lf8x8_1080p.fixed_api": (64, 1, 64, 3, 1080, 1920, False),
    "stanford17x17_1024.allfocus_api": (289, 5, 64, 3, 1024, 1024, True),
    "stanford17x17_1024.fixed_api": (289, 5, 64, 3, 1024, 1024, False),
}
CALLS = {
    "fixed TEN": dict(focus=0.1, method="TEN"),
    "fixed STD": dict(focus=-0.2, method="STD"),
    "all in focus TEN": dict(focus=0.1, focus_range=0.3, method="TEN"),
    "all in focus STD": dict(focus=0.1, focus_range=0.3, method="STD"),
}


def _bands(cell):
    g, passes, v, c, h, w, allfocus = CELLS[cell]
    return transfer.band_count(g, passes, v, c, h, w, allfocus=allfocus)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_band_count_of_the_benchmark_frames(cell):
    """HCI's 50 MB frame (a 0.2 ms blend) is downloaded whole; the 17×17
    grid's 201 MB frames, whose blends are as long as their copies, in
    several bands; every count within its limits."""
    n = _bands(cell)
    assert 1 <= n <= transfer.MAX_BANDS
    if cell.startswith("hci9x9_512"):
        assert n == 1
    if cell.startswith("stanford17x17_1024"):
        assert n > 1


def test_band_count_grows_with_the_blend_it_can_hide():
    """All in focus (the longer blend) never takes fewer bands than fixed
    focus at the same shape, nor a larger grid fewer than a smaller one."""
    for g, passes in ((64, 1), (289, 5)):
        for h, w in ((512, 512), (1024, 1024), (1080, 1920)):
            fixed = transfer.band_count(g, passes, 64, 3, h, w, allfocus=False)
            assert transfer.band_count(g, passes, 64, 3, h, w, allfocus=True) >= fixed
    for h, w in ((1024, 1024), (1080, 1920)):
        assert (transfer.band_count(289, 5, 64, 3, h, w, allfocus=True)
                >= transfer.band_count(16, 1, 64, 3, h, w, allfocus=True))


@pytest.mark.parametrize("shape", [
    (289, 5, 64, 3, 1, 4096),  # one row: nothing to split
    (289, 5, 64, 3, 3, 4096),  # more bands than rows would be worth
    (64, 1, 4, 3, 32768, 32768),  # a view plane past a 2-D copy's pitch
    (1, 1, 1, 1, 8, 8),  # nothing to hide
])
def test_band_count_limits(shape):
    g, passes, v, c, h, w = shape
    n = transfer.band_count(g, passes, v, c, h, w, allfocus=True)
    assert 1 <= n <= min(h, transfer.MAX_BANDS)
    if h < 2 or h * w * c > transfer.MAX_PITCH or g == 1:
        assert n == 1


@pytest.mark.parametrize("n", range(1, 9))
def test_row_bands_cover_the_rows_once_in_order(n):
    for h in range(1, 65):
        bands = transfer.row_bands(h, n)
        assert len(bands) == min(n, h)
        assert [r for r0, hb in bands for r in range(r0, r0 + hb)] == list(range(h))
        heights = [hb for _, hb in bands]
        assert min(heights) >= 1 and max(heights) - min(heights) <= 1


def test_frame_bands_off_the_card_are_the_whole_frame():
    assert transfer.frame_bands("cpu", 289, 3, 1024, 1024, 64, allfocus=True) == [(0, 1024)]


@pytest.fixture(scope="module")
def interp():
    rng = np.random.default_rng(19)
    images = rng.integers(0, 256, (16, 23, 40, 3), dtype=np.uint8)
    return Interpolator(LightField(images, 4, 4), config=RenderConfig(focus_map_views=8),
                        device="cpu", progress=False)


def _forced(monkeypatch, n):
    """Make every one-pass frame take `n` bands, as the card's band count
    would for a larger frame."""
    monkeypatch.setattr(transfer, "frame_bands",
                        lambda device, g, c, h, w, v, allfocus: transfer.row_bands(h, n))


@pytest.mark.parametrize("n", [2, 3, 7])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_a_banded_frame_is_the_whole_frame(interp, call, n, monkeypatch):
    """Forced bands on the CPU (23 rows: no n here divides them) give the
    whole frame's views and maps, and count one ``download bands`` a band;
    the whole frame counts one."""
    kw = dict(CALLS[call], progress=False)
    profiling.reset_launch_counts()
    whole = interp.interpolate("0.1,0.2,0.9,0.7", **kw)
    assert profiling.launch_counts()["download bands"] == 1
    _forced(monkeypatch, n)
    profiling.reset_launch_counts()
    banded = interp.interpolate("0.1,0.2,0.9,0.7", **kw)
    assert profiling.launch_counts()["download bands"] == n
    assert np.array_equal(banded.views, whole.views)
    assert (banded.maps is None) == (whole.maps is None)
    if whole.maps is not None:
        assert np.array_equal(banded.maps, whole.maps)


def test_a_batch_downloads_each_group_whole(interp, monkeypatch):
    """``interpolate_batch`` blends a group of trajectories in one launch
    and downloads it whole, whatever the band count."""
    trajectories = ["0,0,1,1", "0.1,0.2,0.9,0.7", "0.2,0.2,0.8,0.8"]
    kw = dict(focus=0.1, focus_range=0.3, method="TEN", progress=False)
    whole = interp.interpolate_batch(trajectories, **kw)
    _forced(monkeypatch, 4)
    profiling.reset_launch_counts()
    again = interp.interpolate_batch(trajectories, **kw)
    assert profiling.launch_counts()["download bands"] == 2  # two groups of centers
    for a, b in zip(whole, again):
        assert np.array_equal(a.views, b.views) and np.array_equal(a.maps, b.maps)


def test_a_banded_download_checks_the_array_it_writes():
    """The bands are written through raw pointers on the card: an `out` of
    another shape, type or layout raises before anything is copied."""
    views = torch.arange(2 * 3 * 5 * 4, dtype=torch.int64).remainder(251).to(torch.uint8)
    views = views.reshape(2, 3, 5, 4)
    bands = transfer.row_bands(5, 2)
    dl = transfer.Downloader("cpu")

    def render(r0, hb):
        return views[:, :, r0:r0 + hb]

    got = dl.start_bands(render, bands).wait()
    assert np.array_equal(got, views.permute(0, 2, 3, 1).numpy())
    for bad in (torch.empty((2, 5, 4, 4), dtype=torch.uint8),
                torch.empty((2, 5, 4, 3), dtype=torch.int16),
                torch.empty((2, 4, 5, 3), dtype=torch.uint8).transpose(1, 2)):
        with pytest.raises(ValueError, match="out must be"):
            dl.start_bands(render, bands, out=bad)


def test_timed_renders_and_quilts_keep_the_whole_frame(interp, monkeypatch):
    """``benchmark_runs`` times the whole-frame step and downloads its
    first output whole; a quilt never downloads its views, only its canvas,
    whole, as one band."""
    _forced(monkeypatch, 3)
    profiling.reset_launch_counts()
    res = interp.interpolate("0,0,1,1", focus=0.1, method="TEN", benchmark_runs=2,
                             progress=False)
    assert profiling.launch_counts()["download bands"] == 1 and len(res.run_times_s) == 2
    profiling.reset_launch_counts()
    interp.render_quilt("0,0,1,1", focus=0.1, focus_range=0.3, method="TEN", cols=2,
                        rows=2, progress=False)
    assert profiling.launch_counts()["download bands"] == 1


#: Configurations of the banded estimate's tests: the fixture's (stencil
#: radius (2, 2), no filter), and a wide one, radius (10, 6) and filter
#: (5, 3) at 23x40, so that 7 bands of 3-4 rows are thinner than ry and a
#: band's halo spans several bands.
RADII = {
    "radius2": dict(focus_map_views=8),
    "radius6": dict(focus_map_views=8, pixel_size_factor=4, filter_radius_divisor=2),
}
RULES = {"exact": True, "fast": False}


@pytest.fixture(scope="module")
def interps():
    """(radius, rule) -> an Interpolator over the fixture's 4x4 grid."""
    images = np.random.default_rng(19).integers(0, 256, (16, 23, 40, 3), dtype=np.uint8)
    return {(radius, rule): Interpolator(
                LightField(images, 4, 4),
                config=RenderConfig(exact_focus_taps=exact, **RADII[radius]),
                device="cpu", progress=False)
            for radius in RADII for rule, exact in RULES.items()}


def _host_shapes(monkeypatch):
    """Record the shape of every host array a download allocates, in order."""
    shapes, empty = [], transfer.host_empty
    monkeypatch.setattr(transfer, "host_empty",
                        lambda shape, device: shapes.append(tuple(shape)) or empty(shape, device))
    return shapes


@pytest.mark.parametrize("n", [2, 3, 7])
@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("radius", sorted(RADII))
def test_a_banded_ten_frame_estimates_each_band_and_equals_the_whole_frame(
        interps, radius, rule, n, monkeypatch):
    """A TEN all-in-focus frame of n bands whose copy sets its pace (64
    views of 23x40 from 8 focus views) estimates its raw map in n row
    blocks, one before each band's blend, and sends its maps after the
    last band: views and both maps byte for byte the whole frame's, with
    the exact and the fast tap rule; the whole frame estimates in one
    block."""
    interp = interps[radius, rule]
    kw = dict(focus=0.1, focus_range=0.3, method="TEN", progress=False)
    profiling.reset_launch_counts()
    whole = interp.interpolate("0.1,0.2,0.9,0.7", **kw)
    assert profiling.launch_counts()["estimate bands"] == 1
    _forced(monkeypatch, n)
    shapes = _host_shapes(monkeypatch)
    profiling.reset_launch_counts()
    banded = interp.interpolate("0.1,0.2,0.9,0.7", **kw)
    counts = profiling.launch_counts()
    assert (counts["estimate bands"], counts["download bands"]) == (n, n)
    assert shapes == [whole.views.shape, whole.maps.shape]  # the maps go last
    assert np.array_equal(banded.views, whole.views)
    assert np.array_equal(banded.maps, whole.maps)
    if radius == "radius6" and n == 7:
        ry = geometry.block_radius(40, 23, RADII[radius]["pixel_size_factor"])[1]
        assert max(hb for _, hb in transfer.row_bands(23, n)) < ry
        assert np.any(whole.maps[0] != whole.maps[1])  # the filter moved bytes


def test_frames_of_other_routes_estimate_whole_and_send_their_maps_first(
        interps, monkeypatch):
    """STD blends with the filtered map, so its banded frame estimates and
    filters the whole frame first and sends its maps before any band; a
    one-band frame and a view-batched frame estimate once too."""
    interp = interps["radius6", "exact"]
    std = dict(focus=0.1, focus_range=0.3, method="STD", progress=False)
    whole = interp.interpolate("0.1,0.2,0.9,0.7", **std)
    _forced(monkeypatch, 3)
    shapes = _host_shapes(monkeypatch)
    profiling.reset_launch_counts()
    banded = interp.interpolate("0.1,0.2,0.9,0.7", **std)
    assert (profiling.launch_counts()["estimate bands"],
            profiling.launch_counts()["download bands"]) == (1, 3)
    assert shapes == [whole.maps.shape, whole.views.shape]  # the maps go first
    assert np.array_equal(banded.views, whole.views)
    assert np.array_equal(banded.maps, whole.maps)
    ten = dict(std, method="TEN")
    _forced(monkeypatch, 1)
    profiling.reset_launch_counts()
    one = interp.interpolate("0.1,0.2,0.9,0.7", **ten)
    assert (profiling.launch_counts()["estimate bands"],
            profiling.launch_counts()["download bands"]) == (1, 1)
    _forced(monkeypatch, 3)
    monkeypatch.setenv("LFI_HBM_BYTES", "200000")  # view batches of 16
    profiling.reset_launch_counts()
    batched = interp.interpolate("0.1,0.2,0.9,0.7", **ten)
    assert profiling.launch_counts()["estimate bands"] == 1
    assert profiling.launch_counts()["download bands"] > 1  # one a batch
    assert np.array_equal(batched.views, one.views)
    assert np.array_equal(batched.maps, one.maps)


def test_a_pyramid_frame_estimates_whole_and_sends_its_maps_first(monkeypatch):
    """``--focus-pyramid`` at 96x512, a geometry the pyramid takes: its
    refine pass takes the whole frame, so a banded TEN frame keeps the
    whole-frame estimate, filter and maps first."""
    h, w = 96, 512
    images = np.random.default_rng(5).integers(0, 256, (16, h, w, 3), dtype=np.uint8)
    cfg = RenderConfig(focus_map_views=8, focus_pyramid=True, view_count=8, focus_steps=8)
    interp = Interpolator(LightField(images, 4, 4), config=cfg, device="cpu",
                          progress=False)
    # without the pyramid, the copy would set this frame's pace
    assert transfer.estimate_in_bands(16, 8, 3, h, w, 8, 8)
    kw = dict(focus=0.1, focus_range=0.3, method="TEN", progress=False)
    whole = interp.interpolate("0,0,1,1", **kw)
    _forced(monkeypatch, 3)
    shapes = _host_shapes(monkeypatch)
    profiling.reset_launch_counts()
    banded = interp.interpolate("0,0,1,1", **kw)
    assert (profiling.launch_counts()["estimate bands"],
            profiling.launch_counts()["download bands"]) == (1, 3)
    assert shapes == [whole.maps.shape, whole.views.shape]
    assert np.array_equal(banded.views, whole.views)
    assert np.array_equal(banded.maps, whole.maps)


@pytest.mark.parametrize("cell", sorted(c for c in CELLS if CELLS[c][-1]))
def test_the_estimate_is_banded_only_where_the_copy_sets_the_pace(cell):
    """The 1080p frame's copy (7.2 ms) outlasts its estimate, blend and HWC
    copy (~6.6 ms), so its estimate runs band by band; the 17x17 frame's
    SMs (~5.8 ms) outlast its copy (3.7 ms), so it estimates whole; HCI
    takes one band."""
    g, passes, v, c, h, w, allfocus = CELLS[cell]
    banded = transfer.estimate_in_bands(g, v, c, h, w, 32, 32)
    assert banded == cell.startswith("lf8x8_1080p")
    assert (_bands(cell) > 1) or not banded


def test_a_frame_the_sms_pace_estimates_whole(monkeypatch):
    """Four views of 23x40 from 8 focus views: the estimate outlasts the
    copy, so a TEN frame of 3 bands estimates whole and sends its maps
    first."""
    images = np.random.default_rng(19).integers(0, 256, (16, 23, 40, 3), dtype=np.uint8)
    interp = Interpolator(LightField(images, 4, 4),
                          config=RenderConfig(view_count=4, **RADII["radius6"]),
                          device="cpu", progress=False)
    assert not transfer.estimate_in_bands(16, 4, 3, 23, 40, 8, 32)
    kw = dict(focus=0.1, focus_range=0.3, method="TEN", progress=False)
    whole = interp.interpolate("0.1,0.2,0.9,0.7", **kw)
    _forced(monkeypatch, 3)
    shapes = _host_shapes(monkeypatch)
    profiling.reset_launch_counts()
    banded = interp.interpolate("0.1,0.2,0.9,0.7", **kw)
    assert (profiling.launch_counts()["estimate bands"],
            profiling.launch_counts()["download bands"]) == (1, 3)
    assert shapes == [whole.maps.shape, whole.views.shape]
    assert np.array_equal(banded.views, whole.views)
    assert np.array_equal(banded.maps, whole.maps)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_the_prepared_estimate_writes_any_block_as_the_frame_has_it(rule):
    """``focus_estimate.Estimate``: blocks of any size and order, some
    thinner than the stencil's ry, written into one frame map, give the
    whole-frame ``focus_estimate`` byte for byte; a block without a frame
    map is those rows."""
    from lfinterpolator_tpu_torch.ops import focus_estimate
    from lfinterpolator_tpu_torch.ops.estimate_geometry import FocusTables
    from lfinterpolator_tpu_torch.state import focus_tables

    rng = np.random.default_rng(24)
    h, w, radius = 29, 37, (4, 6)
    selected = torch.from_numpy(rng.integers(0, 256, (6, 3, h, w), dtype=np.uint8))
    offsets = torch.from_numpy(rng.uniform(-3, 3, (6, 2)).astype(np.float32))
    tables = FocusTables(*(torch.from_numpy(t) for t in focus_tables(-0.4, 1.3, 8)))
    exact = RULES[rule]
    want = focus_estimate.focus_estimate(selected, offsets, tables, radius, exact)
    frame = torch.full((h, w), 7, dtype=torch.uint8)
    est = focus_estimate.Estimate(selected, offsets, tables, radius, exact, out=frame)
    for r0, hb in ((20, 9), (0, 3), (3, 2), (5, 15)):
        got = est.rows(r0, hb)
        assert got.data_ptr() == frame[r0].data_ptr()
    assert torch.equal(frame, want)
    alone = focus_estimate.Estimate(selected, offsets, tables, radius, exact)
    for r0, hb in ((0, 1), (11, 4), (28, 1)):
        assert torch.equal(alone.rows(r0, hb), want[r0:r0 + hb])


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the download's 2-D copy has no CPU mode)")
    return torch.device("cuda")


def _grid(cols, rows, h, w, seed):
    rng = np.random.default_rng(seed)
    return LightField(rng.integers(0, 256, (cols * rows, h, w, 3), dtype=np.uint8),
                      cols, rows)


#: (cols, rows, H, W): G = 64 at a 1080p width, 135 rows (no n here
#: divides them); G = 289 at 1024², five passes.
GRIDS = {"8x8_135x1920": (8, 8, 135, 1920), "17x17_1024x1024": (17, 17, 1024, 1024)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fixed", "allfocus"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_banded_downloads_on_the_card_equal_the_whole_frame(grid, kind, cuda_device):
    """The render's own bands and forced counts (3, 5, 7) into pinned
    arrays filled with 0 and 255, so that a row no band wrote shows."""
    cols, rows, h, w = GRIDS[grid]
    interp = Interpolator(_grid(cols, rows, h, w, 7), config=RenderConfig(focus_map_views=32),
                          device=cuda_device, progress=False)
    try:
        kw = dict(focus=0.1, focus_range=0.3 if kind == "allfocus" else 0.0)
        cfg, method_key = interp._config(method="TEN", effect=None, aspect=None, **kw)
        step = interp._render_step("0.1,0.2,0.9,0.7", cfg, method_key, False)
        views, maps = step()
        whole = interp._download.start(views, maps).wait()
        whole_views, whole_maps = whole if maps is not None else (whole, None)
        del views
        found = step.download(interp._download)
        assert np.array_equal(found[0], whole_views)
        if maps is not None:
            assert np.array_equal(found[1], whole_maps)
        assert len(step.bands) > 1 or h < 1024
        est = None if step.estimate is None else step.estimate()
        for n, sentinel in ((3, 0), (5, 255), (7, 0), (7, 255)):
            out = transfer.host_empty(whole_views.shape, cuda_device).fill_(sentinel)
            before = profiling.launch_counts()["download bands"]
            got = interp._download.start_bands(
                lambda r0, hb: step.blend(est, r0, hb), transfer.row_bands(h, n), est,
                out=out).wait()
            assert profiling.launch_counts()["download bands"] - before == n
            got_views = got[0] if est is not None else got
            assert got_views.ctypes.data == out.data_ptr()
            assert np.array_equal(got_views, whole_views), (n, sentinel)
            if est is not None:
                assert np.array_equal(got[1], whole_maps)
    finally:
        # the 17x17 stack and frames are large: leave the card's memory free
        # for the tests after this one
        del interp
        step = maps = est = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("rule", sorted(RULES))
def test_a_banded_estimate_on_the_card_equals_the_whole_frame(rule, cuda_device):
    """An 8x8 grid of 1080x1920, TEN all in focus (the benchmark's 1080p
    frame, 3 bands): estimated band by band, each band's raw rows just
    before its blend, the filter after the last band, its views and both
    maps equal the whole-frame render's downloaded whole; the estimate
    counts once as its rule and once a band as ``estimate bands``."""
    interp = Interpolator(_grid(8, 8, 1080, 1920, 24),
                          config=RenderConfig(focus_map_views=32,
                                              exact_focus_taps=RULES[rule]),
                          device=cuda_device, progress=False)
    try:
        cfg, method_key = interp._config(focus=0.1, focus_range=0.3, method="TEN",
                                         effect=None, aspect=None)
        step = interp._render_step("0.1,0.2,0.9,0.7", cfg, method_key, False)
        assert step.focus_bands is not None and len(step.bands) == _bands(
            "lf8x8_1080p.allfocus_api") > 1
        whole_views, whole_maps = interp._download.start(*step()).wait()
        before = profiling.launch_counts()
        views, maps = step.download(interp._download)
        counted = profiling.launch_counts()
        assert counted["estimate bands"] - before["estimate bands"] == len(step.bands)
        assert counted["download bands"] - before["download bands"] == len(step.bands)
        key = f"focus_estimate_{rule}"
        assert counted[key] - before[key] == 1
        assert np.array_equal(maps, whole_maps)
        assert np.array_equal(views, whole_views)
    finally:
        del interp
        step = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_the_band_count_reads_the_passes_of_the_library(cuda_device):
    from lfinterpolator_tpu_torch.ops import _build

    lib = _build.load()
    for cell, (g, passes, v, c, h, w, allfocus) in CELLS.items():
        assert lib.lfi_blend_grid_passes(g) == passes, cell
        assert transfer.frame_bands(cuda_device, g, c, h, w, v, allfocus=allfocus) == \
            transfer.row_bands(h, _bands(cell))
