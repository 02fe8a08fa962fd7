"""The kernels' byte and operation counts against the headline frame's
numbers (an 8x8 grid of 1920x1080 images, 64 views; the estimate of 32
views and 32 candidates at radius (20, 10))."""

import pytest

from lfibench import roofline


def test_the_blend_of_the_headline_frame():
    nbytes, macs = roofline.blend_counts(64, 64, 3, 1080, 1920)
    assert macs == 25_480_396_800  # 25.48 G multiply-adds
    assert nbytes == pytest.approx(796.3e6, rel=1e-4)
    assert roofline.blend_bound_s(64, 64, 3, 1080, 1920) == pytest.approx(nbytes / 3.35e12)


def test_the_exact_estimate_of_the_headline_frame():
    radius = roofline.block_radius(1920, 1080, 100)
    assert radius == (20, 10)
    nbytes, ops = roofline.estimate_counts(32, 32, 1080, 1920, radius)
    assert ops == pytest.approx(4.4e9, rel=0.01)  # 4.4 G word min/max
    assert nbytes - 1080 * 1920 == 265_420_800  # the 265 MB RGBx copy
    assert roofline.INT32_OPS_PER_S == 16.75e12
    assert roofline.estimate_bound_s(32, 32, 1080, 1920, radius) == pytest.approx(ops / 16.75e12)


def test_the_all_focus_frame_adds_the_map_and_its_table():
    b, m = roofline.blend_counts(81, 64, 3, 512, 512)
    ab, am = roofline.allfocus_blend_counts(81, 64, 3, 512, 512)
    assert am == m and ab == b + 512 * 512 + 1024
    config = {"cols": 8, "rows": 8, "views": 64, "height": 1080, "width": 1920,
              "pixel_size_factor": 100, "focus_map_views": 32, "focus_steps": 32}
    assert roofline.frame_bound_s(config, True) == pytest.approx(
        roofline.estimate_bound_s(32, 32, 1080, 1920, (20, 10))
        + roofline.allfocus_blend_bound_s(64, 64, 3, 1080, 1920))
