"""The Stanford archive's 17x17 grid (289 images) through the port's
Interpolator and the JAX package's, on the CPU: fixed focus with TEN and
STD, all in focus with the exact estimate.

Tolerances as in tests/test_torch_slice.py and
tests/test_torch_allfocus_slice.py: views within 1 LSB of the JAX package
(its TEN contraction runs here in Pallas interpret mode), maps byte-equal.
The scene's planes span the focus window 0.0 +- 0.3, so at 24x40 the maps
hold several candidates and the all-in-focus blend gathers from more than
one plane.
"""

import numpy as np
import pytest
import torch

from lfibench.scene import OcclusionScene, plane_foci
from lfinterpolator_tpu.api import Interpolator as JaxInterpolator
from lfinterpolator_tpu.io.loader import LightField as JaxLightField
from lfinterpolator_tpu_torch.api import Interpolator
from lfinterpolator_tpu_torch.io import LightField

torch.set_num_threads(1)

COLS = ROWS = 17
H, W = 24, 40
TRAJECTORY = "0.1,0.2,0.9,0.7"
FOCUS_RANGE = 0.3


@pytest.fixture(scope="module")
def grid17():
    """A seeded 17x17 parallax-occlusion grid [289, H, W, 3] uint8."""
    scene = OcclusionScene(COLS, ROWS, H, W, plane_foci(0.0, FOCUS_RANGE, 32), [4, 3], 7,
                           "cpu")
    return scene.frame().numpy()


@pytest.mark.parametrize("method", ["TEN", "STD"])
@pytest.mark.parametrize("focus, focus_range", [(0.2, 0.0), (0.0, FOCUS_RANGE)],
                         ids=["fixed", "allfocus"])
def test_a_17x17_grid_matches_the_jax_package(grid17, method, focus, focus_range,
                                               monkeypatch):
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")  # JAX TEN -> Pallas kernels
    got = Interpolator(LightField(images=grid17, cols=COLS, rows=ROWS), device="cpu",
                       progress=False).interpolate(
        TRAJECTORY, focus=focus, focus_range=focus_range, method=method, progress=False)
    want = JaxInterpolator(JaxLightField(grid17, COLS, ROWS), progress=False).interpolate(
        TRAJECTORY, focus=focus, focus_range=focus_range, method=method, progress=False)
    assert got.views.shape == want.views.shape == (64, H, W, 3)
    assert np.abs(got.views.astype(int) - want.views.astype(int)).max() <= 1
    if focus_range:
        assert got.maps.shape == (2, H, W)
        np.testing.assert_array_equal(got.maps, want.maps)
        assert len(np.unique(got.maps[0])) > 1
    else:
        assert got.maps is None and want.maps is None
