"""The blend weights, bit for bit: ``core/geometry.weight_matrix`` weighs all
views of a trajectory in one broadcast expression, and must equal the
per-view loop it replaced (the JAX package's ``weight_matrix``, and the
loop copied below) in every bit, NaNs included.

A weight one float32 ulp off can round to another fp16 value and move view
bytes off the near-tie rule, so there is no tolerance. The cases: the
benchmark's two deployments (8x8 and 9x9 grids, 64 views, effect 3,
endpoints uniform in [0, 1]), one view, one-row and one-column grids, a
fractional and a negative effect (NaN where a camera lies farther than
|(cols, rows)|), endpoints outside [0, 1].

Nothing here imports JAX at module level: ``-k "not jax"`` runs the rest
with ``--noconftest`` on a machine without it, whose NumPy may take other
SIMD loops.
"""

import numpy as np
import pytest

from lfibench.reference import geometry as frozen_geometry
from lfinterpolator_tpu_torch import state
from lfinterpolator_tpu_torch.core import geometry
from lfinterpolator_tpu_torch.core.config import RenderConfig

# (cols, rows, height, width, focus, focus_range) of lfibench/configs/*.json.
DEPLOYMENTS = {"lf8x8_1080p": (8, 8, 1080, 1920, 0.1, 0.3),
               "hci9x9_512": (9, 9, 512, 512, 0.0, 0.07)}


def _benchmark_trajectory(rng) -> str:
    return ",".join(f"{x:.6f}" for x in rng.uniform(0.0, 1.0, 4))


# name -> (trajectory, cols, rows, effect, views)
CASES = {f"{d}-{seed}": (_benchmark_trajectory(np.random.default_rng(seed)),
                         *DEPLOYMENTS[d][:2], 3.0, 64)
         for d in DEPLOYMENTS for seed in range(8)}
CASES.update({
    "one_view": ("0.3,0.6,0.9,0.1", 8, 8, 3.0, 1),
    "one_row": ("0,0,1,1", 1, 7, 3.0, 64),
    "one_column": ("0.2,0,0.8,0", 6, 1, 2.0, 17),
    "fractional_effect": ("-1.5,-1.2,2.5,2.2", 9, 9, 2.5, 64),
    "negative_effect": ("-1.5,-1.2,2.5,2.2", 5, 4, -1.5, 33),
    "outside": ("-0.2,1.2,1.2,-0.2", 8, 8, 3.0, 64),
})


def _case(name):
    """-> (start_end, cols, rows, effect, views) of case `name`."""
    traj, cols, rows, effect, views = CASES[name]
    return geometry.parse_trajectory(traj, (cols, rows)), cols, rows, effect, views


def _loop_weight_matrix(start_end, cols, rows, effect, n_views):
    """The per-view loop the broadcast replaced, as the JAX package has it."""

    def generate_weights(coords):
        pos = geometry.grid_positions(cols, rows)
        max_distance = np.float32(np.hypot(np.float32(cols), np.float32(rows)))
        dist = np.hypot(coords[0].astype(np.float32) - pos[:, 0],
                        coords[1].astype(np.float32) - pos[:, 1]).astype(np.float32)
        w = np.power(max_distance - dist, np.float32(effect), dtype=np.float32)
        return (w / w.sum(dtype=np.float32)).astype(np.float32)

    traj = geometry.generate_trajectory(start_end, n_views)
    return np.stack([generate_weights(traj[v]) for v in range(n_views)], axis=0)


def _assert_bits_equal(got, want):
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture
def jax_geometry():
    from lfinterpolator_tpu.core import geometry as jax_geometry

    return jax_geometry


@pytest.mark.parametrize("case", list(CASES))
def test_weight_matrix_equals_the_jax_one(case, jax_geometry):
    se, cols, rows, effect, views = _case(case)
    with np.errstate(invalid="ignore"):
        got = geometry.weight_matrix(se, cols, rows, effect, views)
        want = jax_geometry.weight_matrix(se, cols, rows, effect, views)
        _assert_bits_equal(got, want)
        traj = geometry.generate_trajectory(se, views)
        for v in range(views):
            _assert_bits_equal(geometry.generate_weights(traj[v], cols, rows, effect), got[v])
            _assert_bits_equal(jax_geometry.generate_weights(traj[v], cols, rows, effect),
                               got[v])


@pytest.mark.parametrize("case", list(CASES))
def test_weight_matrix_equals_the_per_view_loop(case):
    se, cols, rows, effect, views = _case(case)
    with np.errstate(invalid="ignore"):
        got = geometry.weight_matrix(se, cols, rows, effect, views)
        _assert_bits_equal(got, _loop_weight_matrix(se, cols, rows, effect, views))
        traj = geometry.generate_trajectory(se, views)
        for v in range(views):
            _assert_bits_equal(geometry.generate_weights(traj[v], cols, rows, effect), got[v])
    # The NaN cases hold NaNs (cameras beyond |(cols, rows)|), the others none.
    assert np.isnan(got).any() == (case in ("fractional_effect", "negative_effect"))


@pytest.mark.parametrize("params", ["render_params", "allfocus_params"])
@pytest.mark.parametrize("deployment", list(DEPLOYMENTS))
def test_api_weights_are_fp16_valued_and_equal_the_quantised_loop(deployment, params):
    """What ``lfi.params`` hands the upload: fp16-valued weights equal to
    the benchmark's frozen loop (``lfibench/reference/geometry.py``), which
    its ``correct`` check sums exactly."""
    cols, rows, height, width, focus, focus_range = DEPLOYMENTS[deployment]
    rng = np.random.default_rng(14)
    config = RenderConfig(method="TEN", focus=focus, focus_range=focus_range)
    for _ in range(8):
        traj = _benchmark_trajectory(rng)
        if params == "render_params":
            weights, _ = state.render_params(traj, cols=cols, rows=rows, height=height,
                                             width=width, focus=focus)
        else:
            weights = state.allfocus_params(traj, cols=cols, rows=rows, height=height,
                                            width=width, config=config).weights
        _assert_bits_equal(state.fp16_valued(weights), weights)
        se = frozen_geometry.parse_trajectory(traj, cols, rows)
        _assert_bits_equal(weights, frozen_geometry.weight_matrix(se, cols, rows, 3.0, 64))
