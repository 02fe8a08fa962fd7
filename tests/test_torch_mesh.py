"""The port's multi-GPU rendering (``lfinterpolator_tpu_torch.parallel``) on
the CPU: gloo ranks against the JAX package's mesh on the 8-device CPU mesh
(``tests/conftest.py``), on its XLA routes, and against the port's own
one-device render.

The ranks run in spawned processes (``tests/_torch_mesh_worker.py``, which
imports no jax): three launches, worlds of 8, 4 and 4, each under a 120 s
limit with a 60 s collective timeout. The cases follow
``tests/test_parallel.py``. Tolerance: equal bytes, views and maps, as the
port on the CPU already is with the JAX package. The (focus, range, steps)
triples stay off half-integer map bytes (ROADMAP Queue 3 item 4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_mesh_worker as worker
from lfinterpolator_tpu.api import Interpolator as JaxInterpolator
from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.core.config import RenderConfig as JaxConfig
from lfinterpolator_tpu.io.loader import LightField as JaxLightField
from lfinterpolator_tpu.ops import blend_xla
from lfinterpolator_tpu.ops import focus as focus_ops
from lfinterpolator_tpu.parallel import mesh as pmesh
from lfinterpolator_tpu_torch.api import Interpolator
from lfinterpolator_tpu_torch.core import capacity
from lfinterpolator_tpu_torch.core.config import RenderConfig
from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.state import allfocus_params, focus_tables

torch.set_num_threads(1)


def _setup(seed=7, cols=2, rows=2, h=32, w=64, v=16):
    """test_parallel._setup's scene."""
    rng = np.random.default_rng(seed)
    g = cols * rows
    images = rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8)
    se = np.array([0.0, 0.0, cols - 1.0, rows - 1.0], np.float32)
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    return images, wm, geometry.focused_offsets(offsets, 0.4).astype(np.int32)


@pytest.fixture(scope="module")
def devices():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual devices (see conftest XLA_FLAGS)")
    return d


@pytest.fixture(scope="module")
def fixed_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_fixed")
    images, wm, fo = _setup()
    np.savez(work / "inputs.npz", images=images, weights=wm, shifts=fo)
    return worker.launch(8, str(work), "fixed")


def _small_lf():
    """conftest.small_lf's scene (its `rng` fixture's seed)."""
    rng = np.random.default_rng(1234)
    cols, rows, h, w = 4, 4, 48, 64
    texture = rng.integers(0, 256, size=(h * 2, w * 2, 3), dtype=np.uint8)
    t = texture.astype(np.float32)
    t = (t + np.roll(t, 1, 0) + np.roll(t, 1, 1) + np.roll(t, 2, 0)) / 4.0
    texture = t.astype(np.uint8)
    images = np.zeros((cols * rows, h, w, 4), dtype=np.uint8)
    for c in range(cols):
        for r in range(rows):
            images[c * rows + r, :, :, :3] = texture[r * 2:r * 2 + h, c * 2:c * 2 + w]
            images[c * rows + r, :, :, 3] = 255
    return images


# test_parallel.test_sharded_all_focus_matches_unsharded's configuration
AF_SE = np.array([0.0, 0.0, 3.0, 3.0], np.float32)
AF_RADIUS, AF_FRAD, AF_STEPS, AF_FOCUS, AF_RANGE = (2, 2), (1, 1), 8, 0.0, 0.5


def _af_params(images):
    h, w = images.shape[1:3]
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(AF_SE, 4, 4, 3.0, 8)).astype(np.float32)
    offsets = geometry.compute_offsets(4, 4, w, h, 1.0, geometry.trajectory_center(AF_SE))
    ids = geometry.select_focus_views(AF_SE, 4, 4, 8)
    return wm, offsets, ids


@pytest.fixture(scope="module")
def allfocus_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_allfocus")
    images = _small_lf()
    wm, offsets, ids = _af_params(images)
    tables = focus_tables(AF_FOCUS, AF_RANGE, AF_STEPS)
    np.savez(work / "inputs.npz", images=images, weights=wm, offsets=offsets, ids=ids,
             candidates=tables.candidates, candidate_bytes=tables.candidate_bytes,
             decode=tables.decode, radius=np.array(AF_RADIUS),
             filter_radius=np.array(AF_FRAD))
    return worker.launch(4, str(work), "allfocus")


def _wide():
    """A 2x2 grid at 96x512: wide enough for the focus pyramid to run."""
    rng = np.random.default_rng(5)
    tex = rng.integers(0, 256, (112, 528, 3), dtype=np.uint8)
    images = np.zeros((4, 96, 512, 4), np.uint8)
    for i in range(4):
        images[i, :, :, :3] = tex[4 * (i % 2):4 * (i % 2) + 96, 4 * (i // 2):4 * (i // 2) + 512]
        images[i, :, :, 3] = 255
    return images


@pytest.fixture(scope="module")
def api_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_api")
    np.savez(work / "inputs.npz", images=_small_lf(), wide=_wide())
    return worker.launch(4, str(work), "api")


# -- world 8: mesh shapes and the fixed-focus render ------------------------


def test_mesh_shapes_and_divisibility(fixed_run, devices):
    shapes = fixed_run["json"]["shapes"]
    assert shapes == {"None": [2, 4], "1": [1, 8], "2": [2, 4], "4": [4, 2], "8": [8, 1]}
    jax_mesh = pmesh.make_mesh(devices)
    assert shapes["None"] == [jax_mesh.shape["view"], jax_mesh.shape["space"]]
    assert fixed_run["json"]["bad_split"] == "8 devices not divisible by view_parallel=3"
    with pytest.raises(ValueError, match=fixed_run["json"]["bad_split"]):
        pmesh.make_mesh(devices, view_parallel=3)


def test_initialize_twice_is_a_noop(fixed_run):
    assert fixed_run["json"]["world_after_second_init"] == 8


def test_local_shard_info(fixed_run):
    from lfinterpolator_tpu.parallel import distributed as jax_distributed

    info = fixed_run["json"]["info"]
    assert set(info) == set(jax_distributed.local_shard_info())
    assert info == {"process_index": 0, "process_count": 8, "local_devices": 1,
                    "global_devices": 8}
    assert fixed_run["json"]["multi_host"] is True


@pytest.mark.parametrize("method", ["STD", "TEN"])
@pytest.mark.parametrize("vp", [1, 2, 4, 8])
def test_render_fixed_sharded_matches_jax(fixed_run, devices, vp, method):
    images, wm, fo = _setup()
    m = pmesh.make_mesh(devices, view_parallel=vp)
    planar = blend_xla.to_planar(jnp.asarray(images))
    imgs_d, w_d = pmesh.shard_inputs(m, planar, jnp.asarray(wm))
    want = pmesh.gather_views(pmesh.render_fixed_sharded(m, imgs_d, w_d, jnp.asarray(fo)))
    got = fixed_run[f"views_{vp}_{method}"]
    np.testing.assert_array_equal(got, want)
    one = Interpolator(LightField(images, 2, 2), progress=False, device="cpu")
    from lfinterpolator_tpu_torch.models import pipeline

    solo = pipeline.render_fixed_focus(one.images, torch.from_numpy(wm),
                                       torch.from_numpy(fo), method=method)
    np.testing.assert_array_equal(got, solo.permute(0, 2, 3, 1).numpy())


def test_render_fixed_sharded_rejects_bad_row_split(fixed_run):
    assert fixed_run["json"]["bad_rows"] == "H=30 must divide by the space axis (4)"


# -- world 4: the all-in-focus render ---------------------------------------


@pytest.mark.parametrize("tag", ["STD", "TEN", "fast"])
def test_render_all_focus_sharded_matches_jax(allfocus_run, devices, tag):
    images = _small_lf()
    h, w = images.shape[1:3]
    wm, offsets, ids = _af_params(images)
    method, exact = {"STD": ("STD", True), "TEN": ("TEN", True),
                     "fast": ("TEN", False)}[tag]
    pad = focus_ops.shift_pad_bound(offsets, AF_FOCUS, AF_RANGE, AF_RADIUS, h, w)
    m = pmesh.make_mesh(devices, view_parallel=2)
    planar = blend_xla.to_planar(jnp.asarray(images))
    imgs_d, w_d = pmesh.shard_inputs(m, planar, jnp.asarray(wm))
    want_views, want_maps = pmesh.render_all_focus_sharded(
        m, imgs_d, w_d, jnp.asarray(offsets), jnp.float32(AF_FOCUS),
        jnp.float32(AF_RANGE), jnp.asarray(ids), method=method, radius=AF_RADIUS,
        filter_radius=AF_FRAD, steps=AF_STEPS, pad=pad, exact_taps=exact,
    )
    np.testing.assert_array_equal(allfocus_run[f"maps_{tag}"], np.asarray(want_maps))
    np.testing.assert_array_equal(allfocus_run[f"views_{tag}"],
                                  pmesh.gather_views(want_views))


# -- world 4: the Interpolator on a mesh ------------------------------------


def _solo(**config):
    return Interpolator(LightField(_small_lf(), 4, 4), progress=False, device="cpu",
                        config=RenderConfig(**config))


CFG = dict(view_count=8, focus_map_views=8, focus_steps=8)


@pytest.mark.parametrize("method", ["STD", "TEN"])
def test_interpolator_mesh_fixed(api_run, method):
    want = _solo(**CFG).interpolate("0,0,1,1", focus=0.3, method=method, progress=False)
    np.testing.assert_array_equal(api_run[f"fixed_{method}"], want.views)


def test_interpolator_mesh_matches_jax_mesh(api_run, devices):
    lf = JaxLightField(_small_lf(), 4, 4)
    cfg = JaxConfig(**CFG)
    sharded = JaxInterpolator(lf, config=cfg, progress=False,
                              mesh=pmesh.make_mesh(devices, view_parallel=2))
    fixed = sharded.interpolate("0,0,1,1", focus=0.3, method="TEN", progress=False)
    np.testing.assert_array_equal(api_run["fixed_TEN"], fixed.views)
    af = sharded.interpolate("0,0,1,1", focus=0.0, focus_range=0.5, method="TEN",
                             progress=False)
    np.testing.assert_array_equal(api_run["af_maps_TEN"], af.maps)
    np.testing.assert_array_equal(api_run["af_views_TEN"], af.views)


@pytest.mark.parametrize("tag", ["STD", "TEN", "fast"])
def test_interpolator_mesh_allfocus(api_run, tag):
    method, exact = {"STD": ("STD", True), "TEN": ("TEN", True),
                     "fast": ("TEN", False)}[tag]
    want = _solo(**CFG, exact_focus_taps=exact).interpolate(
        "0,0,1,1", focus=0.0, focus_range=0.5, method=method, progress=False)
    np.testing.assert_array_equal(api_run[f"af_maps_{tag}"], want.maps)
    np.testing.assert_array_equal(api_run[f"af_views_{tag}"], want.views)


def test_interpolator_mesh_rejects_bad_height(api_run):
    assert api_run["json"]["bad_height"] == (
        "Image height 31 must divide by the mesh space axis (2) for sharded rendering")


def test_interpolator_mesh_rejects_bad_view_count(api_run):
    assert api_run["json"]["bad_views"] == "view_count 7 must divide by the mesh view axis (2)"


@pytest.mark.parametrize("tag", ["fixed", "af"])
def test_interpolate_batch_on_a_mesh(api_run, tag):
    kw = {"focus": 0.3} if tag == "fixed" else {"focus": 0.1, "focus_range": 0.2}
    trajs = ["0,0,1,1", "0.25,0.25,0.75,0.75", "0,0.5,1,0.5"]
    want = _solo(**CFG).interpolate_batch(trajs, progress=False, **kw)
    for i, res in enumerate(want):
        np.testing.assert_array_equal(api_run[f"batch_{tag}_{i}"], res.views)
        if tag == "af":
            np.testing.assert_array_equal(api_run[f"batch_af_maps_{i}"], res.maps)


def test_render_quilt_on_a_mesh_takes_the_two_stage_route(api_run):
    want = _solo(**CFG).render_quilt("0,0,1,1", focus=0.3, method="TEN", cols=4,
                                     rows=2, progress=False)
    assert want.fused and not api_run["json"]["quilt_fused"]
    np.testing.assert_array_equal(api_run["quilt"], want.quilt)


@pytest.mark.parametrize("kind", ["fixed", "allfocus"])
def test_mesh_capacity_check_raises_with_the_mesh_hint(api_run, kind):
    msg = api_run["json"][f"capacity_{kind}"]
    assert "per rank" in msg and msg.endswith(capacity.MESH_HINT)


def test_focus_pyramid_on_a_mesh_runs_the_exact_sweep(api_run):
    config = RenderConfig(view_count=4, focus_map_views=4, focus_steps=8,
                          focus_pyramid=True, focus=0.0, focus_range=0.21)
    assert allfocus_params("0,0,1,1", cols=2, rows=2, height=96, width=512,
                           config=config).pyramid is not None  # it would run alone
    assert api_run["json"]["pyramid_calls"] == 0
    exact = Interpolator(LightField(_wide(), 2, 2), progress=False, device="cpu",
                         config=RenderConfig(view_count=4, focus_map_views=4,
                                             focus_steps=8))
    want = exact.interpolate("0,0,1,1", focus=0.0, focus_range=0.21, method="TEN",
                             progress=False)
    np.testing.assert_array_equal(api_run["pyramid_maps"], want.maps)
    np.testing.assert_array_equal(api_run["pyramid_views"], want.views)


def test_benchmark_runs_on_a_mesh(api_run):
    assert api_run["json"]["run_times"] == 2
