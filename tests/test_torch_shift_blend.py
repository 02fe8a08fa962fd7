"""The shift+blend kernel's wrapper (lfinterpolator_tpu_torch/ops/shift_blend.py)
against the JAX package's Pallas kernels and the NumPy oracle.

On the CPU the wrapper runs its plain version, which is tested here:
  * the shift against shift_pallas.shift_padded_4d (_pshift_kernel, Pallas
    interpret mode): bit-equal, since both are pure data movement;
  * the render against blend_pallas.render_fixed_padded (interpret mode):
    within 1 LSB, the JAX kernel's own stated class (blend_pallas.py:261-270:
    its kron(W, I2) contraction may reorder the f32 sum);
  * the render against reference.blend_fixed: bit-equal.
The CUDA kernel itself is compared with the plain version and the oracle
in tests/test_torch_cuda.py, which imports no jax so that it runs on a GPU
host without it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.ops import blend_pallas, reference, shift_pallas
from lfinterpolator_tpu_torch.ops import blend_torch, shift_blend
from lfinterpolator_tpu_torch.state import to_device_state

torch.set_num_threads(1)

# (cols, rows, H, W, V)
SCENES = [
    (1, 1, 48, 64, 1),
    (3, 5, 45, 70, 7),
    (4, 4, 48, 64, 64),
]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("LFI_PALLAS_INTERPRET", "1")


def _scene(cols, rows, h, w, v, focus, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)
    se = geometry.parse_trajectory("0,0,1,1", (cols, rows))
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    return images, wm, offsets, geometry.focused_offsets(offsets, focus)


def _ids(s):
    return f"{s[0]}x{s[1]}_{s[2]}x{s[3]}_v{s[4]}"


FOCI = [0.25, -0.6, 4.0]  # the last pushes shifts past the image


@pytest.mark.parametrize("focus", FOCI)
@pytest.mark.parametrize("scene", SCENES, ids=_ids)
def test_shift_matches_pshift_kernel(scene, focus, interpret):
    cols, rows, h, w, v = scene
    images, _, offsets, fo = _scene(*scene, focus)
    planar = np.ascontiguousarray(images[..., :3].transpose(0, 3, 1, 2))
    px, py = blend_pallas.shift_bound(offsets, focus, h, w)
    assert shift_pallas.supports_padded(h, w)
    padded = blend_pallas.pad_images(jnp.asarray(planar), px, py)
    want = np.asarray(shift_pallas.shift_padded_4d(
        padded, jnp.asarray(fo), h=h, w=w, px=px, py=py
    ))[:, :, :h, :w]
    got = blend_torch.shift_stack(torch.from_numpy(planar), torch.from_numpy(fo))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("focus", FOCI)
@pytest.mark.parametrize("scene", SCENES, ids=_ids)
def test_render_matches_render_fixed_padded_and_oracle(scene, focus, interpret):
    cols, rows, h, w, v = scene
    images, wm, offsets, fo = _scene(*scene, focus)
    x, wts, sh = to_device_state(images, wm, fo, "cpu")
    got = shift_blend.shift_blend(x, wts, sh).numpy()

    px, py = blend_pallas.shift_bound(offsets, focus, h, w)
    padded = blend_pallas.pad_images(jnp.asarray(x.numpy()), px, py)
    want = np.asarray(blend_pallas.render_fixed_padded(
        padded, jnp.asarray(wts.numpy()), jnp.asarray(fo), h=h, w=w, px=px, py=py
    ))
    assert got.shape == want.shape == (v, 3, h, w)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        got.transpose(0, 2, 3, 1), reference.blend_fixed(images, wm, fo)
    )


def test_cpu_tensors_never_launch_the_kernel():
    images, wm, _, fo = _scene(4, 4, 48, 64, 8, 0.3)
    before = shift_blend.launches
    out = shift_blend.shift_blend(*to_device_state(images, wm, fo, "cpu"))
    assert shift_blend.launches == before
    assert out.device.type == "cpu" and out.dtype == torch.uint8


def test_plain_version_is_the_std_path():
    images, wm, _, fo = _scene(3, 5, 45, 70, 7, -0.6)
    args = to_device_state(images, wm, fo, "cpu")
    assert torch.equal(
        shift_blend.shift_blend_reference(*args), blend_torch.render_fixed(*args)
    )


@pytest.mark.parametrize(
    "bad",
    ["images_dtype", "weights_dtype", "weights_width", "shifts_dtype",
     "shifts_shape", "noncontiguous", "images_rank"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    images, wm, _, fo = _scene(4, 4, 48, 64, 8, 0.3)
    x, w, s = to_device_state(images, wm, fo, "cpu")
    if bad == "images_dtype":
        x = x.to(torch.int16)
    elif bad == "weights_dtype":
        w = w.to(torch.float16)
    elif bad == "weights_width":
        w = w[:, :5].contiguous()
    elif bad == "shifts_dtype":
        s = s.to(torch.int64)
    elif bad == "shifts_shape":
        s = s[:3]
    elif bad == "noncontiguous":
        x = x.transpose(2, 3)
    elif bad == "images_rank":
        x = x[0]
    with pytest.raises(ValueError):
        shift_blend.shift_blend(x, w, s)
