"""Fixed-focus shift + blend: wrapper of the hand-written Hopper kernel.

One CUDA kernel (``csrc/shift_blend.cu``) replaces the JAX package's TEN
route, ``shift_pallas._pshift_kernel`` feeding
``blend_pallas._blend_tiled_kernel`` (or ``_blend_kernel`` on geometries
the padded shift does not take), called from
``blend_pallas.render_fixed_padded``:

    out[v,c,y,x] = u8(clip(rint(sum_g W[v,g] * img[g,c,clamp(y+dy_g),clamp(x+dx_g)])))

A launch may render a block of rows, ``row_start`` and ``row_count`` (one
rank's rows of a multi-GPU render): the kernel then computes only those
rows, with the frame's coordinates, into ``[V, C, hb, W]``, bit-equal to the
same rows of the whole-frame launch. The defaults render the frame.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (``shift_blend_reference``, the STD torch ops); a CUDA tensor
launches the kernel, or raises. No path falls back from one to the other.

Precondition: fp16-valued weights. The kernel contracts on the tensor
cores with fp16 operands; u8 pixels and weights that float16 holds exactly
make every product exact. ``state.upload_params``/``upload_allfocus`` check
each weight matrix where it is uploaded (``state.fp16_valued``, NumPy, no
device sync) and raise ``ValueError`` otherwise; a caller that builds its
own tensors quantizes them first (``geometry.quantize_weights_f16``).

Numerics: f32 sums on the tensor cores, g in ascending steps of 16, round
half to even, clip, cast. The tensor cores add inside a step in their own
order, so the kernel is not bit-equal to a sequential sum. It obeys the
near-tie rule (``blend_torch.check_bytes``): where the exact sum lies
further than 2^-8 from a half-integer the byte is ``clip(rint(sum))``
exactly, elsewhere one of the two neighbouring bytes -- at most 1 LSB from
the NumPy oracle ``reference.blend_fixed`` and the plain version. A byte
does not depend on the other rows of the weight matrix: a batch or chunk
of views is bit-equal to the same rows of one pass.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import _build, blend_torch


def shift_blend_reference(
    images: torch.Tensor, weights: torch.Tensor, shifts: torch.Tensor,
    row_start: int = 0, row_count: int | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (any device)."""
    return blend_torch.render_fixed(images, weights, shifts, row_start, row_count)


def check_operands(images: torch.Tensor, weights: torch.Tensor,
                   shifts: torch.Tensor) -> None:
    if images.dtype != torch.uint8 or images.dim() != 4:
        raise ValueError(
            f"images must be [G, C, H, W] uint8, got {tuple(images.shape)} "
            f"{images.dtype}"
        )
    g, c, h, w = images.shape
    if weights.dtype != torch.float32 or weights.dim() != 2 or weights.shape[1] != g:
        raise ValueError(
            f"weights must be [V, {g}] float32, got {tuple(weights.shape)} "
            f"{weights.dtype}"
        )
    if shifts.dtype != torch.int32 or tuple(shifts.shape) != (g, 2):
        raise ValueError(
            f"shifts must be [{g}, 2] int32 (dx, dy), got "
            f"{tuple(shifts.shape)} {shifts.dtype}"
        )
    if min(g, c, h, w, weights.shape[0]) < 1:
        raise ValueError(f"empty operand: images {tuple(images.shape)}, "
                         f"weights {tuple(weights.shape)}")
    if not (images.device == weights.device == shifts.device):
        raise ValueError(
            f"operands on different devices: images {images.device}, "
            f"weights {weights.device}, shifts {shifts.device}"
        )
    if not (images.is_contiguous() and weights.is_contiguous()
            and shifts.is_contiguous()):
        raise ValueError("shift_blend needs contiguous operands")


def clip_shifts(shifts: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[G, 2] (dx, dy) clipped to [-w, w] x [-h, h]: shifts past the image
    size saturate the clamp, and clipping them first keeps y+dy and x+dx
    inside int32 (blend_xla.shift_axis_clamped)."""
    return torch.stack(
        [shifts[:, 0].clamp(-w, w), shifts[:, 1].clamp(-h, h)], dim=1
    ).contiguous()


def shift_blend(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32, fp16-valued
    shifts: torch.Tensor,  # [G, 2] int32 (dx, dy)
    *,
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """Fixed-focus render of rows [row_start, row_start + row_count) ->
    [V, C, hb, W] uint8 (kernel on CUDA tensors; the defaults: the frame).
    The weights must be fp16-valued (see the module's docstring). A launch
    counts as ``shift_blend`` (``profiling.launch_counts``)."""
    check_operands(images, weights, shifts)
    r0, hb = blend_torch.row_block(images.shape[2], row_start, row_count)
    if images.device.type == "cpu":
        return shift_blend_reference(images, weights, shifts, r0, hb)
    if images.device.type != "cuda":
        raise ValueError(f"shift_blend runs on cpu or cuda, not {images.device}")

    lib = _build.load()
    g, c, h, w = images.shape
    v = weights.shape[0]
    if g > lib.lfi_shift_blend_max_grid():
        raise ValueError(
            f"the kernel takes at most {lib.lfi_shift_blend_max_grid()} "
            f"grid images, got {g}"
        )
    clipped = clip_shifts(shifts, h, w)
    out = torch.empty((v, c, hb, w), dtype=torch.uint8, device=images.device)
    _build.launch("lfi_shift_blend", images.device, images.data_ptr(),
                  weights.data_ptr(), clipped.data_ptr(), out.data_ptr(),
                  g, c, h, w, v, r0, hb)
    profiling.count("shift_blend")
    return out
