"""Fixed-focus shift + blend: wrapper of the hand-written Hopper kernel.

One CUDA kernel (``csrc/shift_blend.cu``) replaces the JAX package's TEN
route, ``shift_pallas._pshift_kernel`` feeding
``blend_pallas._blend_tiled_kernel`` (or ``_blend_kernel`` on geometries
the padded shift does not take), called from
``blend_pallas.render_fixed_padded``:

    out[v,c,y,x] = u8(clip(rint(sum_g W[v,g] * img[g,c,clamp(y+dy_g),clamp(x+dx_g)])))

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (``shift_blend_reference``, the STD torch ops); a CUDA tensor
launches the kernel, or raises. No path falls back from one to the other.

Numerics: the kernel sums in f32 in ascending g with separately rounded
multiply and add, so with fp16-valued weights (every product exact) it is
bit-equal to the NumPy oracle ``reference.blend_fixed``.
"""

from __future__ import annotations

import torch

from . import blend_torch

#: Kernel launches since import (or since a caller reset it to 0). Counts
#: only launches of the CUDA kernel, never plain-version calls.
launches = 0


def is_available() -> bool:
    """True when a CUDA device is present to launch the kernel on."""
    return torch.cuda.is_available()


def shift_blend_reference(
    images: torch.Tensor, weights: torch.Tensor, shifts: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (any device)."""
    return blend_torch.blend(blend_torch.shift_stack(images, shifts), weights)


def _check(images: torch.Tensor, weights: torch.Tensor, shifts: torch.Tensor):
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


def shift_blend(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32
    shifts: torch.Tensor,  # [G, 2] int32 (dx, dy)
) -> torch.Tensor:
    """Fixed-focus render -> [V, C, H, W] uint8 (kernel on CUDA tensors)."""
    global launches
    _check(images, weights, shifts)
    if images.device.type == "cpu":
        return shift_blend_reference(images, weights, shifts)
    if images.device.type != "cuda":
        raise ValueError(f"shift_blend runs on cpu or cuda, not {images.device}")

    from . import _build

    lib = _build.load()
    g, c, h, w = images.shape
    v = weights.shape[0]
    if g > lib.lfi_shift_blend_max_grid():
        raise ValueError(
            f"the kernel takes at most {lib.lfi_shift_blend_max_grid()} "
            f"grid images, got {g}"
        )
    # Shifts past the image size saturate the clamp; clipping them first
    # keeps y+dy and x+dx inside int32 (blend_xla.shift_axis_clamped).
    clipped = torch.stack(
        [shifts[:, 0].clamp(-w, w), shifts[:, 1].clamp(-h, h)], dim=1
    ).contiguous()
    with torch.cuda.device(images.device):
        out = torch.empty((v, c, h, w), dtype=torch.uint8, device=images.device)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.lfi_shift_blend(
            images.data_ptr(), weights.data_ptr(), clipped.data_ptr(),
            out.data_ptr(), g, c, h, w, v, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lfi_shift_blend launch failed: CUDA error {err} "
            f"({lib.lfi_cuda_error_string(err).decode()})"
        )
    launches += 1
    return out
