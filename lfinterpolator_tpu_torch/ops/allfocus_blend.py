"""Per-pixel-focus blend: wrapper of the hand-written Hopper kernel.

One CUDA kernel (``csrc/allfocus_blend.cu``) replaces the JAX package's
all-in-focus blend route: ``allfocus_pallas._af_kernel`` selecting every
image by its pixel's focus, feeding the ``blend_pallas._blend_tiled_kernel``
contraction (``allfocus_pallas.render_allfocus_quantized_fused``):

    f = decode[map[y, x]]
    out[v,c,y,x] = u8(clip(rint(sum_g W[v,g] *
                   img[g, c, clamp(trunc(y + f*oy_g)), clamp(trunc(x + f*ox_g))])))

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (``blend_torch.render_allfocus``); a CUDA tensor launches the
kernel, or raises. No path falls back from one to the other.

Numerics: the coordinate rule and the f32 sum in ascending g of
``reference.blend_allfocus``, so with fp16-valued weights the kernel is
bit-equal to that oracle.
"""

from __future__ import annotations

import torch

from . import blend_torch

#: Kernel launches since import (or since a caller reset it to 0). Counts
#: only launches of the CUDA kernel, never plain-version calls.
launches = 0

allfocus_blend_reference = blend_torch.render_allfocus


def _check(images, weights, offsets, fmap, decode):
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
    if offsets.dtype != torch.float32 or tuple(offsets.shape) != (g, 2):
        raise ValueError(
            f"offsets must be [{g}, 2] float32 (x, y), got "
            f"{tuple(offsets.shape)} {offsets.dtype}"
        )
    if fmap.dtype != torch.uint8 or tuple(fmap.shape) != (h, w):
        raise ValueError(
            f"the focus map must be [{h}, {w}] uint8, got "
            f"{tuple(fmap.shape)} {fmap.dtype}"
        )
    if decode.dtype != torch.float32 or tuple(decode.shape) != (256,):
        raise ValueError(
            f"decode must be [256] float32, got {tuple(decode.shape)} "
            f"{decode.dtype}"
        )
    if min(g, c, h, w, weights.shape[0]) < 1:
        raise ValueError(f"empty operand: images {tuple(images.shape)}, "
                         f"weights {tuple(weights.shape)}")
    devices = {t.device for t in (images, weights, offsets, fmap, decode)}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (images, weights, offsets, fmap, decode)):
        raise ValueError("allfocus_blend needs contiguous operands")


def allfocus_blend(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    fmap: torch.Tensor,  # [H, W] uint8 focus map
    decode: torch.Tensor,  # [256] float32 focus value of each byte
) -> torch.Tensor:
    """All-in-focus render -> [V, C, H, W] uint8 (kernel on CUDA tensors)."""
    global launches
    _check(images, weights, offsets, fmap, decode)
    if images.device.type == "cpu":
        return allfocus_blend_reference(images, weights, offsets, fmap, decode)
    if images.device.type != "cuda":
        raise ValueError(f"allfocus_blend runs on cpu or cuda, not {images.device}")

    from . import _build

    lib = _build.load()
    g, c, h, w = images.shape
    v = weights.shape[0]
    if g > lib.lfi_allfocus_blend_max_grid():
        raise ValueError(
            f"the kernel takes at most {lib.lfi_allfocus_blend_max_grid()} "
            f"grid images, got {g}"
        )
    with torch.cuda.device(images.device):
        out = torch.empty((v, c, h, w), dtype=torch.uint8, device=images.device)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.lfi_allfocus_blend(
            images.data_ptr(), weights.data_ptr(), offsets.data_ptr(),
            fmap.data_ptr(), decode.data_ptr(), out.data_ptr(),
            g, c, h, w, v, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lfi_allfocus_blend launch failed: CUDA error {err} "
            f"({lib.lfi_cuda_error_string(err).decode()})"
        )
    launches += 1
    return out
