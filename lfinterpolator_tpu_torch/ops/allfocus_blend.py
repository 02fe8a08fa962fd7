"""Per-pixel-focus blend: wrapper of the hand-written Hopper kernel.

One CUDA kernel (``csrc/allfocus_blend.cu``) replaces the JAX package's
all-in-focus blend route: ``allfocus_pallas._af_kernel`` selecting every
image by its pixel's focus, feeding the ``blend_pallas._blend_tiled_kernel``
contraction (``allfocus_pallas.render_allfocus_quantized_fused``):

    f = decode[map[y, x]]
    out[v,c,y,x] = u8(clip(rint(sum_g W[v,g] *
                   img[g, c, clamp(trunc(y + f*oy_g)), clamp(trunc(x + f*ox_g))])))

A launch may render a block of rows, ``row_start`` and ``row_count`` (one
rank's rows of a multi-GPU render): the map is then that block's ``[hb, W]``
rows, the coordinates the frame's, and the output ``[V, C, hb, W]``,
bit-equal to the same rows of the whole-frame launch. The defaults render
the frame.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (``blend_torch.render_allfocus``); a CUDA tensor launches the
kernel, or raises. No path falls back from one to the other.

Precondition: fp16-valued weights, as ``ops/shift_blend.py`` states it
(checked where a weight matrix is uploaded, ``state.fp16_valued``).

Numerics: the coordinate rule of ``reference.blend_allfocus``, so the
select is bit-exact; the sum runs on the tensor cores (fp16 operands, f32
sums, g in ascending steps of 16) and obeys the near-tie rule
(``blend_torch.check_bytes``): the byte is ``clip(rint(exact sum))``
wherever the exact sum is further than 2^-8 from a half-integer, else one
of the two neighbours -- at most 1 LSB from that oracle and the plain
version, and independent of the other rows of the weight matrix.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import _build, blend_torch

allfocus_blend_reference = blend_torch.render_allfocus


def _check(images, weights, offsets, fmap, decode, row_start, row_count):
    """Raise ValueError unless the operands fit; -> the row block (r0, hb)."""
    if images.dtype != torch.uint8 or images.dim() != 4:
        raise ValueError(
            f"images must be [G, C, H, W] uint8, got {tuple(images.shape)} "
            f"{images.dtype}"
        )
    g, c, h, w = images.shape
    r0, hb = blend_torch.row_block(h, row_start, row_count)
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
    if fmap.dtype != torch.uint8 or tuple(fmap.shape) != (hb, w):
        raise ValueError(
            f"the focus map must be [{hb}, {w}] uint8, got "
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
    return r0, hb


def allfocus_blend(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32, fp16-valued
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    fmap: torch.Tensor,  # [hb, W] uint8 focus map of the block's rows
    decode: torch.Tensor,  # [256] float32 focus value of each byte
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """All-in-focus render of rows [row_start, row_start + row_count) ->
    [V, C, hb, W] uint8 (kernel on CUDA tensors; the defaults: the frame).
    The weights must be fp16-valued (see the module's docstring). A launch
    counts as ``allfocus_blend`` (``profiling.launch_counts``)."""
    r0, hb = _check(images, weights, offsets, fmap, decode, row_start, row_count)
    if images.device.type == "cpu":
        return allfocus_blend_reference(images, weights, offsets, fmap, decode, r0, hb)
    if images.device.type != "cuda":
        raise ValueError(f"allfocus_blend runs on cpu or cuda, not {images.device}")

    lib = _build.load()
    g, c, h, w = images.shape
    v = weights.shape[0]
    if g > lib.lfi_allfocus_blend_max_grid():
        raise ValueError(
            f"the kernel takes at most {lib.lfi_allfocus_blend_max_grid()} "
            f"grid images, got {g}"
        )
    out = torch.empty((v, c, hb, w), dtype=torch.uint8, device=images.device)
    _build.launch("lfi_allfocus_blend", images.device, images.data_ptr(),
                  weights.data_ptr(), offsets.data_ptr(), fmap.data_ptr(),
                  decode.data_ptr(), out.data_ptr(), g, c, h, w, v, r0, hb)
    profiling.count("allfocus_blend")
    return out
