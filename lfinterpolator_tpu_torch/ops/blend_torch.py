"""Plain PyTorch blend path (the "STD" method of the fixed-focus render).

Port of ``lfinterpolator_tpu/ops/blend_xla.py``: the fixed-focus part
(``to_planar``/``from_planar``, ``shift_stack``, ``blend``,
``render_fixed``)

    views[v, c, y, x] = u8(clip(rne(sum_g W[v, g] *
                            img[g, c, clamp(y+dy_g), clamp(x+dx_g)])))

and the all-in-focus part (``allfocus_selected``, ``render_allfocus``),
where each pixel's shift comes from its focus value f = decode[map[y, x]]:

    img[g, c, clamp(trunc(y + f*oy_g)), clamp(trunc(x + f*ox_g))]

Both shifts are one index gather: the JAX package built them from an edge
pad and dynamic slices, and the all-focus select as a scan over the map's
byte levels with a presence skip, because gathers are slow on a TPU
(``blend_xla.py:345-353``). The blend is one f32 ``torch.matmul`` of
``[V, G] @ [G, C*H*W]``. These functions are also the plain versions of
the hand-written kernels in ``ops/shift_blend.py`` and
``ops/allfocus_blend.py``. Image layout is planar ``[G, C, H, W]`` uint8.
"""

from __future__ import annotations

import torch


def to_planar(images: torch.Tensor, channels: int = 3) -> torch.Tensor:
    """[G, H, W, C>=channels] -> [G, channels, H, W] (contiguous)."""
    return images[..., :channels].permute(0, 3, 1, 2).contiguous()


def from_planar(views: torch.Tensor) -> torch.Tensor:
    """[V, C, H, W] -> [V, H, W, C] (contiguous)."""
    return views.permute(0, 2, 3, 1).contiguous()


def shift_stack(images: torch.Tensor, offsets_xy: torch.Tensor) -> torch.Tensor:
    """out[g, c, y, x] = images[g, c, clamp(y+dy_g), clamp(x+dx_g)].

    `offsets_xy` is [G, 2] integer (dx, dy). Shifts beyond the image size
    saturate the clamp; they are clipped to [-W, W] / [-H, H] first, as
    ``blend_xla.shift_axis_clamped`` does, so the index sums cannot overflow.
    """
    g, c, h, w = images.shape
    dev = images.device
    off = offsets_xy.to(device=dev, dtype=torch.int64)
    dx = off[:, 0].clamp(-w, w)
    dy = off[:, 1].clamp(-h, h)
    ys = (torch.arange(h, device=dev)[None, :] + dy[:, None]).clamp_(0, h - 1)
    xs = (torch.arange(w, device=dev)[None, :] + dx[:, None]).clamp_(0, w - 1)
    gi = torch.arange(g, device=dev)[:, None, None, None]
    ci = torch.arange(c, device=dev)[None, :, None, None]
    return images[gi, ci, ys[:, None, :, None], xs[:, None, None, :]]


def blend(shifted: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[G, C, H, W] u8 x [V, G] f32 -> [V, C, H, W] u8.

    f32 accumulation, round half to even, clip, cast (the reference STD
    kernel's __float2int_rn store). TF32 would keep only ~10 mantissa bits
    of the pixel operand, so it is switched off for this product, and the
    caller's setting is restored after it.
    """
    g, c, h, w = shifted.shape
    flat = shifted.reshape(g, c * h * w).to(torch.float32)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = torch.matmul(weights.to(torch.float32), flat)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    del flat
    out = acc.round_().clamp_(0, 255).to(torch.uint8)
    return out.reshape(weights.shape[0], c, h, w)


def render_fixed(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32 (fp16-quantized for parity)
    focused_offsets: torch.Tensor,  # [G, 2] int32 (dx, dy)
) -> torch.Tensor:
    """Fixed-focus render: shift + blend -> [V, C, H, W] uint8."""
    return blend(shift_stack(images, focused_offsets), weights)


def allfocus_selected(
    images: torch.Tensor,  # [G, C, H, W] uint8
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    fmap: torch.Tensor,  # [H, W] uint8 focus map
    decode: torch.Tensor,  # [256] float32 focus value of each byte
) -> torch.Tensor:
    """Every image gathered at its pixel's focus -> [G, C, H, W] uint8.

    The coordinate is the oracle's ``trunc(f32(q) + f32(f*o))``
    (``reference.blend_allfocus``): a rounded product, then a rounded add
    (eager torch rounds each op), truncated toward zero, clamped. One image
    at a time, so the temporaries stay [H, W].
    """
    g, c, h, w = images.shape
    dev = images.device
    f = decode.to(dev)[fmap.to(torch.int64)]  # [H, W] float32
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    off = offsets.to(device=dev, dtype=torch.float32)
    out = torch.empty_like(images)
    for i in range(g):
        cy = torch.trunc(ys + f * off[i, 1]).clamp_(0, h - 1).to(torch.int64)
        cx = torch.trunc(xs + f * off[i, 0]).clamp_(0, w - 1).to(torch.int64)
        out[i] = images[i][:, cy, cx]
    return out


def render_allfocus(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32 (fp16-quantized for parity)
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    fmap: torch.Tensor,  # [H, W] uint8 focus map
    decode: torch.Tensor,  # [256] float32
) -> torch.Tensor:
    """All-in-focus blend: per-pixel-focus select + blend -> [V, C, H, W] uint8."""
    return blend(allfocus_selected(images, offsets, fmap, decode), weights)


def temp_bytes(g: int, v: int, c: int, h: int, w: int) -> int:
    """Device bytes render_fixed holds beyond its input at its peak: the
    shifted u8 stack and its f32 copy beside the f32 product, then the
    product beside the u8 output."""
    n = c * h * w
    return max(5 * g * n + 4 * v * n, g * n + 5 * v * n)
