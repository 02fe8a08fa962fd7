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

Every render takes a block of rows, ``row_start`` and ``row_count`` (one
rank's rows of a multi-GPU render, ``parallel/mesh.py``): it computes only
rows [row_start, row_start + row_count) of the frame, with the frame's
coordinates and the clamp against the full H, so a block is equal to the
same rows of the whole frame. The defaults render the whole frame.
"""

from __future__ import annotations

import torch


def to_planar(images: torch.Tensor, channels: int = 3) -> torch.Tensor:
    """[G, H, W, C>=channels] -> [G, channels, H, W] (contiguous)."""
    return images[..., :channels].permute(0, 3, 1, 2).contiguous()


def from_planar(views: torch.Tensor) -> torch.Tensor:
    """[V, C, H, W] -> [V, H, W, C] (contiguous)."""
    return views.permute(0, 2, 3, 1).contiguous()


def row_block(h: int, row_start: int = 0, row_count: int | None = None) -> tuple[int, int]:
    """-> (r0, hb): the block [r0, r0 + hb) of `h` rows; `row_count` None
    is every row from `row_start` on. Raises ValueError unless the block is
    a non-empty part of the frame."""
    r0 = int(row_start)
    hb = h - r0 if row_count is None else int(row_count)
    if r0 < 0 or hb < 1 or r0 + hb > h:
        raise ValueError(
            f"row block [{r0}, {r0 + hb}) is not a non-empty block of the "
            f"{h} rows")
    return r0, hb


def shift_stack(images: torch.Tensor, offsets_xy: torch.Tensor,
                row_start: int = 0, row_count: int | None = None) -> torch.Tensor:
    """out[g, c, y - r0, x] = images[g, c, clamp(y+dy_g), clamp(x+dx_g)]
    for the rows y of the block (module docstring) -> [G, C, hb, W].

    `offsets_xy` is [G, 2] integer (dx, dy). Shifts beyond the image size
    saturate the clamp; they are clipped to [-W, W] / [-H, H] first, as
    ``blend_xla.shift_axis_clamped`` does, so the index sums cannot overflow.
    """
    g, c, h, w = images.shape
    r0, hb = row_block(h, row_start, row_count)
    dev = images.device
    off = offsets_xy.to(device=dev, dtype=torch.int64)
    dx = off[:, 0].clamp(-w, w)
    dy = off[:, 1].clamp(-h, h)
    ys = (torch.arange(r0, r0 + hb, device=dev)[None, :] + dy[:, None]).clamp_(0, h - 1)
    xs = (torch.arange(w, device=dev)[None, :] + dx[:, None]).clamp_(0, w - 1)
    gi = torch.arange(g, device=dev)[:, None, None, None]
    ci = torch.arange(c, device=dev)[None, :, None, None]
    return images[gi, ci, ys[:, None, :, None], xs[:, None, None, :]]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` of two float32 operands in full float32. TF32 would
    keep only ~10 mantissa bits of an operand, so it is switched off for
    this product, and the caller's setting is restored after it."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def blend(shifted: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[G, C, H, W] u8 x [V, G] f32 -> [V, C, H, W] u8.

    f32 accumulation (``matmul_f32``), round half to even, clip, cast (the
    reference STD kernel's __float2int_rn store).
    """
    g, c, h, w = shifted.shape
    flat = shifted.reshape(g, c * h * w).to(torch.float32)
    acc = matmul_f32(weights.to(torch.float32), flat)
    del flat
    out = acc.round_().clamp_(0, 255).to(torch.uint8)
    return out.reshape(weights.shape[0], c, h, w)


def render_fixed(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32 (fp16-quantized for parity)
    focused_offsets: torch.Tensor,  # [G, 2] int32 (dx, dy)
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """Fixed-focus render of a block of rows: shift + blend -> [V, C, hb, W]
    uint8."""
    return blend(shift_stack(images, focused_offsets, row_start, row_count), weights)


def allfocus_selected(
    images: torch.Tensor,  # [G, C, H, W] uint8
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    fmap: torch.Tensor,  # [hb, W] uint8 focus map of the block's rows
    decode: torch.Tensor,  # [256] float32 focus value of each byte
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """Every image gathered at its pixel's focus, for the rows of the block
    (module docstring) -> [G, C, hb, W] uint8.

    The coordinate is the oracle's ``trunc(f32(q) + f32(f*o))``
    (``reference.blend_allfocus``): a rounded product, then a rounded add
    (eager torch rounds each op), truncated toward zero, clamped. One image
    at a time, so the temporaries stay [hb, W].
    """
    g, c, h, w = images.shape
    r0, hb = row_block(h, row_start, row_count)
    if tuple(fmap.shape) != (hb, w):
        raise ValueError(f"the map of rows [{r0}, {r0 + hb}) must be [{hb}, {w}], "
                         f"got {tuple(fmap.shape)}")
    dev = images.device
    f = decode.to(dev)[fmap.to(torch.int64)]  # [hb, W] float32
    ys = torch.arange(r0, r0 + hb, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    off = offsets.to(device=dev, dtype=torch.float32)
    out = torch.empty((g, c, hb, w), dtype=images.dtype, device=dev)
    for i in range(g):
        cy = torch.trunc(ys + f * off[i, 1]).clamp_(0, h - 1).to(torch.int64)
        cx = torch.trunc(xs + f * off[i, 0]).clamp_(0, w - 1).to(torch.int64)
        out[i] = images[i][:, cy, cx]
    return out


def render_allfocus(
    images: torch.Tensor,  # [G, C, H, W] uint8
    weights: torch.Tensor,  # [V, G] float32 (fp16-quantized for parity)
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    fmap: torch.Tensor,  # [hb, W] uint8 focus map of the block's rows
    decode: torch.Tensor,  # [256] float32
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """All-in-focus blend of a block of rows: per-pixel-focus select +
    blend -> [V, C, hb, W] uint8."""
    return blend(allfocus_selected(images, offsets, fmap, decode, row_start,
                                   row_count), weights)


#: Largest grid the blend kernels take (``csrc/lfi_common.cuh``'s
#: kMaxGrid, which the kernels report through ``lfi_*_max_grid()``): the
#: near-tie argument (``check_bytes``) is made up to it.
MAX_GRID = 512
#: The near-tie band around each half-integer.
BAND = 2.0 ** -8


def f32_sum_error_bound(g: int) -> float:
    """The most a float32 sum of `g` blend products can differ from their
    exact sum, whatever the order of the additions.

    A product of a u8 pixel and an fp16-valued weight is exact in float32
    (8 + 11 significant bits). A render's weights are >= 0 and sum to 1
    within fp16 rounding (< 1 + 2^-10), so every partial sum, in any order,
    lies in [0, 256), where float32's ulp is at most 2^-16. Whatever the
    order (sequential, BLAS blocks, fused multiply-adds, a split reduction),
    the sum is g - 1 additions of exact or already rounded values, each
    rounded once to the nearest: at most half an ulp, 2^-17, each."""
    return (g - 1) * 2.0 ** -17


def exact_sums(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[G, ...] u8 x [V, G] fp16-valued -> [V, ...] float64: the sums over g
    of ``weights[v, g] * stack[g]`` that a blend rounds to bytes, `stack`
    being the shifted or selected images (``shift_stack``,
    ``allfocus_selected``) or a part of them (one channel, a block of rows).

    Every product of a u8 and an fp16 weight <= 1 is a multiple of 2^-24
    (fp16's least step) below 2^8, 32 bits wide; a sum of up to 2^21 of
    them (the kernels take at most ``MAX_GRID``) needs at most 53 bits, so
    float64 holds each product and partial sum exactly, in any order. This
    is the yardstick ``check_bytes`` holds a blend's bytes against. The
    result is 8 bytes per output byte: at full size, call it per channel.
    """
    g = stack.shape[0]
    acc = torch.matmul(weights.to(torch.float64),
                       stack.reshape(g, -1).to(torch.float64))
    return acc.reshape(weights.shape[0], *stack.shape[1:])


def check_bytes(got: torch.Tensor, sums: torch.Tensor,
                band: float = BAND) -> dict[str, int]:
    """The near-tie rule: raise ``AssertionError`` unless the bytes `got`
    are a correct rounding of the exact `sums` (same shape, float64).

    Where a sum lies further than `band` from a half-integer, the byte must
    equal ``clip(rint(sum), 0, 255)`` exactly; inside the band it may be
    either of the two neighbouring bytes ``clip(floor(sum))`` and
    ``clip(floor(sum) + 1)``. Why every sound blend of up to ``MAX_GRID``
    images obeys it: a float32 sum of G products errs by at most
    ``f32_sum_error_bound(G)`` = (G - 1) 2^-17, 3.9e-3 - 2^-17 at G = 512,
    under the band 2^-8 = 3.9e-3 (the plain version's ``torch.matmul`` and
    the NumPy oracle's sequential sum alike); the kernels' tensor-core sums
    err by less than 6.5 2^-16 a step of 16 images, 3.2e-3 at G = 512
    (``csrc/lfi_common.cuh``). A sum further than the band from a
    half-integer then rounds to the same byte as the exact one, while a
    wrong operand, a dropped term or another rounding mode does not.

    -> {"bytes": all, "lax": those inside the band, "ties_off": those
    inside the band that differ from clip(rint(sum))}. The error names the
    first offending index.
    """
    if got.shape != sums.shape or got.dtype != torch.uint8:
        raise ValueError(f"got {tuple(got.shape)} {got.dtype} against sums "
                         f"{tuple(sums.shape)}")
    sums = sums.to(torch.float64)
    low = torch.floor(sums)
    lax = ((sums - low) - 0.5).abs() <= band
    byte = got.to(torch.float64)
    exact = byte == torch.round(sums).clamp_(0, 255)
    near = (byte == low.clamp(0, 255)) | (byte == (low + 1).clamp_(0, 255))
    bad = ~torch.where(lax, near, exact)
    if bool(bad.any()):
        idx = tuple(int(i) for i in bad.nonzero()[0])
        raise AssertionError(
            f"{int(bad.sum())} of {got.numel()} bytes break the near-tie rule "
            f"(band {band}); first at {idx}: byte {int(got[idx])}, exact sum "
            f"{float(sums[idx])!r}"
        )
    return {"bytes": got.numel(), "lax": int(lax.sum()),
            "ties_off": int((lax & ~exact).sum())}


def temp_bytes(g: int, v: int, c: int, h: int, w: int) -> int:
    """Device bytes render_fixed holds beyond its input at its peak: the
    shifted u8 stack and its f32 copy beside the f32 product, then the
    product beside the u8 output."""
    n = c * h * w
    return max(5 * g * n + 4 * v * n, g * n + 5 * v * n)
