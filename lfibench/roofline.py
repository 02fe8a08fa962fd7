"""The least time the card could take for each kernel's work, from shapes.

Each count says what the inputs need, not what today's kernels do, so it
stays the same whatever implements a kernel: each input byte is read once
and each output byte written once, and the operations are those the
arithmetic needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): HBM3 at 3.35 TB/s; fp16 on the tensor cores at 989
TFLOP/s. The integer rate outside the tensor cores, where a min/max runs,
is derived, not published: the sheet's 67 TFLOP/s of float32 are 2 flops
of a fused multiply-add on each of an SM's 128 lanes, and 64 of those lanes
take integer instructions, so 67e12 / 2 / 2 = 16.75e12 integer operations
a second.
"""

from __future__ import annotations

# the search stencil's spacing sets the frame the estimate extends to
from lfibench.reference.geometry import block_radius

HBM_BYTES_PER_S = 3.35e12
FP16_TENSOR_FLOPS = 989e12
INT32_OPS_PER_S = 67e12 / 2 * 64 / 128


def bound_s(nbytes: float, ops: float, rate: float) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the peak `rate` of their kind."""
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)


def blend_counts(g: int, v: int, c: int, h: int, w: int) -> tuple[int, int]:
    """(bytes, multiply-adds) of one fixed-focus blend (``shift_blend``):
    the u8 stack [G, C, H, W] read and the views [V, C, H, W] written once,
    the float32 weights [V, G] and the int32 shifts [G, 2]; a multiply-add
    per view, image and output byte."""
    n = c * h * w
    return g * n + v * n + 4 * v * g + 8 * g, v * g * n


def allfocus_blend_counts(g: int, v: int, c: int, h: int, w: int) -> tuple[int, int]:
    """(bytes, multiply-adds) of one all-in-focus blend: the fixed blend's,
    the float32 offsets in place of the shifts (the same bytes), and the u8
    map [H, W] with its 256-entry float32 decode table."""
    nbytes, macs = blend_counts(g, v, c, h, w)
    return nbytes + h * w + 4 * 256, macs


def estimate_counts(k: int, s: int, h: int, w: int,
                    radius: tuple[int, int]) -> tuple[int, int]:
    """(bytes, min/max operations) of one exact focus estimate of K views
    and S candidates. Operations: for each candidate, a min and a max per
    view over each pixel of the frame extended by the radius, on one 32-bit
    word of a pixel's channels (the integer lanes take four bytes at a time:
    ``__vminu4``). Bytes: those words of the K views (RGB padded to a word,
    the 4-byte "RGBx" copy), read once, and the map [H, W] written once."""
    rx, ry = radius
    return 4 * k * h * w + h * w, 2 * k * s * (h + 2 * ry) * (w + 2 * rx)


def blend_bound_s(g, v, c, h, w) -> float:
    nbytes, macs = blend_counts(g, v, c, h, w)
    return bound_s(nbytes, 2 * macs, FP16_TENSOR_FLOPS)


def allfocus_blend_bound_s(g, v, c, h, w) -> float:
    nbytes, macs = allfocus_blend_counts(g, v, c, h, w)
    return bound_s(nbytes, 2 * macs, FP16_TENSOR_FLOPS)


def estimate_bound_s(k, s, h, w, radius) -> float:
    nbytes, ops = estimate_counts(k, s, h, w, radius)
    return bound_s(nbytes, ops, INT32_OPS_PER_S)


def frame_bound_s(config: dict, allfocus: bool) -> float:
    """The least time of one frame's kernel work in a configuration: the
    blend, and all in focus the estimate before it."""
    g, v = config["cols"] * config["rows"], config["views"]
    h, w = config["height"], config["width"]
    if not allfocus:
        return blend_bound_s(g, v, 3, h, w)
    radius = block_radius(w, h, config["pixel_size_factor"])
    return (estimate_bound_s(config["focus_map_views"], config["focus_steps"], h, w, radius)
            + allfocus_blend_bound_s(g, v, 3, h, w))
