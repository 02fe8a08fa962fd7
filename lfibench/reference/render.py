"""The plain reference of a render, in PyTorch, and the comparison that
decides ``correct``.

The semantics of the original tool's kernels (ichlubna/lfInterpolator
src/kernels.cu), written out with plain torch operations so that they run
on the card at the timed sizes. Nothing here comes from the program under
test: the weights, offsets, focus views, candidates and byte tables are
worked out again from the trajectory and focus (``geometry.py``), and the
scene is the benchmark's own.

  * fixed focus: image g read at ``clamp(q + round(focus * offset_g))``;
  * all in focus: the disparity search -- for each candidate f in order,
    the sum over a 3x3 stencil (spacing = the block radius) of
    ``max_c(max_k - min_k)`` over the focus views, each tap of view k at
    ``clamp(trunc(f32(q) + f32(f * o_k)) + s)``; the first strict minimum
    wins -- then the map's asymmetric box filter, and image g read at
    ``clamp(trunc(f32(q) + f32(decode[map] * o_g)))``; TEN blends with the
    raw map, STD with the filtered one (the original's asymmetry);
  * a view's byte is the sum over g of ``weight[v, g] * pixel``: with
    fp16-valued weights every product and sum is exact in float64, and the
    byte is held to those exact sums by the near-tie rule (``rule_breaks``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry

#: The near-tie band: a sum within it of a half-integer may round either way.
#: A float32 sum of up to 256 products of a byte and a weight <= 1 errs by
#: less than 2^-9, so every sound float32 blend obeys the rule.
BAND = 2.0 ** -8


def rule_breaks(got: torch.Tensor, sums: torch.Tensor, band: float = BAND) -> int:
    """The bytes `got` (uint8) that are no correct rounding of the exact
    `sums` (float64, same shape): outside the band around a half-integer a
    byte must be ``clip(rint(sum))``; inside it, either neighbour."""
    if got.shape != sums.shape:
        raise ValueError(f"got {tuple(got.shape)} against sums {tuple(sums.shape)}")
    low = torch.floor(sums)
    lax = ((sums - low) - 0.5).abs() <= band
    byte = got.to(torch.float64)
    exact = byte == torch.round(sums).clamp(0, 255)
    near = (byte == low.clamp(0, 255)) | (byte == (low + 1).clamp(0, 255))
    return int((~torch.where(lax, near, exact)).sum())


def _sums(stack: torch.Tensor, wm: torch.Tensor, c: int) -> torch.Tensor:
    """[G, C, H, W] u8 x [V, G] float64 -> channel c's sums [V, H, W] float64."""
    g, _, h, w = stack.shape
    return (wm @ stack[:, c].reshape(g, -1).to(torch.float64)).reshape(-1, h, w)


def fixed_stack(planar: torch.Tensor, shifts: np.ndarray) -> torch.Tensor:
    """[G, C, H, W] u8: image g read at the clamped integer shift (dx, dy)."""
    g, _, h, w = planar.shape
    dev = planar.device
    out = torch.empty_like(planar)
    for i in range(g):
        rows = (torch.arange(h, device=dev) + int(shifts[i, 1])).clamp_(0, h - 1)
        cols = (torch.arange(w, device=dev) + int(shifts[i, 0])).clamp_(0, w - 1)
        out[i] = planar[i][:, rows][:, :, cols]
    return out


def allfocus_stack(planar: torch.Tensor, off: np.ndarray, fvals: torch.Tensor,
                   fdt: torch.dtype = torch.float32) -> torch.Tensor:
    """[G, C, H, W] u8: image g read at ``clamp(trunc(q + f * o_g))`` with
    the per-pixel focus values `fvals` [H, W], in `fdt` arithmetic."""
    g, _, h, w = planar.shape
    dev = planar.device
    ys = torch.arange(h, device=dev, dtype=fdt)[:, None]
    xs = torch.arange(w, device=dev, dtype=fdt)[None, :]
    o = torch.from_numpy(off).to(dev, fdt)
    fvals = fvals.to(fdt)
    out = torch.empty_like(planar)
    for i in range(g):
        # two roundings, as in the original: the product, then the sum
        cy = torch.trunc(ys + fvals * o[i, 1]).to(torch.int64).clamp_(0, h - 1)
        cx = torch.trunc(xs + fvals * o[i, 0]).to(torch.int64).clamp_(0, w - 1)
        out[i] = planar[i][:, cy, cx]
    return out


def estimate_map(planar: torch.Tensor, off: np.ndarray, ids: np.ndarray,
                 cands: np.ndarray, cbytes: np.ndarray, radius: tuple[int, int],
                 fdt: torch.dtype = torch.float32) -> torch.Tensor:
    """The exact disparity search -> [H, W] uint8 map (module docstring),
    the tap coordinates in `fdt` arithmetic."""
    _, c, h, w = planar.shape
    dev = planar.device
    sel = planar[torch.from_numpy(ids).to(dev)]  # [K, C, H, W]
    k = sel.shape[0]
    o = torch.from_numpy(off[ids]).to(dev, fdt)  # [K, 2]
    rx, ry = radius
    ys = torch.arange(h, device=dev, dtype=fdt)
    xs = torch.arange(w, device=dev, dtype=fdt)
    ki = torch.arange(k, device=dev)[:, None, None, None]
    ci = torch.arange(c, device=dev)[None, :, None, None]
    best = torch.full((h, w), torch.iinfo(torch.int32).max, dtype=torch.int32, device=dev)
    best_i = torch.zeros((h, w), dtype=torch.int64, device=dev)
    for i, f in enumerate(torch.from_numpy(cands).to(dev, fdt)):
        cy0 = torch.trunc(ys[None, :] + (f * o[:, 1])[:, None]).to(torch.int64)  # [K, H]
        cx0 = torch.trunc(xs[None, :] + (f * o[:, 0])[:, None]).to(torch.int64)  # [K, W]
        cost = torch.zeros((h, w), dtype=torch.int32, device=dev)
        for sy in (-ry, 0, ry):
            rows = (cy0 + sy).clamp_(0, h - 1)[:, None, :, None]
            for sx in (-rx, 0, rx):
                cols = (cx0 + sx).clamp_(0, w - 1)[:, None, None, :]
                mn, mx = torch.aminmax(sel[ki, ci, rows, cols], dim=0)
                cost += (mx.to(torch.int32) - mn.to(torch.int32)).amax(dim=0)
        better = cost < best
        best = torch.where(better, cost, best)
        best_i.masked_fill_(better, i)
    return torch.from_numpy(cbytes).to(dev)[best_i]


def filter_map(fmap: torch.Tensor, radius: tuple[int, int],
               fdt: torch.dtype = torch.float32) -> torch.Tensor:
    """The box filter over x in [x-rx, x+rx), y in [y-ry, y+ry), clamped
    reads, the mean (in `fdt`) rounded half away from zero; radius 0
    copies."""
    rx, ry = radius
    if rx == 0 or ry == 0:
        return fmap.clone()
    h, w = fmap.shape
    dev = fmap.device
    acc = torch.zeros((h, w), dtype=fdt, device=dev)
    for dy in range(-ry, ry):
        rows = (torch.arange(h, device=dev) + dy).clamp_(0, h - 1)
        for dx in range(-rx, rx):
            cols = (torch.arange(w, device=dev) + dx).clamp_(0, w - 1)
            acc += fmap[rows][:, cols].to(fdt)
    # a tensor divisor: torch on CUDA turns a scalar divisor into a multiply
    acc = acc / torch.tensor(4 * rx * ry, dtype=fdt, device=dev)
    return torch.where(acc >= 0, torch.floor(acc + 0.5), torch.ceil(acc - 0.5)).to(torch.uint8)


def render(config: dict, planar: torch.Tensor, trajectory: str, focus: float,
           focus_range: float, weights_dtype: torch.dtype | None = None,
           fdt: torch.dtype = torch.float32) -> dict:
    """Everything the reference works out for one render of `planar` [G, C,
    H, W] u8: ``stack`` (each image read where the blend reads it),
    ``weights`` [V, G] float64, and all in focus ``maps`` [2, H, W].

    The control, the reference in the program's place a step below the
    configuration's precision: `weights_dtype` rounds the fp16 weights to
    a lower precision first, and `fdt` takes the float32 arithmetic of the
    coordinates and of the filter's mean."""
    cols, rows = config["cols"], config["rows"]
    h, w = planar.shape[2:]
    if (h, w) != (config["height"], config["width"]) and not config.get("rehearsal"):
        raise ValueError(f"scene {w}x{h} is not the configuration's size")
    se = geometry.parse_trajectory(trajectory, cols, rows)
    wm = torch.from_numpy(geometry.weight_matrix(se, cols, rows, config["effect"],
                                                 config["views"])).to(planar.device)
    if weights_dtype is not None:
        wm = wm.to(weights_dtype).to(torch.float32)
    off = geometry.offsets(cols, rows, w, h, config["aspect"], geometry.trajectory_center(se))
    out = {"weights": wm.to(torch.float64)}
    if focus_range <= 0:
        out["stack"] = fixed_stack(planar, geometry.focused_offsets(off, focus))
        return out
    if not config["exact_focus_taps"]:
        raise ValueError("the reference holds the exact tap rule only")
    ids = geometry.focus_views(se, cols, rows, config["focus_map_views"])
    radius = geometry.block_radius(w, h, config["pixel_size_factor"])
    cands = geometry.candidates(focus, focus_range, config["focus_steps"])
    map0 = estimate_map(planar, off, ids, cands,
                        geometry.candidate_bytes(cands, focus, focus_range), radius, fdt)
    div = config["filter_radius_divisor"]
    map1 = filter_map(map0, (radius[0] // div, radius[1] // div), fdt)
    fmap = map1 if config["method"] == "STD" else map0
    decode = torch.from_numpy(geometry.decode_table(focus, focus_range)).to(planar.device)
    out["stack"] = allfocus_stack(planar, off, decode[fmap.to(torch.int64)], fdt)
    out["maps"] = torch.stack([map0, map1])
    return out


def blend_bytes(ref: dict) -> torch.Tensor:
    """The views [V, H, W, C] u8 that `ref`'s sums round to (rint, clipped):
    how the control turns its sums into the program's output."""
    stack = ref["stack"]
    chans = [torch.round(_sums(stack, ref["weights"], c)).clamp_(0, 255).to(torch.uint8)
             for c in range(stack.shape[1])]
    return torch.stack(chans, dim=-1)


def compare(ref: dict, views: torch.Tensor, maps: torch.Tensor | None) -> dict:
    """The numbers the check compares for one answer: ``view_bytes_off_rule``,
    the view bytes [V, H, W, C] that break the near-tie rule against the
    exact sums, and all in focus ``map_bytes_off``, the bytes of the two maps
    [2, H, W] that differ from the reference's (or all of them when the
    answer has no maps)."""
    stack = ref["stack"]
    if views.shape[-1] != stack.shape[1] or views.shape[0] != ref["weights"].shape[0]:
        return {"view_bytes_off_rule": views.numel() or 1,
                **({"map_bytes_off": ref["maps"].numel()} if "maps" in ref else {})}
    breaks = sum(rule_breaks(views[..., c], _sums(stack, ref["weights"], c))
                 for c in range(stack.shape[1]))
    out = {"view_bytes_off_rule": breaks}
    if "maps" in ref:
        want = ref["maps"]
        out["map_bytes_off"] = (want.numel() if maps is None or maps.shape != want.shape
                                else int((maps != want).sum()))
    return out
