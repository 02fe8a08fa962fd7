"""Focus-map estimate: wrapper of the hand-written Hopper kernels.

The CUDA kernels of ``csrc/focus_estimate.cu`` (the map pass, the argmin
pass in three instantiations, and the RGBx pack) replace the JAX package's
fused estimate kernels: ``estimate_pallas._est_kernel`` (exact taps, the
default), ``estimate_pallas._est_fast_kernel`` (``--fast-focus``) and
``_est_kernel(predicated=True)`` (the refine pass of ``--focus-pyramid``,
``pres=``). An estimate is two passes: the map pass computes, per
candidate, one byte per pixel of the frame extended by the stencil radius
(the spread ``max_c(max_k - min_k)`` over the focus views); the argmin pass
sums the nine bytes around each pixel and keeps the first strict minimum.
The exact tap rule reads those bytes only where they are what it would read
itself: ``focus_torch.clean_flags`` marks those rows and columns, in torch
ops on the tensors' device, and every other (candidate, pixel) pair runs the
nine-tap loop over the views inside the argmin kernel.
``focus_torch.estimate_hoisted`` states the same in plain ops. The result
is what ``focus_torch.estimate_focus_map`` computes (``estimate_presence``
with ``pres``), the plain version. ``focus_estimate_pyramid`` drives the
coarse-to-fine estimate: the coarse pass on the exact rule, the presence
words in torch ops, the refine on the predicated instantiation.

An estimate may compute a block of rows, ``row_start`` and ``row_count``
(one rank's rows of a multi-GPU render; not the presence-predicated refine
pass, which takes the whole frame): both passes then cover only those
rows (the map pass their extended rows), with the frame's coordinates and
the frame's clean flags sliced to the block, and the map is ``[hb, W]``,
bit-equal to the same rows of the whole-frame estimate. The RGBx copy holds
the full frame of the focus views. The defaults estimate the frame.
``Estimate`` is one frame's estimate prepared once -- its RGBx words,
operand tables and clean flags -- for any number of row blocks, each
written straight into its rows of the frame's map: a TEN all-in-focus
frame estimates its row bands one by one, each just before it blends
them (``pipeline.FocusBands``). ``focus_estimate`` is one block on an
``Estimate`` of its own. Whatever its blocks, an estimate counts once per
frame, as ``focus_estimate_exact`` / ``_fast`` (``_pyramid`` for the
refine pass); ``pipeline`` counts its blocks as ``estimate bands``.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version; a CUDA tensor launches the kernels, or raises. No path falls back
from one to the other.

Scratch, alive as long as the ``Estimate`` (its last block, for a frame
estimated in bands): the K focus views as one interleaved RGBx ``uint32``
word per pixel (``rgbx``, a small kernel of the same source; ``4 * K * H *
W`` bytes: 265 MB at K = 32, 1080p), so that one 4-byte load serves a tap,
and the flags, ``S * (H + W)`` bytes; per block: the maps of one chunk of
candidates (``map_chunk``: all of them while they fit
``MAP_BYTES_PER_PIXEL * H * W`` bytes, 69 MB for 32 candidates at 1080p)
and the running best as one int32 per pixel when there is more than one
chunk.
``SCRATCH_BYTES_PER_PIXEL`` is what ``core/capacity.py`` counts for the
maps and the running best.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import _build, focus_torch
from .blend_torch import row_block
from .estimate_geometry import FocusTables, Pyramid

#: The maps of one chunk of candidates take at most this many bytes per
#: frame pixel (but never less than one candidate's map).
MAP_BYTES_PER_PIXEL = 40
#: ... and with the running best (one int32 per pixel), what an estimate
#: holds beside its operands, the RGBx copy and the flags.
SCRATCH_BYTES_PER_PIXEL = MAP_BYTES_PER_PIXEL + 4

focus_estimate_reference = focus_torch.estimate_focus_map


def rgbx_reference(selected: torch.Tensor) -> torch.Tensor:
    """[K, C<=4, H, W] uint8 -> [K, H, W] int32 words, channel c in byte c
    (little-endian), unused bytes 0: the plain version of ``rgbx``."""
    k, c, h, w = selected.shape
    out = torch.zeros((k, h, w, 4), dtype=torch.uint8, device=selected.device)
    out[..., :c] = selected.permute(0, 2, 3, 1)
    return out.view(torch.int32).reshape(k, h, w)


def rgbx(selected: torch.Tensor) -> torch.Tensor:
    """``rgbx_reference`` by the pack kernel on a CUDA tensor (one read of
    the planar views, one write of the words), by torch ops on the CPU."""
    if selected.device.type != "cuda":
        return rgbx_reference(selected)
    k, c, h, w = selected.shape
    planar = selected.contiguous()
    out = torch.empty((k, h, w), dtype=torch.int32, device=selected.device)
    _build.launch("lfi_rgbx_pack", selected.device, planar.data_ptr(), out.data_ptr(),
                  k, c, h * w)
    return out


def _check(selected, sel_offsets, tables: FocusTables, radius):
    if selected.dtype != torch.uint8 or selected.dim() != 4:
        raise ValueError(
            f"selected must be [K, C, H, W] uint8, got "
            f"{tuple(selected.shape)} {selected.dtype}"
        )
    k, c, h, w = selected.shape
    if min(k, c, h, w) < 1 or c > 4:
        raise ValueError(
            f"selected must have K, H, W >= 1 and 1 <= C <= 4, got "
            f"{tuple(selected.shape)}"
        )
    if sel_offsets.dtype != torch.float32 or tuple(sel_offsets.shape) != (k, 2):
        raise ValueError(
            f"sel_offsets must be [{k}, 2] float32 (x, y), got "
            f"{tuple(sel_offsets.shape)} {sel_offsets.dtype}"
        )
    cands, cand_bytes = tables.candidates, tables.candidate_bytes
    if (cands.dtype != torch.float32 or cands.dim() != 1 or cands.shape[0] < 1
            or cand_bytes.dtype != torch.uint8
            or tuple(cand_bytes.shape) != tuple(cands.shape)):
        raise ValueError(
            f"tables must hold [S] float32 candidates and [S] uint8 bytes, got "
            f"{tuple(cands.shape)} {cands.dtype} and "
            f"{tuple(cand_bytes.shape)} {cand_bytes.dtype}"
        )
    if min(int(radius[0]), int(radius[1])) < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    devices = {selected.device, sel_offsets.device, cands.device, cand_bytes.device}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")


def _check_pres(pres: torch.Tensor, plan: Pyramid, selected, steps: int):
    h, w = selected.shape[2:]
    if (pres.dtype != torch.int32 or pres.dim() != 3
            or plan.nb * plan.tb < h or plan.n_wc * plan.wco < w
            or tuple(pres.shape) != (plan.nb, plan.n_wc, -(-steps // plan.sc))):
        raise ValueError(
            f"pres must be [{plan.nb}, {plan.n_wc}, {-(-steps // plan.sc)}] int32 "
            f"covering {h}x{w}, got {tuple(pres.shape)} {pres.dtype}"
        )
    if pres.device != selected.device:
        raise ValueError(f"pres on {pres.device}, selected on {selected.device}")


def map_chunk(h: int, w: int, radius: tuple[int, int], steps: int) -> int:
    """The number of candidates whose maps are held at once."""
    plane = (h + 2 * int(radius[1])) * (w + 2 * int(radius[0]))
    return max(1, min(steps, MAP_BYTES_PER_PIXEL * h * w // plane))


class Estimate:
    """One frame's estimate, prepared once for any of its row blocks.

    Made once, on a CUDA device: the focus views' RGBx words (the planar
    views are not kept) and the contiguous operand tables; and, for the
    exact rule, the frame's clean flags, inside the first block, after its
    first map pass is enqueued, so that their host work overlaps the
    device's (``lfi.estimate.flags``). ``rows(r0, hb)`` runs the map pass
    (over the block's rows and their 2·ry halo rows) and the argmin pass
    for rows [r0, r0 + hb), the flags sliced to the block, and writes the
    argmin pass's bytes straight into those rows of `out` ([H, W], the
    frame's map), or into a new [hb, W] map without `out`. A block equals
    the same rows of the whole-frame estimate, in any order of blocks. The
    estimate counts once, as ``focus_estimate_<rule>``, when its first
    block is launched, whatever the blocks and launches after it.

    `flags` (bool row_clean [S, H], col_clean [S, W]) take the place of
    ``focus_torch.clean_flags``'s; `pres` and its `plan` make it the
    presence-predicated refine pass, which takes the whole frame only. On
    a CPU tensor a block is the plain version's."""

    def __init__(self, selected, sel_offsets, tables: FocusTables, radius,
                 exact_taps: bool = True, flags=None, pres=None, plan=None,
                 out: torch.Tensor | None = None):
        _check(selected, sel_offsets, tables, radius)
        k, _, h, w = selected.shape
        s = tables.candidates.shape[0]
        self.device = dev = selected.device
        if pres is not None:
            if not exact_taps or plan is None:
                raise ValueError("presence words need exact taps and their plan")
            _check_pres(pres, plan, selected, s)
            pres = pres.contiguous()
        if flags is not None:
            flags = _flag_bytes(flags, s, h, w, dev)
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"focus_estimate runs on cpu or cuda, not {dev}")
        if out is not None and (tuple(out.shape) != (h, w) or out.dtype != torch.uint8
                                or not out.is_contiguous() or out.device != dev):
            raise ValueError(f"out must be a contiguous [{h}, {w}] uint8 tensor on {dev}, "
                             f"got {tuple(out.shape)} {out.dtype}")
        self.radius = (int(radius[0]), int(radius[1]))
        self.dims = (k, h, w, s, *self.radius)
        self.sel_offsets, self.tables, self.exact_taps = sel_offsets, tables, exact_taps
        self.flags, self.pres, self.plan, self.out = flags, pres, plan, out
        self.counted = False
        if dev.type == "cpu":
            self.selected = selected
            return
        lib = _build.load()
        if k > lib.lfi_focus_estimate_max_views():
            raise ValueError(
                f"the kernel takes at most {lib.lfi_focus_estimate_max_views()} "
                f"focus views, got {k}"
            )
        if s > lib.lfi_focus_estimate_max_steps():
            raise ValueError(
                f"the kernel takes at most {lib.lfi_focus_estimate_max_steps()} "
                f"candidates, got {s}"
            )
        self.offsets = sel_offsets.contiguous()
        self.cands = tables.candidates.contiguous()
        self.cand_bytes = tables.candidate_bytes.contiguous()
        self.words = rgbx(selected)

    def _block_flags(self, r0: int, hb: int):
        """The exact rule's flags of rows [r0, r0 + hb) as bytes: the
        frame's, made on first use, sliced to the block (flags of the block
        alone would be those of rows [0, hb))."""
        _, h, w, s = self.dims[:4]
        if self.flags is None:
            with profiling.span("lfi.estimate.flags"):
                self.flags = _flag_bytes(
                    focus_torch.clean_flags(self.sel_offsets, self.tables, self.radius, h, w),
                    s, h, w, self.device)
        rows, cols = self.flags
        return rows[:, r0:r0 + hb].contiguous(), cols

    def rows(self, row_start: int = 0, row_count: int | None = None) -> torch.Tensor:
        """The map of rows [row_start, row_start + row_count) -> [hb, W]
        uint8: those rows of `out`, or a new map (the defaults: the
        frame)."""
        h, w = self.dims[1:3]
        r0, hb = row_block(h, row_start, row_count)
        if self.pres is not None and (r0, hb) != (0, h):
            raise ValueError("the presence-predicated estimate takes the whole frame")
        out = (torch.empty((hb, w), dtype=torch.uint8, device=self.device)
               if self.out is None else self.out[r0:r0 + hb])
        if self.device.type == "cpu":
            if self.pres is not None:
                out.copy_(focus_torch.estimate_presence(
                    self.selected, self.sel_offsets, self.tables, self.radius, self.pres,
                    self.plan))
            else:
                out.copy_(focus_estimate_reference(
                    self.selected, self.sel_offsets, self.tables, self.radius,
                    self.exact_taps, row_start=r0, row_count=hb))
            return out
        flags = (lambda: self._block_flags(r0, hb)) if self.exact_taps else None
        _Passes(self, r0, hb, out).run(flags, self.pres, self.plan)
        if not self.counted:
            # once per estimate, whatever number of blocks and device
            # launches it takes, and only once a block's were all taken
            profiling.count("focus_estimate_pyramid" if self.pres is not None else
                            "focus_estimate_exact" if self.exact_taps else
                            "focus_estimate_fast")
            self.counted = True
        return out


class _Passes:
    """The scratch of one row block [r0, r0 + hb) of an ``Estimate`` on a
    CUDA device, and the block's two passes into `out` [hb, W]."""

    def __init__(self, est: Estimate, r0: int, hb: int, out: torch.Tensor | None = None):
        k, h, w, s, rx, ry = est.dims
        dev = est.device
        self.est = est
        self.dims = (k, h, w, s, rx, ry, r0, hb)
        self.chunk = map_chunk(hb, w, (rx, ry), s)
        self.maps = torch.empty((self.chunk, hb + 2 * ry, w + 2 * rx),
                                dtype=torch.uint8, device=dev)
        self.best = (torch.empty((hb, w), dtype=torch.int32, device=dev)
                     if self.chunk < s else None)
        self.out = torch.empty((hb, w), dtype=torch.uint8, device=dev) if out is None else out

    def map_pass(self, c0: int, n: int) -> None:
        """The maps of candidates [c0, c0 + n) into ``self.maps[:n]``."""
        k, h, w, _, rx, ry, r0, hb = self.dims
        est = self.est
        _build.launch("lfi_focus_cheby_map", est.device, est.words.data_ptr(),
                      est.offsets.data_ptr(), est.cands.data_ptr() + 4 * c0,
                      self.maps.data_ptr(), k, h, w, n, rx, ry, r0, hb)

    def argmin_pass(self, c0: int, n: int, flags=None, pres=None, plan=None) -> None:
        """Candidates [c0, c0 + n) against each pixel's running best; the
        exact rule with `flags` = (row_clean, col_clean), else the fast."""
        est = self.est
        rows, cols = (f.data_ptr() for f in flags) if flags is not None else (None, None)
        head = (est.words.data_ptr(), est.offsets.data_ptr(), est.cands.data_ptr(),
                est.cand_bytes.data_ptr(), self.maps.data_ptr(), rows, cols,
                None if self.best is None else self.best.data_ptr())
        if pres is None:
            _build.launch("lfi_focus_estimate", est.device, *head,
                          self.out.data_ptr(), *self.dims, c0, n)
        else:
            _build.launch("lfi_focus_estimate_pres", est.device, *head,
                          pres.data_ptr(), self.out.data_ptr(), *self.dims[:6], c0, n,
                          plan.tb, plan.wco, plan.sc, plan.nb, plan.n_wc, pres.shape[2])

    def run(self, flags=None, pres=None, plan=None) -> torch.Tensor:
        """Every chunk's two passes -> the block's map. `flags` may be a
        callable that makes them: it runs after the first map pass is
        enqueued, so its host work overlaps the device's."""
        s = self.dims[3]
        for c0 in range(0, s, self.chunk):
            n = min(self.chunk, s - c0)
            self.map_pass(c0, n)
            if callable(flags):
                flags = flags()
            self.argmin_pass(c0, n, flags, pres, plan)
        return self.out


def _flag_bytes(flags, steps: int, h: int, w: int, device):
    """(row_clean [S, h], col_clean [S, W]) as contiguous byte tensors (h:
    the rows of the block)."""
    rows, cols = flags
    if (tuple(rows.shape) != (steps, h) or tuple(cols.shape) != (steps, w)
            or rows.dtype != torch.bool or cols.dtype != torch.bool
            or rows.device != device or cols.device != device):
        raise ValueError(
            f"flags must be bool [{steps}, {h}] and [{steps}, {w}] on {device}, got "
            f"{tuple(rows.shape)} {rows.dtype} and {tuple(cols.shape)} {cols.dtype}"
        )
    return rows.contiguous().view(torch.uint8), cols.contiguous().view(torch.uint8)


def focus_estimate(
    selected: torch.Tensor,  # [K, C, H, W] uint8, the focus views
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    tables: FocusTables,  # candidates [S] f32, candidate_bytes [S] u8
    radius: tuple[int, int],  # (rx, ry)
    exact_taps: bool = True,
    pres: torch.Tensor | None = None,  # [NB, N_WC, CC] int32 presence words
    plan: Pyramid | None = None,  # the grain of `pres`
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """Focus map of rows [row_start, row_start + row_count) -> [hb, W]
    uint8 (kernels on CUDA tensors; the defaults: the frame), on an
    ``Estimate`` of its own.

    With `pres` (and its `plan`), the exact-taps search over each block's
    present candidates only: the pyramid's refine pass."""
    return Estimate(selected, sel_offsets, tables, radius, exact_taps, None, pres,
                    plan).rows(row_start, row_count)


def focus_estimate_flagged(
    selected: torch.Tensor,
    sel_offsets: torch.Tensor,
    tables: FocusTables,
    radius: tuple[int, int],
    flags: tuple[torch.Tensor, torch.Tensor],  # row_clean [S, H], col_clean [S, W] bool
    pres: torch.Tensor | None = None,
    plan: Pyramid | None = None,
) -> torch.Tensor:
    """The exact-taps estimate with the caller's clean flags in place of
    ``focus_torch.clean_flags``'s. The map is the same as long as `flags`
    mark clean nothing that those do not; all False runs the nine-tap loop
    for every (candidate, pixel) pair. For tests and timings."""
    return Estimate(selected, sel_offsets, tables, radius, True, flags, pres, plan).rows()


def cheby_maps(
    selected: torch.Tensor,  # [K, C, H, W] uint8
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    tables: FocusTables,
    radius: tuple[int, int],
    row_start: int = 0,
    row_count: int | None = None,
) -> torch.Tensor:
    """The map pass alone -> [S, hb + 2*ry, W + 2*rx] uint8, every
    candidate's ``focus_torch.cheby_map`` (which a CPU tensor takes) on
    the block's extended rows."""
    _check(selected, sel_offsets, tables, radius)
    r0, hb = row_block(selected.shape[2], row_start, row_count)
    if selected.device.type == "cpu":
        return torch.stack([focus_torch.cheby_map(selected, sel_offsets, f, radius, r0, hb)
                            for f in tables.candidates])
    if selected.device.type != "cuda":
        raise ValueError(f"cheby_maps runs on cpu or cuda, not {selected.device}")
    passes = _Passes(Estimate(selected, sel_offsets, tables, radius), r0, hb)
    out = []
    for c0 in range(0, passes.dims[3], passes.chunk):
        n = min(passes.chunk, passes.dims[3] - c0)
        passes.map_pass(c0, n)
        out.append(passes.maps[:n].clone())
    return torch.cat(out)


def pass_times(selected, sel_offsets, tables: FocusTables, radius,
               exact_taps: bool = True, runs: int = 5) -> dict:
    """CUDA-event ms of an estimate's parts on CUDA tensors, each over
    `runs` back-to-back launches on operands prepared once: the RGBx copy,
    the clean flags (torch ops), the map pass and the argmin pass of the
    first chunk of candidates (all of them when ``chunk == steps``), the
    argmin pass with every flag cleared (the nine-tap loop alone) when
    `exact_taps`; and ``slow_share``, the share of (candidate, pixel) pairs
    that the flags send down the nine-tap loop."""
    _check(selected, sel_offsets, tables, radius)
    s = tables.candidates.shape[0]
    h, w = selected.shape[2:]

    def ms(fn) -> float:
        return profiling.event_ms(fn, runs)

    with torch.cuda.device(selected.device):  # event_ms times the current device
        passes = _Passes(Estimate(selected, sel_offsets, tables, radius), 0, h)
        n = passes.chunk
        out = {"chunk": n, "steps": s,
               "rgbx_ms": ms(lambda: rgbx(selected)),
               "map_ms": ms(lambda: passes.map_pass(0, n))}
        flags = None
        if exact_taps:
            make = lambda: focus_torch.clean_flags(sel_offsets, tables, radius, h, w)
            out["flags_ms"] = ms(make)
            rows, cols = make()
            out["slow_share"] = focus_torch.slow_share(rows, cols)
            flags = _flag_bytes((rows, cols), s, h, w, selected.device)
            dirty = tuple(torch.zeros_like(f) for f in flags)
            out["nine_tap_ms"] = ms(lambda: passes.argmin_pass(0, n, dirty))
        out["argmin_ms"] = ms(lambda: passes.argmin_pass(0, n, flags))
    return out


def focus_estimate_pyramid(
    selected: torch.Tensor,  # [K, C, H, W] uint8
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    tables: FocusTables,
    radius: tuple[int, int],
    plan: Pyramid,
) -> torch.Tensor:
    """Coarse-to-fine exact-taps estimate -> [H, W] uint8: the steps of
    ``focus_torch.estimate_pyramid`` (its plain version) with the estimate
    kernel for both passes on CUDA tensors."""
    s = plan.scale
    coarse = focus_estimate(selected[:, :, ::s, ::s], sel_offsets / s, tables,
                            plan.radius_c, True)
    pres = focus_torch.presence_from_coarse(coarse, plan, tables.candidates.shape[0])
    return focus_estimate(selected, sel_offsets, tables, radius, True, pres, plan)
