"""Focus-map estimate: wrapper of the hand-written Hopper kernel.

One CUDA kernel (``csrc/focus_estimate.cu``), instantiated once per tap
rule and once more for the presence-predicated refine pass, replaces the
JAX package's fused estimate kernels: ``estimate_pallas._est_kernel``
(exact taps, the default), ``estimate_pallas._est_fast_kernel``
(``--fast-focus``) and ``_est_kernel(predicated=True)`` (the refine pass of
``--focus-pyramid``, ``pres=``). It computes what
``focus_torch.estimate_focus_map`` computes (``estimate_presence`` with
``pres``), its plain version. ``focus_estimate_pyramid`` drives the
coarse-to-fine estimate: the coarse pass on the exact kernel, the presence
words in torch ops on the tensors' device, the refine on the predicated
kernel.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel, or raises. No path falls back
from one to the other.

The kernel reads the K focus views as one interleaved RGBx ``uint32`` word
per pixel (``rgbx``), so that one 4-byte load serves a tap and
``__vminu4``/``__vmaxu4`` do the channels at once. The wrapper builds that
copy with torch ops on each call -- once per render -- and it lives only
for the launch: ``4 * K * H * W`` bytes (265 MB at K = 32, 1080p).
"""

from __future__ import annotations

import torch

from ..state import FocusTables
from . import focus_torch
from .estimate_geometry import Pyramid

#: Kernel launches since import (or since a caller reset them to 0), per
#: instantiation: the two tap rules and the pyramid's refine pass. Counts
#: only launches of the CUDA kernel, never plain-version calls.
launches = {"exact": 0, "fast": 0, "pyramid": 0}

focus_estimate_reference = focus_torch.estimate_focus_map


def rgbx(selected: torch.Tensor) -> torch.Tensor:
    """[K, C<=4, H, W] uint8 -> [K, H, W] int32 words, channel c in byte c
    (little-endian), unused bytes 0."""
    k, c, h, w = selected.shape
    out = torch.zeros((k, h, w, 4), dtype=torch.uint8, device=selected.device)
    out[..., :c] = selected.permute(0, 2, 3, 1)
    return out.view(torch.int32).reshape(k, h, w)


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


def focus_estimate(
    selected: torch.Tensor,  # [K, C, H, W] uint8, the focus views
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    tables: FocusTables,  # candidates [S] f32, candidate_bytes [S] u8
    radius: tuple[int, int],  # (rx, ry)
    exact_taps: bool = True,
    pres: torch.Tensor | None = None,  # [NB, N_WC, CC] int32 presence words
    plan: Pyramid | None = None,  # the grain of `pres`
) -> torch.Tensor:
    """Focus map -> [H, W] uint8 (kernel on CUDA tensors).

    With `pres` (and its `plan`), the exact-taps search over each block's
    present candidates only: the pyramid's refine pass."""
    _check(selected, sel_offsets, tables, radius)
    s = tables.candidates.shape[0]
    if pres is not None:
        if not exact_taps or plan is None:
            raise ValueError("presence words need exact taps and their plan")
        _check_pres(pres, plan, selected, s)
    if selected.device.type == "cpu":
        if pres is not None:
            return focus_torch.estimate_presence(
                selected, sel_offsets, tables, radius, pres, plan)
        return focus_estimate_reference(
            selected, sel_offsets, tables, radius, exact_taps
        )
    if selected.device.type != "cuda":
        raise ValueError(f"focus_estimate runs on cpu or cuda, not {selected.device}")

    from . import _build

    lib = _build.load()
    k, _, h, w = selected.shape
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
    offsets = sel_offsets.contiguous()
    cands = tables.candidates.contiguous()
    cand_bytes = tables.candidate_bytes.contiguous()
    with torch.cuda.device(selected.device):
        words = rgbx(selected)
        out = torch.empty((h, w), dtype=torch.uint8, device=selected.device)
        stream = torch.cuda.current_stream(selected.device).cuda_stream
        if pres is None:
            name = "lfi_focus_estimate"
            err = lib.lfi_focus_estimate(
                words.data_ptr(), offsets.data_ptr(), cands.data_ptr(),
                cand_bytes.data_ptr(), out.data_ptr(), k, h, w, s,
                int(radius[0]), int(radius[1]), int(bool(exact_taps)), stream,
            )
        else:
            name = "lfi_focus_estimate_pres"
            pres = pres.contiguous()
            err = lib.lfi_focus_estimate_pres(
                words.data_ptr(), offsets.data_ptr(), cands.data_ptr(),
                cand_bytes.data_ptr(), pres.data_ptr(), out.data_ptr(), k, h,
                w, s, int(radius[0]), int(radius[1]), plan.tb, plan.wco,
                plan.sc, plan.nb, plan.n_wc, pres.shape[2], stream,
            )
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.lfi_cuda_error_string(err).decode()})"
        )
    launches["pyramid" if pres is not None else
             "exact" if exact_taps else "fast"] += 1
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
