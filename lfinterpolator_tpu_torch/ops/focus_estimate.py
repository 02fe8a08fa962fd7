"""Focus-map estimate: wrapper of the hand-written Hopper kernel.

One CUDA kernel (``csrc/focus_estimate.cu``), instantiated once per tap
rule, replaces the JAX package's fused estimate kernels:
``estimate_pallas._est_kernel`` (exact taps, the default) and
``estimate_pallas._est_fast_kernel`` (``--fast-focus``). It computes what
``focus_torch.estimate_focus_map`` computes, its plain version.

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

#: Kernel launches since import (or since a caller reset them to 0), per tap
#: rule. Counts only launches of the CUDA kernel, never plain-version calls.
launches = {"exact": 0, "fast": 0}

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


def focus_estimate(
    selected: torch.Tensor,  # [K, C, H, W] uint8, the focus views
    sel_offsets: torch.Tensor,  # [K, 2] float32 (x, y)
    tables: FocusTables,  # candidates [S] f32, candidate_bytes [S] u8
    radius: tuple[int, int],  # (rx, ry)
    exact_taps: bool = True,
) -> torch.Tensor:
    """Focus map -> [H, W] uint8 (kernel on CUDA tensors)."""
    _check(selected, sel_offsets, tables, radius)
    if selected.device.type == "cpu":
        return focus_estimate_reference(
            selected, sel_offsets, tables, radius, exact_taps
        )
    if selected.device.type != "cuda":
        raise ValueError(f"focus_estimate runs on cpu or cuda, not {selected.device}")

    from . import _build

    lib = _build.load()
    k, _, h, w = selected.shape
    s = tables.candidates.shape[0]
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
        err = lib.lfi_focus_estimate(
            words.data_ptr(), offsets.data_ptr(), cands.data_ptr(),
            cand_bytes.data_ptr(), out.data_ptr(), k, h, w, s,
            int(radius[0]), int(radius[1]), int(bool(exact_taps)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lfi_focus_estimate launch failed: CUDA error {err} "
            f"({lib.lfi_cuda_error_string(err).decode()})"
        )
    launches["exact" if exact_taps else "fast"] += 1
    return out
