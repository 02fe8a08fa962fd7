"""Quick check and timing of the port's two blend kernels on one NVIDIA GPU.

    python3 scripts/torch_blend_check.py [--no-time]

Builds lfinterpolator_tpu_torch/csrc/, prints ptxas's report and the number
of tensor-core instructions of the blend kernels, holds shift_blend,
quilt_blend and allfocus_blend to the near-tie rule (blend_torch.check_bytes)
and to 1 LSB of their plain versions on small scenes (odd widths, shifts past
the image, G = 4 .. 256, V = 1 .. 320), checks that a chunk or batch of views
is bit-equal to the same rows of one launch, and times the three kernels at
the headline frame (8x8 grid, 1080x1920, 64 views) with CUDA events:
allfocus_blend on a noise map, a blocky map and a constant map, shift_blend
also with 1 view, with 16 images and with 256 views.
A shorter loop than chip_smoke.py while working on the kernels; exits
non-zero on the first failure.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lfinterpolator_tpu_torch.ops import (  # noqa: E402
    _build, allfocus_blend, blend_torch, quilt, shift_blend)
from lfinterpolator_tpu_torch.utils.profiling import event_ms  # noqa: E402

DEV = "cuda"


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)


def scene(g, v, c, h, w, seed, max_shift):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (g, c, h, w), dtype=np.uint8)
    weights = (rng.random((v, g)) / g * 2).astype(np.float16).astype(np.float32)
    shifts = rng.integers(-max_shift, max_shift + 1, (g, 2)).astype(np.int32)
    return t(images), t(weights), t(shifts)


def rule(name, got, stack, weights, plain):
    counts = {"bytes": 0, "lax": 0, "ties_off": 0}
    for c in range(got.shape[1]):
        part = blend_torch.check_bytes(
            got[:, c], blend_torch.exact_sums(stack[:, c], weights))
        counts = {k: counts[k] + part[k] for k in counts}
    diff = (got.int() - plain.int()).abs()
    if int(diff.max()) > 1:
        raise AssertionError(f"{name}: {int(diff.max())} LSB from the plain version")
    print(f"{name}: near-tie rule holds on {counts['bytes']} bytes ({counts['lax']} in the "
          f"band, {counts['ties_off']} of them off rint); {int((diff > 0).sum())} differ "
          "from the plain version", flush=True)


def check_small():
    # (G, V, C, H, W, max shift)
    cases = [(4, 1, 3, 12, 20, 25), (16, 26, 3, 48, 64, 9), (15, 64, 3, 45, 70, 80),
             (64, 45, 3, 24, 136, 5), (64, 320, 1, 9, 300, 3), (256, 64, 3, 6, 261, 300),
             (37, 130, 4, 7, 1000, 40)]
    for n, (g, v, c, h, w, ms) in enumerate(cases):
        images, weights, shifts = scene(g, v, c, h, w, n, ms)
        got = shift_blend.shift_blend(images, weights, shifts)
        torch.cuda.synchronize()
        rule(f"shift_blend G={g} V={v} C={c} {h}x{w}", got,
             blend_torch.shift_stack(images, shifts), weights,
             shift_blend.shift_blend_reference(images, weights, shifts))
        # chunking independence: rows lo..hi alone == the same rows of the launch
        for lo, hi in ((0, 1), (v // 3, v // 3 + 64), (v - 1, v)):
            hi = min(hi, v)
            part = shift_blend.shift_blend(images, weights[lo:hi].contiguous(), shifts)
            if not torch.equal(part, got[lo:hi]):
                raise AssertionError(f"shift_blend rows {lo}:{hi} of {v} differ alone")
        if v >= 6:
            canvas = quilt.quilt_blend(images, weights, shifts, 2, 3)
            tiles = canvas.reshape(c, 3, h, 2, w).permute(1, 3, 0, 2, 4).reshape(6, c, h, w)
            if not torch.equal(tiles, got[:6]):
                raise AssertionError("quilt_blend tiles != shift_blend views")
        rng = np.random.default_rng(100 + n)
        offsets = t((rng.random((g, 2)) * 8 - 4).astype(np.float32))
        decode = t(np.linspace(-1.5, 2.5, 256).astype(np.float32))
        fmap = t(rng.integers(0, 256, (h, w), dtype=np.uint8))
        args = (images, weights, offsets, fmap, decode)
        got = allfocus_blend.allfocus_blend(*args)
        torch.cuda.synchronize()
        rule(f"allfocus_blend G={g} V={v} C={c} {h}x{w}", got,
             blend_torch.allfocus_selected(images, offsets, fmap, decode), weights,
             allfocus_blend.allfocus_blend_reference(*args))
        part = allfocus_blend.allfocus_blend(images, weights[v // 2:].contiguous(),
                                             offsets, fmap, decode)
        if not torch.equal(part, got[v // 2:]):
            raise AssertionError("allfocus_blend rows differ alone")


def time_headline(smi):
    """The three kernels at the headline frame; allfocus_blend on a map of
    per-pixel noise over the 32 candidate bytes (every gather its own
    sector), on a map of 64x8-pixel blocks of one byte each, and on a
    constant map, with the render's own offsets and decode table. Also the
    input and the output side of shift_blend alone (1 view; 16 images)."""
    from lfinterpolator_tpu_torch import RenderConfig, state

    h, w = 1080, 1920
    rng = np.random.default_rng(0)
    p = state.allfocus_params("0,0,1,1", cols=8, rows=8, height=h, width=w,
                              config=RenderConfig(focus=0.1, focus_range=0.3))
    weights, offsets, _, tables = state.upload_allfocus(p, DEV)
    wm, fo = state.render_params("0,0,1,1", cols=8, rows=8, height=h, width=w, focus=0.1)
    images, _, shifts = state.to_device_state(
        rng.integers(0, 256, (64, h, w, 3), dtype=np.uint8), wm, fo, DEV)
    got = shift_blend.shift_blend(images, weights, shifts)
    rule("shift_blend headline", got, blend_torch.shift_stack(images, shifts), weights,
         shift_blend.shift_blend_reference(images, weights, shifts))
    del got
    cb = p.tables.candidate_bytes
    maps = {
        "noise": cb[rng.integers(0, 32, (h, w))],
        "blocks": np.repeat(np.repeat(cb[rng.integers(0, 32, (h // 8, w // 64))], 8, 0), 64, 1),
        "constant": np.full((h, w), cb[10], np.uint8),
    }
    for _ in range(2):
        times = {
            "shift_blend": lambda: shift_blend.shift_blend(images, weights, shifts),
            "quilt_blend": lambda: quilt.quilt_blend(images, weights, shifts),
            "shift_blend, 1 view": lambda: shift_blend.shift_blend(
                images, weights[:1].contiguous(), shifts),
            "shift_blend, 16 images": lambda: shift_blend.shift_blend(
                images[:16], weights[:, :16].contiguous(), shifts[:16]),
            "shift_blend, 256 views": lambda: shift_blend.shift_blend(
                images, weights.repeat(4, 1), shifts),
        }
        for name, fmap in maps.items():
            times[f"allfocus_blend, {name} map"] = lambda m=t(fmap): (
                allfocus_blend.allfocus_blend(images, weights, offsets, m, tables.decode))
        print(f"headline 8x8/1080p/64v ({smi}): " + ", ".join(
            f"{name} {event_ms(fn):.3f} ms" for name, fn in times.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_blend_check: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(force=True)
    lines = _build.build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "blend_kernel" in line:
            print("\n".join(lines[i:i + 4]))
    spills = {k: v for k, v in _build.spills().items() if "blend_kernel" in k}
    mma = {k: v for k, v in _build.tensor_core_instructions().items() if "blend_kernel" in k}
    print(f"spill bytes {spills}\ntensor-core instructions {mma}", flush=True)
    # three kernels, each built for one pass and with later passes
    if any(spills.values()) or len(mma) != 6 or not all(mma.values()):
        raise AssertionError("a blend kernel spills or holds no tensor-core instruction")
    check_small()
    if "--no-time" not in sys.argv[1:]:
        time_headline(smi)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
