"""Result writer: novel views, focus maps, quilts.

The port's own copy of ``lfinterpolator_tpu/io/writer.py``. Equivalent of
the reference's storeResults (reference: src/interpolator.cu:299-316): views are written as 00.png ... NN.png and the
focus maps as map0.png / map1.png. Quilt assembly mirrors
scripts/viewsToQuilt.sh (5x9 tile montage).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.progress import LoadingBar
from . import codec

# Bound on the RGBA staging buffer the batch-encode path materializes at
# once (a 4K 64-view RGB write would otherwise stage a multi-GB copy).
_BATCH_STAGE_BYTES = 64 * 1024 * 1024


def _with_alpha(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] -> [H, W, 4] with alpha 255 (outputs always have alpha=255,
    reference: src/kernels.cu:308)."""
    if img.shape[-1] == 4:
        return img
    h, w = img.shape[:2]
    out = np.empty((h, w, 4), dtype=np.uint8)
    out[:, :, :3] = img
    out[:, :, 3] = 255
    return out


def _encode_atomic(name: str, image: np.ndarray) -> None:
    """Write-then-rename so partially written frames never appear under the
    final name (matters for the streaming pipeline's per-frame outputs)."""
    tmp = name + ".tmp"
    codec.encode_png(tmp, image)
    os.replace(tmp, name)


def write_views(
    path: str,
    views: np.ndarray,  # [V, H, W, 3|4] uint8
    maps: np.ndarray | None = None,  # [2, H, W] uint8
    *,
    progress: bool = True,
) -> list[str]:
    """Write views as zero-padded numbered PNGs plus optional focus maps.

    Bulk view writes go through the native threaded batch encoder when it
    is built (one std::thread pool over all frames, each staged to .tmp
    and renamed -- same atomicity as the per-file path); otherwise frames
    encode one by one."""
    os.makedirs(path, exist_ok=True)
    v_count = views.shape[0]
    total = v_count + (maps.shape[0] if maps is not None else 0)
    bar = LoadingBar(total, "Storing results...", enabled=progress)
    written = []
    digits = max(2, len(str(v_count - 1)))
    names = [
        os.path.join(path, f"{i:0{digits}d}.png") for i in range(v_count)
    ]
    batched = False
    if v_count > 1 and codec.native_available():
        if views.shape[-1] == 4 and getattr(views, "flags", None) is not None \
                and views.flags["C_CONTIGUOUS"]:
            # zero-copy when the render output is already RGBA-contiguous
            batched = codec.encode_batch_png(names, views)
            if batched:
                for _ in names:
                    bar.add()
        else:
            # RGB or non-contiguous input: stage to RGBA in bounded chunks
            # so a 4K 64-view write never materializes a multi-GB copy
            frame_bytes = int(np.prod(views.shape[1:3])) * 4
            chunk = max(1, _BATCH_STAGE_BYTES // frame_bytes)
            batched = True
            for i in range(0, v_count, chunk):
                part = np.asarray(views[i : i + chunk])
                rgba = np.empty((*part.shape[:3], 4), dtype=np.uint8)
                rgba[..., :3] = part[..., :3]
                rgba[..., 3] = 255 if part.shape[-1] == 3 else part[..., 3]
                if not codec.encode_batch_png(names[i : i + chunk], rgba):
                    batched = False
                    break
                for _ in range(part.shape[0]):
                    bar.add()
    if batched:
        written.extend(names)
    else:
        for i in range(v_count):
            _encode_atomic(names[i], _with_alpha(views[i]))
            written.append(names[i])
            bar.add()
    if maps is not None:
        for i in range(maps.shape[0]):
            name = os.path.join(path, f"map{i}.png")
            m = maps[i]
            rgba = np.empty((*m.shape, 4), dtype=np.uint8)
            rgba[:, :, 0] = rgba[:, :, 1] = rgba[:, :, 2] = m
            rgba[:, :, 3] = 255
            _encode_atomic(name, rgba)
            written.append(name)
            bar.add()
    bar.finish()
    return written


def write_quilt(path: str, quilt: np.ndarray) -> str:
    """Write an assembled quilt image (see ops.quilt.assemble_quilt)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    codec.encode_png(path, _with_alpha(quilt))
    return path
