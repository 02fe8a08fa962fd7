"""Image quality metrics: PSNR, SSIM, and (optional) VMAF.

The port's own copy of ``lfinterpolator_tpu/utils/metrics.py`` (NumPy only;
``compare_files`` decodes through the port's ``io.codec``;
``tests/test_torch_copies.py`` holds the two equal).

Python equivalent of the reference's ffmpeg-based evaluation
(reference: scripts/imageQualityMetrics.sh:6-12, which extracts ffmpeg's
`psnr` average, `ssim` All, and libvmaf scores). PSNR/SSIM are computed here
directly so the quality gates need no external tools; VMAF is a learned
metric tied to the libvmaf model, so it shells out to an ffmpeg with libvmaf
when one is available and is skipped gracefully otherwise.
"""

from __future__ import annotations

import re
import shutil
import subprocess

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_value: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB (inf for identical images)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"Shape mismatch: {a.shape} vs {b.shape}")
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_value**2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


def _filter2d_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution with a 1-D kernel applied to both axes."""
    n = k.size
    # rows
    out = np.zeros((img.shape[0] - n + 1, img.shape[1]), dtype=np.float64)
    for i in range(n):
        out += k[i] * img[i : i + out.shape[0], :]
    out2 = np.zeros((out.shape[0], img.shape[1] - n + 1), dtype=np.float64)
    for i in range(n):
        out2 += k[i] * out[:, i : i + out2.shape[1]]
    return out2


def ssim(a: np.ndarray, b: np.ndarray, max_value: float = 255.0) -> float:
    """Structural similarity (Wang et al. 2004, 11x11 Gaussian window).

    Accepts [H, W] or [H, W, C] uint8/float; channel scores are averaged
    (ffmpeg's 'All').
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"Shape mismatch: {a.shape} vs {b.shape}")
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    k = _gaussian_kernel()
    scores = []
    for ch in range(a.shape[2]):
        x, y = a[:, :, ch], b[:, :, ch]
        mu_x = _filter2d_valid(x, k)
        mu_y = _filter2d_valid(y, k)
        mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        sig_xx = _filter2d_valid(x * x, k) - mu_xx
        sig_yy = _filter2d_valid(y * y, k) - mu_yy
        sig_xy = _filter2d_valid(x * y, k) - mu_xy
        s = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / (
            (mu_xx + mu_yy + c1) * (sig_xx + sig_yy + c2)
        )
        scores.append(s.mean())
    return float(np.mean(scores))


_VMAF_RE = re.compile(r"VMAF score\s*[:=]?\s*([0-9.]+)")
_vmaf_probe_cache: dict[str, bool] = {}


def vmaf_available(ffmpeg: str = "ffmpeg") -> bool:
    """True when an ffmpeg with the libvmaf filter is on PATH.

    Memoized per binary: the probe spawns an `ffmpeg -filters` subprocess,
    and vmaf() would otherwise re-probe for every image pair."""
    if ffmpeg in _vmaf_probe_cache:
        return _vmaf_probe_cache[ffmpeg]
    ok = False
    if shutil.which(ffmpeg) is not None:
        try:
            out = subprocess.run(
                [ffmpeg, "-hide_banner", "-filters"],
                capture_output=True, text=True, timeout=30,
            )
            ok = "libvmaf" in out.stdout
        except (OSError, subprocess.TimeoutExpired):
            ok = False
    _vmaf_probe_cache[ffmpeg] = ok
    return ok


def vmaf(path_a: str, path_b: str, ffmpeg: str = "ffmpeg") -> float | None:
    """VMAF score of an image FILE pair via ffmpeg's libvmaf filter
    (reference: scripts/imageQualityMetrics.sh:10-11). Returns None when no
    libvmaf-enabled ffmpeg is available or the score can't be parsed --
    callers treat VMAF as an optional extra next to PSNR/SSIM.
    """
    if not vmaf_available(ffmpeg):
        return None
    try:
        out = subprocess.run(
            [ffmpeg, "-hide_banner", "-i", path_a, "-i", path_b,
             "-lavfi", "libvmaf", "-f", "null", "/dev/null"],
            capture_output=True, text=True, timeout=300,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    m = _VMAF_RE.search(out.stderr) or _VMAF_RE.search(out.stdout)
    return float(m.group(1)) if m else None


def compare_images(a: np.ndarray, b: np.ndarray) -> dict[str, float]:
    return {"psnr": psnr(a, b), "ssim": ssim(a, b)}


def compare_files(path_a: str, path_b: str, *, with_vmaf: bool = True) -> dict:
    """PSNR/SSIM (+VMAF when available) of two image files."""
    from ..io import codec

    a = codec.decode(path_a)[:, :, :3]
    b = codec.decode(path_b)[:, :, :3]
    result: dict = compare_images(a, b)
    if with_vmaf:
        score = vmaf(path_a, path_b)
        if score is not None:
            result["vmaf"] = score
    return result
