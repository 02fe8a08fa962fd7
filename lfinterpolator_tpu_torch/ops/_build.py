"""Build and load the port's CUDA kernels.

The sources in ``lfinterpolator_tpu_torch/csrc/*.cu`` expose a plain C
interface. At first use they are compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/libshift_blend.so`` at the root of the
checkout and loaded with ``ctypes``. Nothing here runs at import time, and
nothing is taken from outside the checkout but ``nvcc`` itself (found on
``PATH``, else under ``$CUDA_HOME`` or ``/usr/local/cuda``).

A library newer than every source is reused, so a second process (the CLI
after a script that already built) does not compile again. A failed build
raises with nvcc's own stderr.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libshift_blend.so")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: nvcc's output of the last build in this process ("" if none ran).
build_log: str = ""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _stale(srcs: list[str]) -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in srcs)


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH (if stale or `force`); return it."""
    global build_log
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    if not force and not _stale(srcs):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name, then rename: a concurrent process never
    # loads a half-written library.
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, LIB_PATH)
    build_log = proc.stderr + proc.stdout
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.lfi_shift_blend.argtypes = [
                ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
            ]
            lib.lfi_shift_blend.restype = i32
            lib.lfi_shift_blend_max_grid.argtypes = []
            lib.lfi_shift_blend_max_grid.restype = i32
            lib.lfi_cuda_error_string.argtypes = [i32]
            lib.lfi_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
