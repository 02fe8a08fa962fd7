"""Build and load the port's CUDA kernels.

The sources in ``lfinterpolator_tpu_torch/csrc/*.cu`` expose a plain C
interface. At first use each is compiled with ``nvcc`` for Hopper
(``sm_90a``) into an object, all sources at once in parallel processes,
and the objects are linked into ``build/kernels/liblfi_kernels.so`` at the
root of the checkout, loaded with ``ctypes``. Nothing here runs at import
time, and nothing is taken from outside the checkout but ``nvcc`` itself
(found on ``PATH``, else under ``$CUDA_HOME`` or ``/usr/local/cuda``).

``launch`` is the one caller of an entry that launches work: the entries'
C signatures, their stream argument and their error codes are known here
alone. The wrappers call the limit queries (``lfi_*_max_grid``,
``lfi_blend_grid_passes``, ...) on ``load()`` directly.

A library newer than every source and header is reused, so a second
process (the CLI after a script that already built) does not compile
again. A failed build raises with nvcc's own stderr and leaves nothing
behind.
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "liblfi_kernels.so")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: nvcc's output of the last build in this process ("" if none ran): one
#: ptxas report (registers, shared memory, spills) for every kernel.
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
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in srcs + headers)


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise on the first that fails.

    Returns each command's stderr + stdout."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for cmd in cmds
    ]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{err}{out}"
            )
    return [err + out for out, err in outs]


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH (if stale or `force`); return it."""
    global build_log
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    if not force and not _stale(srcs):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    # Objects and the library are built in a private directory, then the
    # library is renamed into place: a concurrent process never loads a
    # half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [
            os.path.join(work, os.path.basename(s)[: -len(".cu")] + ".o")
            for s in srcs
        ]
        logs = _run([
            [nvcc, *COMPILE_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs)
        ])
        tmp = os.path.join(work, os.path.basename(LIB_PATH))
        logs += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, LIB_PATH)
    build_log = "".join(logs)
    return LIB_PATH


def spills() -> dict[str, int]:
    """Bytes of register spills (stores + loads) of each kernel of the last
    build in this process, by mangled name, from ptxas's report."""
    found = re.findall(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads", build_log, flags=re.S)
    return {name: int(stores) + int(loads) for name, stores, loads in found}


def tensor_core_instructions() -> dict[str, int]:
    """The number of tensor-core instructions (HMMA, HGMMA) in the SASS of
    each kernel of the built library, by mangled name (``cuobjdump -sass``,
    which stands beside nvcc)."""
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build()], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        started = re.search(r"Function : (\w+)", line)
        if started:
            name = started.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    return counts


def load() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            signatures = {
                # (img, w, shifts, out, G, C, H, W, V, r0, hb, stream)
                "lfi_shift_blend": [ptr] * 4 + [i32] * 7 + [ptr],
                # (img, w, offs, map, decode, out, G, C, H, W, V, r0, hb, stream)
                "lfi_allfocus_blend": [ptr] * 6 + [i32] * 7 + [ptr],
                # (planar, words, K, C, P, stream)
                "lfi_rgbx_pack": [ptr] * 2 + [i32] * 2 + [ctypes.c_int64, ptr],
                # (views, offs, cands, d, K, H, W, n, rx, ry, r0, hb, stream)
                "lfi_focus_cheby_map": [ptr] * 4 + [i32] * 8 + [ptr],
                # (views, offs, cands, cand_bytes, d, row_clean, col_clean,
                #  best, out, K, H, W, S, rx, ry, r0, hb, c0, n, stream)
                "lfi_focus_estimate": [ptr] * 9 + [i32] * 10 + [ptr],
                # (views, offs, cands, cand_bytes, d, row_clean, col_clean,
                #  best, pres, out, K, H, W, S, rx, ry, c0, n, tb, wco, sc,
                #  nb, n_wc, cc, stream)
                "lfi_focus_estimate_pres": [ptr] * 10 + [i32] * 14 + [ptr],
                # (img, w, shifts, canvas, G, C, H, W, cols, rows, stream)
                "lfi_quilt_blend": [ptr] * 4 + [i32] * 6 + [ptr],
                # (tiles, canvas, C, th, tw, cols, rows, stream)
                "lfi_quilt_copy": [ptr] * 2 + [i32] * 5 + [ptr],
                # (dst, dst_pitch, src, src_pitch, width, height, stream)
                "lfi_copy_rows_to_host": [ptr, i64, ptr, i64, i64, i64, ptr],
                "lfi_shift_blend_max_grid": [],
                "lfi_allfocus_blend_max_grid": [],
                # (G): passes over the images; shared memory; blocks per SM
                "lfi_blend_grid_passes": [i32],
                "lfi_shift_blend_smem_bytes": [i32],
                "lfi_allfocus_blend_smem_bytes": [i32],
                "lfi_shift_blend_blocks_per_sm": [i32],
                "lfi_allfocus_blend_blocks_per_sm": [i32],
                "lfi_focus_estimate_max_views": [],
                "lfi_focus_estimate_max_steps": [],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = i32
            lib.lfi_cuda_error_string.argtypes = [i32]
            lib.lfi_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(entry: str, device, *args) -> None:
    """Call the C entry `entry` with `args` and `device`'s current stream
    as its last argument, with `device` current. Raises RuntimeError with
    the CUDA error's text unless the launch was taken."""
    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{entry} launch failed: CUDA error {err} "
            f"({lib.lfi_cuda_error_string(err).decode()})"
        )
