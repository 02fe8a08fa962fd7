"""Import hygiene and the build's failure paths of lfinterpolator_tpu_torch.

The port never imports jax, importing it builds nothing, `device="cuda"`
without a card raises, and a failing nvcc raises with its own stderr.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from lfinterpolator_tpu.io.loader import LightField
from lfinterpolator_tpu_torch.ops import _build

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_nvcc(directory, body: str) -> str:
    path = os.path.join(directory, "nvcc")
    with open(path, "w") as f:
        f.write("#!/bin/sh\n" + body + "\n")
    os.chmod(path, 0o755)
    return path


def test_package_imports_no_jax_and_builds_nothing(tmp_path):
    marker = tmp_path / "nvcc_ran"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    _fake_nvcc(str(bindir), f"touch {marker}; exit 1")
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import lfinterpolator_tpu_torch as pkg
        from lfinterpolator_tpu_torch import cli, io, state
        from lfinterpolator_tpu_torch.api import Interpolator
        from lfinterpolator_tpu_torch.io import LightField
        from lfinterpolator_tpu_torch.models import pipeline
        from lfinterpolator_tpu_torch.ops import (
            _build, allfocus_blend, blend_torch, focus_estimate, focus_torch,
            shift_blend)
        from lfinterpolator_tpu_torch.utils import profiling
        assert pkg.Interpolator is Interpolator
        rng = np.random.default_rng(0)
        lf = LightField(rng.integers(0, 256, (4, 8, 12, 4), dtype=np.uint8), 2, 2)
        interp = Interpolator(lf, device="cpu", progress=False,
                              config=pkg.RenderConfig(focus_map_views=4))
        res = interp.interpolate("0,0,1,1", focus=0.5, method="TEN", progress=False)
        assert res.views.shape == (64, 8, 12, 3)
        for method in ("TEN", "STD"):
            res = interp.interpolate("0,0,1,1", focus=0.1, focus_range=0.3,
                                     method=method, progress=False)
            assert res.views.shape == (64, 8, 12, 3) and res.maps.shape == (2, 8, 12)
        bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ)
    env["PATH"] = f"{bindir}{os.pathsep}{env.get('PATH', '')}"
    env["CUDA_HOME"] = str(tmp_path)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
    assert not marker.exists(), "importing or a CPU render invoked nvcc"


def test_cuda_device_without_cuda_raises(monkeypatch):
    from lfinterpolator_tpu_torch.api import Interpolator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lf = LightField(np.zeros((4, 8, 12, 4), np.uint8), 2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Interpolator(lf, device="cuda", progress=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Interpolator(lf, progress=False)  # cuda is the default
    with pytest.raises(ValueError, match="cpu or cuda"):
        Interpolator(lf, device="meta", progress=False)


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(str(tmp_path), "echo 'shift_blend.cu(7): error: boom' >&2; exit 2")
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "LIB_PATH", str(tmp_path / "kernels" / "lib.so"))
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed \(exit 2\).*error: boom"):
        _build.build(force=True)
    assert not os.listdir(tmp_path / "kernels")  # no half-written library


def test_build_command_targets_hopper_from_repo_sources(tmp_path, monkeypatch):
    args_file = tmp_path / "args"
    nvcc = _fake_nvcc(
        str(tmp_path),
        f'echo "$@" >> {args_file}; prev=""; '
        'for a; do [ "$prev" = "-o" ] && touch "$a"; prev=$a; done; exit 0',
    )
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "LIB_PATH", str(tmp_path / "kernels" / "lib.so"))
    assert _build.build(force=True) == str(tmp_path / "kernels" / "lib.so")
    calls = [line.split() for line in args_file.read_text().splitlines()]
    # one compile per source, then one link of their objects
    compiles, link = calls[:-1], calls[-1]
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert all("-c" in c and "-v" in c for c in compiles) and "-shared" in link
    srcs = [a for c in compiles for a in c if a.endswith(".cu")]
    assert sorted(srcs) == _build.sources() and len(srcs) == len(compiles)
    assert all(s.startswith(os.path.join(ROOT, "lfinterpolator_tpu_torch", "csrc"))
               for s in srcs)
    assert {"shift_blend.cu", "allfocus_blend.cu", "focus_estimate.cu"} <= {
        os.path.basename(s) for s in srcs}
    # the compiles run in parallel, so they log in any order
    assert sorted(a for a in link if a.endswith(".o")) == sorted(
        a for c in compiles for i, a in enumerate(c) if c[i - 1] == "-o")
    assert os.listdir(tmp_path / "kernels") == ["lib.so"]  # no objects left
    # a library newer than every source is reused without running nvcc
    args_file.unlink()
    assert _build.build() == _build.LIB_PATH and not args_file.exists()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
