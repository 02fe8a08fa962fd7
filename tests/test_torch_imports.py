"""Import hygiene and the build's failure paths of lfinterpolator_tpu_torch.

The port never imports jax nor any module of the JAX package
(``lfinterpolator_tpu``), importing it builds nothing, its imports point
down its layers, `device="cuda"` without a card raises, a failing nvcc
raises with its own stderr, and a kernel launch that the driver refuses
raises with the CUDA error's text.
"""

import ast
import contextlib
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from lfinterpolator_tpu_torch.io import LightField
from lfinterpolator_tpu_torch.ops import _build

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "lfinterpolator_tpu_torch"
PKG_DIR = os.path.join(ROOT, PKG)

#: The port's layers, top first. A module imports modules of its own layer
#: and of the layers below it, never of a layer above. A module is named by
#: its path under the package (``ops.shift_blend``, ``parallel.__init__``);
#: ``x.*`` is every module under ``x/``. core/, models/ and utils/ have
#: empty package files, which sit at the bottom.
LAYERS = [
    ["__init__", "cli", "api", "streaming", "parallel.*"],
    ["state", "core.capacity", "utils.transfer"],
    ["models.pipeline"],
    ["ops.*"],
    ["core.geometry", "core.config", "io.*", "utils.profiling", "utils.devices",
     "utils.progress", "utils.scenes", "utils.metrics",
     "core.__init__", "models.__init__", "utils.__init__"],
]
#: Beyond the layers: the mesh renders through the pipeline and the ops and
#: holds no host state, so it imports nothing of ``state`` either.
FORBIDDEN = {"parallel.*": {"state"}}


def _modules() -> list[str]:
    found = []
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f[:-3]), PKG_DIR)
                found.append(rel.replace(os.sep, "."))
    return sorted(found)


def _matches(name: str, pattern: str) -> bool:
    return name.startswith(pattern[:-1]) if pattern.endswith(".*") else name == pattern


def _layer(name: str) -> int:
    layers = [i for i, layer in enumerate(LAYERS) if any(_matches(name, p) for p in layer)]
    assert len(layers) == 1, f"{name} must sit in one layer of LAYERS, not {layers}"
    return layers[0]


def _as_module(dotted: str) -> str | None:
    """``lfinterpolator_tpu_torch.x.y`` -> the module ``x.y`` or
    ``x.y.__init__`` it names; None where it names no file of the package."""
    rel = dotted[len(PKG) + 1:].replace(".", os.sep) if dotted != PKG else ""
    base = os.path.join(PKG_DIR, rel)
    if os.path.isfile(os.path.join(base, "__init__.py")):
        return (rel.replace(os.sep, ".") + ".__init__").lstrip(".")
    if os.path.isfile(base + ".py"):
        return rel.replace(os.sep, ".")
    return None


def _imported(module: str) -> set[str]:
    """Every module of the package that `module` imports, at its top or
    inside a function: ``from x import y`` names the module ``x.y`` where
    there is one, else ``x``."""
    path = os.path.join(PKG_DIR, module.replace(".", os.sep) + ".py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    package = [PKG, *module.split(".")[:-1]]
    targets = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            targets += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(package[:len(package) - node.level + 1]) if node.level else ""
            base = ".".join(filter(None, [base, node.module]))
            for a in node.names:
                targets.append(f"{base}.{a.name}" if _as_module(f"{base}.{a.name}")
                               else base)
    return {_as_module(t) for t in targets
            if (t == PKG or t.startswith(PKG + ".")) and _as_module(t) is not None}


def _fake_nvcc(directory, body: str) -> str:
    path = os.path.join(directory, "nvcc")
    with open(path, "w") as f:
        f.write("#!/bin/sh\n" + body + "\n")
    os.chmod(path, 0o755)
    return path


def test_package_imports_no_jax_and_builds_nothing(tmp_path):
    """A walk through every entry point and script on the CPU, a world-1
    gloo mesh included: no jax, no module of the JAX package, no nvcc."""
    marker = tmp_path / "nvcc_ran"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    _fake_nvcc(str(bindir), f"touch {marker}; exit 1")
    script = textwrap.dedent(f"""
        ROOT = {ROOT!r}
    """) + textwrap.dedent("""
        import os
        import sys
        import numpy as np
        import lfinterpolator_tpu_torch as pkg
        from lfinterpolator_tpu_torch import cli, io, state, streaming
        from lfinterpolator_tpu_torch.core import capacity, config, geometry
        from lfinterpolator_tpu_torch.api import Interpolator
        from lfinterpolator_tpu_torch.io import LightField
        from lfinterpolator_tpu_torch.models import pipeline
        from lfinterpolator_tpu_torch.ops import (
            _build, allfocus_blend, blend_torch, estimate_geometry, focus_estimate,
            focus_torch, quilt, quilt_torch, shift_blend)
        from lfinterpolator_tpu_torch.ops import reference
        from lfinterpolator_tpu_torch.utils import (
            devices, metrics, profiling, progress, scenes, transfer)
        assert pkg.Interpolator is Interpolator
        # slice 6: every script of the port imports, and the gate runs
        import importlib.util
        scripts = {}
        for name in ("quality_gate", "bench_8k", "map_refresh_quality", "render_video",
                     "validate_batching", "views_to_quilt", "image_quality_metrics",
                     "compare_dirs", "focus_map_compare"):
            path = os.path.join(ROOT, "scripts", f"torch_{name}.py")
            spec = importlib.util.spec_from_file_location(name, path)
            scripts[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(scripts[name])
        gate = scripts["quality_gate"].run_gate((48, 64), (4, 4), "plane", "cpu")
        assert gate["pass"], gate
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
            q = interp.render_quilt("0,0,1,1", method=method, progress=False)
            assert q.quilt.shape == (72, 60, 3)
        res.save_quilt("quilt.png", tile_size=(4, 6))
        # the pyramid at a width it takes: 4 focus views, 8 candidates
        lf = LightField(rng.integers(0, 256, (4, 16, 512, 4), dtype=np.uint8), 2, 2)
        interp = Interpolator(lf, device="cpu", progress=False, config=pkg.RenderConfig(
            focus_map_views=4, focus_steps=8, focus_pyramid=True))
        res = interp.interpolate("0,0,1,1", focus=0.1, focus_range=0.3,
                                 method="TEN", progress=False)
        assert res.maps.shape == (2, 16, 512)
        # slice 4: batched trajectories, a forced view-batched render, a stream
        batch = interp.interpolate_batch(["0,0,1,1", "0.1,0.1,0.9,0.9"], focus=0.1,
                                         focus_range=0.3, progress=False)
        assert [r.views.shape for r in batch] == [(64, 16, 512, 3)] * 2
        os.environ["LFI_HBM_BYTES"] = str(3_000_000)
        assert interp._plan(64, "TEN", 0, 0, False).batched
        res = interp.interpolate("0,0,1,1", focus=0.2, method="TEN", progress=False)
        assert res.views.shape == (64, 16, 512, 3)
        del os.environ["LFI_HBM_BYTES"]
        sr = pkg.StreamingRenderer(2, 2, 12, 8, "0,0,1,1", device="cpu")
        frames = [rng.integers(0, 256, (4, 8, 12, 4), dtype=np.uint8)] * 2
        assert [v.shape for v in sr.render_stream(frames)] == [(64, 8, 12, 3)] * 2
        # slice 5: a world-1 gloo mesh render
        from lfinterpolator_tpu_torch.parallel import distributed, mesh
        distributed.initialize("file://" + os.path.abspath("store"), 1, 0,
                               backend="gloo", timeout_s=60)
        interp = Interpolator(lf, device="cpu", progress=False, mesh=mesh.make_mesh(),
                              config=pkg.RenderConfig(focus_map_views=4, focus_steps=8))
        res = interp.interpolate("0,0,1,1", focus=0.1, focus_range=0.3,
                                 method="TEN", progress=False)
        assert res.views.shape == (64, 16, 512, 3) and res.maps.shape == (2, 16, 512)
        import torch.distributed as dist
        dist.destroy_process_group()
        bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "lfinterpolator_tpu" or m.startswith("lfinterpolator_tpu.")]
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


@pytest.mark.parametrize("module", _modules())
def test_imports_point_down_the_layers(module):
    """No module of the port imports one of a layer above its own (LAYERS),
    nor what FORBIDDEN keeps from it: the bottom layer imports nothing of the
    package, and nothing below ``state`` reads the host state."""
    layer = _layer(module)
    forbidden = set().union(*(v for p, v in FORBIDDEN.items() if _matches(module, p)))
    above = sorted(m for m in _imported(module) if _layer(m) < layer or m in forbidden)
    assert not above, f"{module} (layer {layer + 1}) imports {above}"


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
    assert {"shift_blend.cu", "allfocus_blend.cu", "focus_estimate.cu", "quilt.cu"} <= {
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


def test_launch_passes_the_stream_last_and_raises_the_cuda_error(monkeypatch):
    """``_build.launch`` on a fake library: the entry runs with the device
    current and the device's current stream as its last argument; a
    launch the driver refuses raises with the entry and the error's text."""
    calls, devices = [], []

    class Lib:
        def lfi_quilt_copy(self, *args):
            calls.append(args)
            return 0 if len(calls) == 1 else 9

        def lfi_cuda_error_string(self, err):
            return f"error {err} text".encode()

    def current(device):
        devices.append(("current_stream", device))
        return types.SimpleNamespace(cuda_stream=77)

    def device_context(device):
        devices.append(("device", device))
        return contextlib.nullcontext()

    monkeypatch.setattr(_build, "load", Lib)
    monkeypatch.setattr(torch.cuda, "device", device_context)
    monkeypatch.setattr(torch.cuda, "current_stream", current)
    _build.launch("lfi_quilt_copy", "cuda:1", 1, None, 3)
    with pytest.raises(RuntimeError, match=r"^lfi_quilt_copy launch failed: "
                                           r"CUDA error 9 \(error 9 text\)$"):
        _build.launch("lfi_quilt_copy", "cuda:1", 4)
    assert calls == [(1, None, 3, 77), (4, 77)]
    assert devices == [("device", "cuda:1"), ("current_stream", "cuda:1")] * 2
