"""What the harness and the reference load: never ``jax``, ``jaxlib``,
``flax`` or the JAX package (``lfinterpolator_tpu``), compared by the whole
top-level name of each module; and nothing of the program under test
(``lfinterpolator_tpu_torch``) in the reference."""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

from lfibench import run as harness

ROOT = harness.ROOT

_LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set[str]:
    """The top-level names of the modules a fresh interpreter holds after
    running `body`."""
    proc = subprocess.run([sys.executable, "-c", _LOADED.format(root=ROOT, body=body)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_and_every_harness_module_load_no_jax():
    metrics = [os.path.basename(p)[:-3] for p in glob.glob(f"{ROOT}/lfibench/metrics/*.py")]
    generators = [os.path.basename(p)[:-3] for p in glob.glob(f"{ROOT}/lfibench/traffic/*.py")]
    body = f"""
import io, contextlib
from lfibench import run, control, tracing, roofline, scene
from lfibench.reference import render, geometry
for m in {metrics!r}:
    run.load_module("metrics", m)
for d in {generators!r}:
    run.load_module("traffic", d)
with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
    assert run.main(["--workload", "lf8x8_1080p.allfocus_api", "--seed", "3",
                     "--seconds", "1", "--trace", "1", "--rehearse"]) == 0
"""
    names = loaded(body)
    assert "lfinterpolator_tpu_torch" in names and "torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded("from lfibench.reference import render, geometry")
    assert not names & ({"lfinterpolator_tpu_torch"} | set(harness.FORBIDDEN))
    for path in glob.glob(f"{ROOT}/lfibench/reference/*.py"):
        with open(path) as f:
            assert "import lfinterpolator" not in f.read() and "from lfinterpolator" not in path


def test_the_whole_name_is_compared():
    """``lfinterpolator_tpu_torch`` begins with the JAX package's name, and
    is not it."""
    sys.modules.setdefault("lfinterpolator_tpu_torch_probe", sys)
    try:
        assert "lfinterpolator_tpu_torch_probe" not in harness.foreign_modules()
    finally:
        del sys.modules["lfinterpolator_tpu_torch_probe"]
    assert all(m.split(".")[0] in harness.FORBIDDEN for m in harness.foreign_modules())
