#!/usr/bin/env python3
"""Run one cell of the benchmark of ``lfinterpolator_tpu_torch`` and print
its result as the last line of standard output.

    python3 lfibench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run, from the root of a checkout:
  1. builds the port's kernels if ``build/kernels/liblfi_kernels.so`` is
     stale (``ops/_build.py``; the library stays in the checkout);
  2. makes the cell's scene from the seed on the card, hands it to the
     program as host memory, and warms up the cell's own shapes (set-up,
     ``setup_s``, timed from the start of this script);
  3. drives the cell's traffic for ``--seconds``: every frame's latency and
     completion on the host clock; with ``--trace 1`` a profiler trace of a
     short steady sub-window (``tracing.py``);
  4. reads the device's peak memory, frees the program's state and holds a
     sample of the frames, drawn from the seed, to the plain reference
     (``reference/``): each number compared, with its limit, is printed as
     the last lines of standard error and under ``checks`` in the result;
  5. prints ``{"correct", "attempted", "failed", "metrics", "device"[,
     "breakdown"], "checks"}``: with ``--trace 0`` the cell's end-to-end
     metrics, with ``--trace 1`` its per-layer metrics.

The run fails (exit 1, no result) without a CUDA device, with fewer devices
than the cell asks for, when the program is not in the checkout, and when
``jax``, ``jaxlib``, ``flax`` or the JAX package (``lfinterpolator_tpu``)
is loaded once the window has closed. ``--rehearse`` runs the same steps
on the CPU at a tiny size (the program's plain path); it is no cell, and
its result carries no metrics.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

PROGRAM = "lfinterpolator_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "lfinterpolator_tpu")
TRACE_PATH = os.path.join(BENCH_DIR, "out", "trace.json")
#: Every frame's (asked, received) host times of the last run, overwritten.
FRAMES_PATH = os.path.join(BENCH_DIR, "out", "frames.json")
#: The traced sub-window starts this share of the way into the window and
#: lasts this share of it, at most TRACE_MAX_S.
TRACE_AFTER, TRACE_SHARE, TRACE_MAX_S = 0.25, 0.25, 2.0
#: The answers kept for the check are drawn from the first frames a run at
#: this rate would complete (on the card; in a rehearsal on the CPU, 1/s).
SAMPLE_FPS_FLOOR = 10
#: The rehearsal's image size.
REHEARSAL_HW = (24, 40)


class SpecError(Exception):
    """A cell, configuration, traffic mix or metric that is not found."""


def load_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise SpecError(f"{os.path.relpath(path, ROOT)} not found")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``lfibench/<kind>/<name>.py`` (a traffic generator or a
    metric's reader), found by its name."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise SpecError(f"no {kind} file for {name!r}: lfibench/{kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"lfibench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark() -> dict:
    """``BENCHMARK.json``, with every configuration, traffic mix, generator and
    metric it names checked to be there."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for cfg in bench["configs"]:
        load_json(os.path.join(ROOT, cfg["file"]))
    names = {c["name"] for c in bench["configs"]}
    for cell in bench["workloads"]:
        if cell["config"] not in names:
            raise SpecError(f"cell {cell['name']}: no configuration {cell['config']!r}")
        mix = load_json(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json"))
        if not os.path.isfile(os.path.join(BENCH_DIR, "traffic", f"{mix['generator']}.py")):
            raise SpecError(f"traffic {cell['traffic']}: no generator {mix['generator']!r}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not os.path.isfile(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py")):
            raise SpecError(f"no metrics file for {m['name']!r}")
    return bench


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: with `trace` the per-layer
    ones, else the end-to-end ones, each where its ``workloads`` (if given)
    name the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


class Run:
    """What a traffic generator sees of a run: the seed's random numbers, the
    configuration and mix, the program's render settings, and the record
    it fills -- frames, attempts, failures and the answers kept for the
    check."""

    def __init__(self, config: dict, mix: dict, seed: int, seconds: float,
                 device, tracer=None):
        import torch

        self.config, self.mix, self.seconds = config, mix, seconds
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.scene_seed = int(self.rng.integers(0, 2 ** 62))
        floor = SAMPLE_FPS_FLOOR if self.device.type == "cuda" else 1
        n = max(int(mix["samples"]), int(floor * seconds))
        self.samples = set(int(i) for i in self.rng.choice(n, int(mix["samples"]), replace=False))
        self.tracer = tracer
        self.scenes: list[np.ndarray] = []
        self.frames: list[tuple[float, float]] = []
        self.answers: list[dict] = []
        self.attempted = self.failed = 0
        self.errors: list[str] = []
        self.t_start = self.t_end = None

    def render_config(self, **kw):
        """The program's ``RenderConfig`` of this configuration."""
        from lfinterpolator_tpu_torch.core.config import RenderConfig

        c = self.config
        return RenderConfig(
            method=c["method"], effect=c["effect"], aspect=c["aspect"],
            view_count=c["views"], focus_steps=c["focus_steps"],
            focus_map_views=c["focus_map_views"],
            pixel_size_factor=c["pixel_size_factor"],
            filter_radius_divisor=c["filter_radius_divisor"],
            exact_focus_taps=c["exact_focus_taps"], **kw)

    def make_scenes(self, shifts: list[tuple[float, float]]) -> None:
        """The scene of this seed with its occluders moved by each of
        `shifts` (dy, dx) px, made on the device, as host arrays
        [G, H, W, 3] uint8 in ``self.scenes``."""
        import torch
        from lfibench.scene import OcclusionScene, plane_foci

        c, s = self.config, self.config["scene"]
        window = c["allfocus"]
        scene = OcclusionScene(c["cols"], c["rows"], c["height"], c["width"],
                               plane_foci(window["focus"], window["focus_range"],
                                          c["focus_steps"]),
                               s["n_occluders"], self.scene_seed, self.device)
        self.scenes = [scene.frame(sh).cpu().numpy() for sh in shifts]
        del scene
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def prewarm_pinned(self, shapes: list[tuple], count: int) -> None:
        """Leave `count` pinned host blocks of each shape in the caching
        host allocator, so that answers kept for the check never make the
        program wait for a fresh pinned allocation inside the window."""
        import torch

        if self.device.type != "cuda":
            return
        held = [torch.empty(s, dtype=torch.uint8, pin_memory=True)
                for s in shapes for _ in range(count)]
        del held

    def start(self) -> None:
        self.t_start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def trace_step(self) -> None:
        if self.tracer is not None:
            self.tracer.step(self.elapsed())

    def span(self, name: str):
        """A profiler span while the trace runs, else nothing."""
        import torch

        if self.tracer is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def frame(self, t0: float, t1: float) -> None:
        """One frame's result reached the caller: asked for at `t0`,
        received at `t1` (host clock)."""
        self.frames.append((t0, t1))
        self.t_end = t1
        if self.tracer is not None:
            self.tracer.frame()

    def keep(self, index: int) -> bool:
        return index in self.samples

    def fail(self, error: BaseException) -> None:
        self.failed += 1
        self.errors.append(f"{type(error).__name__}: {error}")


class Record:
    """What a metric's reader reads: the run's frames and window, set-up,
    the configuration and mix, and the trace (None untraced)."""

    def __init__(self, run: Run, setup_s: float, trace):
        self.config, self.mix = run.config, run.mix
        self.frames, self.t_start, self.t_end = run.frames, run.t_start, run.t_end
        self.setup_s, self.trace = setup_s, trace


def check(run: Run) -> tuple[dict, int]:
    """Hold each kept answer to the reference -> ({number: total over the
    answers}, answers checked)."""
    import torch
    from lfibench.reference import render

    totals: dict[str, int] = {}
    for ans in run.answers:
        planar = (torch.from_numpy(run.scenes[ans["frame"]]).to(run.device)
                  .permute(0, 3, 1, 2).contiguous())
        ref = render.render(run.config, planar, ans["trajectory"], ans["focus"],
                            ans["focus_range"])
        maps = ans.get("maps")
        numbers = render.compare(
            ref, torch.from_numpy(np.ascontiguousarray(ans["views"])).to(run.device),
            None if maps is None else torch.from_numpy(np.ascontiguousarray(maps)).to(run.device))
        for k, v in numbers.items():
            totals[k] = totals.get(k, 0) + v
        del planar, ref
    return totals, len(run.answers)


def foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="the same steps on the CPU at a tiny size; no metrics")
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"lfibench: {msg}", file=sys.stderr)
    return 1


def open_cell(workload: str, rehearse: bool) -> tuple:
    """-> (BENCHMARK.json, the cell, its configuration, its traffic mix,
    the mix's generator, the device). Raises SpecError for a name that is not
    found, and RuntimeError without the card (or the devices) the cell
    needs, unless `rehearse`: then the CPU, at a tiny size."""
    bench = load_benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = load_json(os.path.join(ROOT, next(
        c["file"] for c in bench["configs"] if c["name"] == cell["config"])))
    mix = load_json(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json"))
    gen = load_module("traffic", mix["generator"])
    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        raise SpecError(f"the program ({PROGRAM}) is not in this checkout")

    import torch

    if rehearse:
        h, w = REHEARSAL_HW
        return bench, cell, dict(config, height=h, width=w, rehearsal=True), mix, gen, \
            torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        raise RuntimeError(f"the cell needs {cell['chips']} CUDA devices, "
                           f"{torch.cuda.device_count()} are present")
    return bench, cell, config, mix, gen, torch.device("cuda", 0)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        bench, cell, config, mix, gen, device = open_cell(args.workload, args.rehearse)
        readers = {m["name"]: load_module("metrics", m["name"])
                   for m in cell_metrics(bench, cell["name"], bool(args.trace))}
    except (SpecError, RuntimeError) as e:
        return fail(str(e))

    import torch
    import lfinterpolator_tpu_torch as program

    if not os.path.abspath(program.__file__).startswith(os.path.join(ROOT, PROGRAM)):
        return fail(f"{PROGRAM} was imported from {program.__file__}, not this checkout")
    phases = {"imports": time.perf_counter() - _T0}
    if device.type == "cuda":
        from lfinterpolator_tpu_torch.ops import _build

        _build.load()
    phases["kernels"] = time.perf_counter() - _T0 - sum(phases.values())

    from lfibench import tracing

    tracer = None
    if args.trace:
        tracer = tracing.Tracer(TRACE_PATH, TRACE_AFTER * args.seconds,
                                min(TRACE_MAX_S, TRACE_SHARE * args.seconds))
        if device.type == "cuda":
            tracing.Tracer.warm_up()
    seed = args.seed % 2 ** 63
    run = Run(config, mix, seed, args.seconds, device, tracer)
    phases["profiler"] = time.perf_counter() - _T0 - sum(phases.values())
    gen.make_scenes(run)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    phases["scene"] = time.perf_counter() - _T0 - sum(phases.values())
    state = gen.setup(run)
    from lfinterpolator_tpu_torch.utils import profiling

    profiling.reset_launch_counts()
    setup_s = time.perf_counter() - _T0
    phases["program"] = setup_s - sum(phases.values())

    gen.window(run, state)
    if tracer is not None:
        tracer.stop()
    launches = profiling.launch_counts()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    lat = sorted(t1 - t0 for t0, t1 in run.frames)
    os.makedirs(os.path.dirname(FRAMES_PATH), exist_ok=True)
    with open(FRAMES_PATH, "w") as f:
        json.dump({"cell": cell["name"], "seed": args.seed, "t_start": run.t_start,
                   "frames": run.frames}, f)
    print(f"frames {len(lat)} in {run.t_end - run.t_start if lat else 0.0!r} s; "
          f"latency median {1e3 * float(np.median(lat)) if lat else 0.0!r} ms; "
          f"setup {setup_s!r} s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr)
    print("launches per frame: " + json.dumps(
        {k: v / len(lat) for k, v in launches.items() if v} if lat else {}), file=sys.stderr)
    for e in run.errors[:5]:
        print(f"failed: {e}", file=sys.stderr)

    trace = tracing.Trace(TRACE_PATH, tracer.frames) if tracer is not None and tracer.done else None
    record = Record(run, setup_s, trace)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        value = readers[m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    t_check = time.perf_counter()
    totals, checked = check(run)
    limits = mix["limits"]
    missing = set(limits) ^ set(totals) if checked else set()
    checks = {k: {"value": totals.get(k), "limit": limits.get(k)} for k in sorted(limits)}
    correct = (checked > 0 and not missing and run.failed == 0 and bool(lat)
               and all(totals[k] <= limits[k] for k in limits))
    print(f"check: {checked} answers of frames {sorted(run.samples)} against the "
          f"reference in {time.perf_counter() - t_check!r} s", file=sys.stderr)

    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed}
    if args.rehearse:
        print(f"rehearsal on the CPU, no device numbers: the readers of {sorted(metrics)} ran",
              file=sys.stderr)
        result["metrics"] = {}
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    else:
        result["metrics"] = metrics
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": 1, "memory_peak_bytes": int(peak)}
    if trace is not None:
        if not args.rehearse:
            result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks

    foreign = foreign_modules()
    if foreign:
        return fail(f"loaded once the window closed: {', '.join(foreign)}")
    if missing:
        print(f"check: numbers without a limit or not compared: {sorted(missing)}",
              file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(f"check answers {checked} at least 1", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
