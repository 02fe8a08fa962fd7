"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's fixed-focus, all-in-focus (exact and coarse-to-fine),
quilt, batched, view-batched and streamed renders (lfinterpolator_tpu_torch)
and its scripts (scripts/torch_*.py: the quality gate, the 8K render, the
map-refresh harness, the video renderer) at the headline size -- an
8x8 grid of 1080x1920 images, 64 views; all in focus with K = 32 focus
views, 32 candidates, stencil radius (20, 10); quilts of 5x9 tiles --
through the kernel wrappers, the Interpolator API and the CLI. Phases, in
order; any failure raises and the script exits non-zero:

  1. card name and power limit (nvidia-smi), torch/CUDA versions, codec;
  2. build the CUDA kernels from lfinterpolator_tpu_torch/csrc/ (one nvcc
     per source, in parallel) and print ptxas's report of each kernel and
     the tensor-core instructions (HMMA/HGMMA) in each kernel's SASS: the
     blend kernels must hold some, and neither they nor the estimate
     kernels may spill;
  3. shift_blend at full size for focus 0.1, -0.35 and 5.0 (the last
     pushes shifts past the image): the near-tie rule against the exact
     float64 sums and at most 1 LSB from its plain PyTorch version on
     under 0.5% of the bytes; a 64-row weight matrix bit-equal to rows
     64-127 of a 192-row launch; kernel and plain timed with CUDA events;
  4. shift_blend against exact sums written in NumPy (the near-tie rule)
     on 4x4/48x64, 16x16/12x20 (G = 256) and 2x2/48x64 (G = 4) scenes,
     with the render's weights and with random ones;
  5. Interpolator end to end on a seeded 8x8/1080p light field: TEN (the
     kernel) at most 1 LSB from STD (plain ops), two views of each under
     the near-tie rule against the NumPy sums, kernel launches counted;
  6. (the fixed-focus CLI at a quarter of the resolution: phase 18's
     --quilt run, which writes the same 64 PNGs and the quilt);
  7. focus_estimate, both tap rules, against its plain version at full
     size (torch.equal): on a seeded random stack at focus 0.1, range 0.3,
     both timed, with the share of (candidate, pixel) pairs on the exact
     rule's nine-tap loop and the times of the map pass, the argmin pass
     and the nine-tap loop alone; on the same stack at the focus of a small
     sweep where that share is largest; and on a three-plane scene;
  8. allfocus_blend at full size, on phase 7's raw map and its filtered
     map: the near-tie rule against the exact sums of the selected stack
     and at most 1 LSB from its plain version; both timed;
  9. focus_estimate against a sequential NumPy oracle (bit-equal) and
     allfocus_blend against exact NumPy sums (the near-tie rule), on a
     4x4/48x64 scene; the blend also at G = 256 and G = 4 on random maps;
 10. the all-in-focus Interpolator on phase 5's light field (focus 0.1,
     range 0.3): TEN, STD and TEN with the fast tap rule, each timed,
     each kernel's launches counted, maps equal to the plain pipeline on
     the same tensors and views at most 1 LSB from it, map0 not constant;
 11. the all-in-focus CLI (-r 0.3) at full size: 64 PNGs, map0.png and
     map1.png that decode equal to phase 10's TEN render;
 12. the presence-predicated estimate against its plain version at full
     size, with a seeded random presence table of density ~0.5
     (torch.equal), timed beside the exact sweep;
 13. the coarse-to-fine estimate end to end against its plain version at
     full size on a three-plane scene (torch.equal): presence density,
     agreement with the exact sweep, and both timed;
 14. the pyramid through the Interpolator (--focus-pyramid, TEN): launches
     counted, maps equal to the plain pipeline, views at most 1 LSB;
 15. the quilt kernel at full size: its tiles bit-equal to shift_blend's
     views, the near-tie rule, at most 1 LSB from its plain version; timed
     beside shift_blend;
 16. the quilt tile copy against its plain version at full size
     (torch.equal), timed;
 17. render_quilt, fused (TEN) and two-stage (STD), each timed and its
     launches counted: the fused quilt equals the montage of the TEN
     views and is at most 1 LSB from the two-stage quilt;
 18. the CLI with --quilt-only and --quilt at a quarter of the resolution,
     and with -r 0.3 --focus-pyramid at 960x270 (half the columns, a
     quarter of the rows): PNGs equal to the API's;
 19. the download of one 64-view frame: pageable, a kept pinned buffer
     plus a copy out of it, the port's Downloader (pinned memory per
     download from the caching host allocator, utils/transfer.py), and the
     pinned copy alone;
 20. the streaming TEN path (K2's counterpart): 8 frames, each a roll of
     the seeded stack, prefetch 2, two passes (the first also allocates
     the pinned buffers); every frame torch.equal to a one-pass
     shift_blend and at most 1 LSB from the plain version on the card,
     shift_blend launched once a frame; the second pass's fps beside
     the serial sum of the host copy into pinned memory, upload, render
     and download, each measured alone;
 21. the all-focus stream, 3 frames at map refresh 1 and 2: equal to the
     Interpolator's renders, the first frame's maps also to the plain
     pipeline's and its views at most 1 LSB from them;
 22. render_to_dir at a quarter of the resolution: its PNGs decode equal
     to the stream's views;
 23. interpolate_batch at full size, 5 trajectories of 2 centers, fixed
     and all in focus: each result equal to its solo render, one blend
     and one estimate per group counted by launches;
 24. a forced view-batched render at full size (LFI_HBM_BYTES, >= 3
     batches), fixed and all in focus: equal to the one-pass render;
 25. the library yardsticks (library_ms): the blends' contraction alone as
     one torch.matmul (fp16; f32 with TF32 off), the tile copy as one
     permute().contiguous();
 26. the quality gate (scripts/torch_quality_gate.py) on the card, three
     runs in subprocesses, started here and read after phase 28 (the NumPy
     oracle's estimate on the host is most of each): the plane and the
     occlusion scene at the gate's size (6x6 at 192x256) and the plane at
     192x512, where the pyramid row runs; every gated row >= 45 dB, the
     maps equal to the oracle's, the dB of every row printed;
 27. scripts/torch_map_refresh_quality.py at 1080x1920, 4x4, 6 frames,
     refresh 4, at 2 and at 30 px/frame: strict JSON;
 28. scripts/torch_render_video.py on a seeded 4x4 tree of 3 frames at
     270x480: PNGs equal to the stream's views; --resume skips all 3;
 29. the 8K all-focus render (scripts/torch_bench_8k.py, TEN): an 8x8 grid
     of 4320x7680 images, 64 views, K = 32, under the card's real budget
     (the plan, its bytes beside max_memory_allocated, upload, estimate,
     blend, download, first and steady call) and its band check, alone on
     the card and the host;
 32. (run after phase 29) the multi-GPU path (slice 5) on one card: a
     (1, 1) mesh over NCCL in this process -- fixed TEN and STD, all in
     focus TEN and STD, --fast-focus, render_quilt (two-stage) and
     interpolate_batch of 3 trajectories, each equal to the same call
     without a mesh; launches counted, the NCCL init, the shard step and
     the one-device step timed -- then a (2, 2) mesh of four gloo ranks
     sharing the card (spawned after phase 2's build): each rank makes the
     seeded light field and renders fixed TEN, all-focus TEN and STD and
     --fast-focus, each equal (128-bit digests of views and maps) to the
     one-device render; each rank's launches, shard step (CUDA events),
     map and views all-gathers (host clock) and max_memory_allocated
     beside the per-rank byte arithmetic; four ranks time-sharing one
     card: not a scaling measurement;
 33. (run after phase 32) the Interpolator on a seeded 17x17 grid of
     1024x1024 images (289, past the reference tool's 256: both blends run
     in passes over the images), the occlusion scene of the benchmark's
     17x17 cells: fixed TEN at focus 0.2 and all in focus over 0.0 +- 0.07,
     each with the launch counts reset just before it, launches and passes
     counted (every launch all of lfi_blend_grid_passes(289)); the maps
     equal to the plain pipeline's; each blend wrapper on the render's
     inputs equal to the render, under the near-tie rule, at most 1 LSB
     from its plain version, both timed;
 30. no module of jax or of the JAX package is loaded;
 31. the kernels line (each kernel's time, plain time, bound and library
     time; the launches of phases 26-29 beside the main path's, and phase
     32's in `launches_mesh`; phase 33's two blends of 289 images, with
     their launches and passes), then the last line:
     {"ok": true, "device": {...}}.

Exits 1 at once when no CUDA device is present. Needs one GPU, no network.
Imports only the port (lfinterpolator_tpu_torch), never jax nor the JAX
package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

from lfinterpolator_tpu_torch.utils.profiling import event_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAJECTORY = "0,0,1,1"
EFFECT = 3.0
COLS = ROWS = 8
H, W = 1080, 1920
VIEWS = 64
SEED = 0


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print `msg` with the seconds since the script started."""
    print(f"{msg} @{time.perf_counter() - T0:.1f}s", flush=True)


def phase1_environment(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from lfinterpolator_tpu_torch import io

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"codec {io.codec_name()}")
    return smi


def phase2_build() -> None:
    from lfinterpolator_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load()
    log(f"[2] built {_build.LIB_PATH} from {len(_build.sources())} sources "
        f"in {time.perf_counter() - t0:.2f} s")
    log(_build.build_log.strip())
    blend = lambda table: {k: v for k, v in table.items() if "blend_kernel" in k}
    spills, mma = blend(_build.spills()), blend(_build.tensor_core_instructions())
    log(f"[2] blend kernels: spill bytes {list(spills.values())}; tensor-core "
        f"instructions (HMMA/HGMMA in cuobjdump -sass) {mma}")
    # shift_blend, its quilt instantiation and allfocus_blend, each built for
    # one pass over the images and with later passes
    if len(spills) != 6 or any(spills.values()):
        raise AssertionError(f"a blend kernel spills registers: {spills}")
    if len(mma) != 6 or not all(mma.values()):
        raise AssertionError(f"a blend kernel holds no tensor-core instruction: {mma}")
    est = {k: v for k, v in _build.spills().items() if "cheby_map" in k or "argmin" in k}
    log(f"[2] estimate kernels (map pass, argmin pass x 3): spill bytes {list(est.values())}")
    if len(est) != 4 or any(est.values()):
        raise AssertionError(f"an estimate kernel spills or is missing: {est}")


def weights_and_shifts(cols, rows, h, w, focus):
    from lfinterpolator_tpu_torch.state import render_params

    return render_params(TRAJECTORY, cols=cols, rows=rows, height=h, width=w,
                         focus=focus, effect=EFFECT, views=VIEWS)


def oracle(np, images, wm, fo):
    """[G, H, W, >=3] u8 x [V, G] x [G, 2] (dx, dy) -> [V, H, W, 3] float64.

    The exact sums of the fixed-focus blend (every product of a u8 and an
    fp16-valued weight, and their sum, is exact in float64), written out
    here without torch so that they are independent of the code under
    test. A blend's bytes are held to them by the near-tie rule."""
    g_count, h, w = images.shape[:3]
    acc = np.zeros((wm.shape[0], h, w, 3), dtype=np.float64)
    for g in range(g_count):
        ys = np.clip(np.arange(h) + int(fo[g, 1]), 0, h - 1)
        xs = np.clip(np.arange(w) + int(fo[g, 0]), 0, w - 1)
        px = images[g][np.ix_(ys, xs)][..., :3].astype(np.float64)
        acc += wm[:, g].astype(np.float64)[:, None, None, None] * px[None]
    return acc


def check_rule(torch, name, got, stack, weights) -> dict:
    """The near-tie rule (blend_torch.check_bytes) on the views `got`
    [V, C, H, W] against the exact float64 sums of `stack` [G, C, H, W] (the
    shifted or selected images) under `weights`, one channel at a time."""
    from lfinterpolator_tpu_torch.ops import blend_torch

    counts = {"bytes": 0, "lax": 0, "ties_off": 0}
    for c in range(got.shape[1]):
        try:
            part = blend_torch.check_bytes(
                got[:, c], blend_torch.exact_sums(stack[:, c], weights))
        except AssertionError as e:
            raise AssertionError(f"{name}, channel {c}: {e}") from None
        counts = {k: counts[k] + part[k] for k in counts}
    return counts


def check_rule_np(torch, name, got_hwc, sums) -> dict:
    """The near-tie rule on [V, H, W, 3] bytes (numpy or tensor) against
    NumPy's exact sums of the same shape."""
    from lfinterpolator_tpu_torch.ops import blend_torch

    got = torch.as_tensor(got_hwc).cpu()
    try:
        return blend_torch.check_bytes(got, torch.from_numpy(sums))
    except AssertionError as e:
        raise AssertionError(f"{name}: {e}") from None


def check_1lsb(torch, name, got, want, share=0.005) -> tuple[int, int]:
    """Raise unless `got` is at most 1 LSB from `want` (the plain version
    or the STD method; tensors or numpy) on every byte and differs on less
    than `share` of them. -> (max abs difference, bytes that differ)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: {tuple(got.shape)} against {tuple(want.shape)}")
    differ = got != want
    n = int(differ.sum())
    err = int((got[differ].int() - want[differ].int()).abs().max()) if n else 0
    if err > 1 or n >= share * got.numel():
        raise AssertionError(f"{name}: {n} of {got.numel()} bytes differ, max {err} LSB")
    return err, n


def phase3_kernel_vs_plain(torch, np, stack, smi) -> dict:
    from lfinterpolator_tpu_torch.ops import shift_blend
    from lfinterpolator_tpu_torch.state import to_device_state

    from lfinterpolator_tpu_torch.ops import blend_torch

    max_err = 0
    timing = None
    for focus in (0.1, -0.35, 5.0):
        wm, fo = weights_and_shifts(COLS, ROWS, H, W, focus)
        images, weights, shifts = to_device_state(stack, wm, fo, "cuda")
        got = shift_blend.shift_blend(images, weights, shifts)
        want = shift_blend.shift_blend_reference(images, weights, shifts)
        torch.cuda.synchronize()
        err, differ = check_1lsb(torch, f"kernel against plain at focus {focus}", got, want)
        max_err = max(max_err, err)
        del want
        rule = check_rule(torch, f"shift_blend at focus {focus}", got,
                          blend_torch.shift_stack(images, shifts), weights)
        log(f"[3] focus {focus}: near-tie rule holds on {rule['bytes']} bytes "
            f"({rule['lax']} in the lax band, {rule['ties_off']} of them off rint); "
            f"<= 1 LSB from plain, {differ} bytes differ "
            f"(shift range dx {fo[:, 0].min()}..{fo[:, 0].max()})")
        if focus == 0.1:
            # chunking independence: three times the matrix in one launch
            tall = shift_blend.shift_blend(images, weights.repeat(3, 1), shifts)
            if not torch.equal(tall[VIEWS:2 * VIEWS], got):
                raise AssertionError("rows 64-127 of a 192-row launch != the 64-row launch")
            del tall
            log("[3] a 64-row launch == rows 64-127 of a 192-row launch (torch.equal)")
        del got
        if focus == 0.1:
            ms = event_ms(lambda: shift_blend.shift_blend(images, weights, shifts))
            plain_ms = event_ms(
                lambda: shift_blend.shift_blend_reference(images, weights, shifts))
            timing = (ms, plain_ms)
            log(f"[3] 8x8/1080p/64v: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                f"({smi})")
        del images
        torch.cuda.empty_cache()
    from lfinterpolator_tpu_torch.utils import profiling

    log(f"[3] launches so far {profiling.launch_counts()['shift_blend']}")
    return {"max_abs_err": max_err, "ms": timing[0], "plain_ms": timing[1]}


def phase4_oracle(torch, np) -> None:
    from lfinterpolator_tpu_torch.ops import shift_blend
    from lfinterpolator_tpu_torch.state import to_device_state

    rng = np.random.default_rng(SEED + 1)
    lax = 0
    for cols, rows, h, w in ((4, 4, 48, 64), (16, 16, 12, 20), (2, 2, 48, 64)):
        stack = rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)
        for focus in (0.37, -2.0):
            wm, fo = weights_and_shifts(cols, rows, h, w, focus)
            random_wm = (rng.random(wm.shape) * 4 / wm.shape[1]).astype(np.float16)
            for m in (wm, random_wm.astype(np.float32)):
                got = shift_blend.shift_blend(*to_device_state(stack, m, fo, "cuda"))
                lax += check_rule_np(
                    torch, f"shift_blend on {cols}x{rows}/{h}x{w} at focus {focus}",
                    got.permute(0, 2, 3, 1), oracle(np, stack, m, fo))["lax"]
    log("[4] kernel obeys the near-tie rule against NumPy's exact sums on 4x4/48x64, "
        f"16x16/12x20 and 2x2/48x64, 64v, the render's and random weights ({lax} bytes "
        "in the lax band)")


def seeded_light_field(np):
    """The tests' textured-plane scene (tests/conftest.py) at 8x8/1080p."""
    from lfinterpolator_tpu_torch.io import LightField

    rng = np.random.default_rng(SEED + 2)
    t = rng.integers(0, 256, size=(H * 2, W * 2, 3), dtype=np.uint8).astype(np.float32)
    t = (t + np.roll(t, 1, 0) + np.roll(t, 1, 1) + np.roll(t, 2, 0)) / 4.0
    texture = t.astype(np.uint8)
    del t
    images = np.empty((COLS * ROWS, H, W, 4), dtype=np.uint8)
    for c in range(COLS):
        for r in range(ROWS):
            images[c * ROWS + r, :, :, :3] = texture[r * 2 : r * 2 + H, c * 2 : c * 2 + W]
            images[c * ROWS + r, :, :, 3] = 255
    return LightField(images=images, cols=COLS, rows=ROWS)


def phase5_api(torch, np, lf, smi) -> tuple:
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.utils import profiling

    interp = Interpolator(lf, device="cuda", progress=False)
    before = profiling.launch_counts()  # count only the main path's launches
    ten = interp.interpolate(TRAJECTORY, focus=0.1, method="TEN",
                             benchmark_runs=20, progress=False)
    launches = (profiling.launch_counts() - before)["shift_blend"]
    if launches < 1:
        raise AssertionError("the TEN render launched the kernel no time")
    std = interp.interpolate(TRAJECTORY, focus=0.1, method="STD",
                             benchmark_runs=20, progress=False)
    if (profiling.launch_counts() - before)["shift_blend"] != launches:
        raise AssertionError("the STD render launched the kernel")
    del interp
    torch.cuda.empty_cache()
    for name, res in (("TEN", ten), ("STD", std)):
        if res.views.shape != (VIEWS, H, W, 3) or res.views.dtype != np.uint8:
            raise AssertionError(f"{name} views {res.views.shape} {res.views.dtype}")
        log(f"[5] {name}: {res.avg_ms:.3f} ms/frame, "
            f"{res.megapixels_per_s / 1e3:.3f} output GP/s over 20 runs ({smi})")
    _, differ = check_1lsb(torch, "TEN against STD", ten.views, std.views)
    # Two views (first and last) against NumPy's exact sums at full size.
    wm, fo = weights_and_shifts(COLS, ROWS, H, W, 0.1)
    pick = [0, VIEWS - 1]
    sums = oracle(np, lf.images, wm[pick], fo)
    for name, res in (("TEN", ten), ("STD", std)):
        check_rule_np(torch, f"{name} views 0 and {VIEWS - 1}", res.views[pick], sums)
    log(f"[5] TEN <= 1 LSB from STD on {ten.views.size} bytes ({differ} differ); views 0 "
        f"and {VIEWS - 1} of both obey the near-tie rule against NumPy's exact sums; "
        f"kernel launches in the TEN render: {launches}")
    return ten, std, launches


def view_files(np, views, maps=None) -> dict:
    """The CLI's files of a render: 00.png.. and map0.png/map1.png, as the
    [h, w, 3] arrays they must decode to."""
    want = {f"{i:02d}.png": views[i] for i in range(len(views))}
    if maps is not None:
        want.update({f"map{i}.png": np.repeat(maps[i][..., None], 3, axis=-1)
                     for i in range(2)})
    return want


def run_cli(np, tag, images, runs) -> None:
    """Write `images` ([G, h, w, 4] u8, the COLSxROWS grid) as PNGs once, then
    for each (flags, want) of `runs` run the CLI on them with `flags` in a
    subprocess and check that it wrote exactly the files of `want` (name ->
    [h, w, 3] u8) and that they decode equal to them."""
    from concurrent.futures import ThreadPoolExecutor

    from lfinterpolator_tpu_torch import io

    work = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    scene = os.path.join(work, "scene")
    os.makedirs(scene)
    h, w = images.shape[1:3]
    t0 = time.perf_counter()

    def write(i):
        c, r = divmod(i, ROWS)
        io.encode_png(os.path.join(scene, f"{c:02d}_{r:02d}.png"), images[i])

    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
        list(ex.map(write, range(COLS * ROWS)))
    log(f"[{tag}] wrote the {COLS}x{ROWS} grid at {w}x{h} as PNGs "
        f"({io.codec_name()} codec) in {time.perf_counter() - t0:.1f} s")
    for n_run, (flags, want) in enumerate(runs):
        out = os.path.join(work, f"out{n_run}")
        cmd = [sys.executable, "-m", "lfinterpolator_tpu_torch.cli", "-i", scene,
               "-o", out, "-t", TRAJECTORY, *flags, "--json"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exit {proc.returncode}: {proc.stderr[-4000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"[{tag}] CLI {' '.join(flags)} in {time.perf_counter() - t0:.1f} s: "
            f"{summary}")
        names = sorted(n for n in os.listdir(out) if n.endswith(".png"))
        if names != sorted(want) or summary["files_written"] != len(want):
            raise AssertionError(f"CLI wrote {names[:4]}... ({len(names)} files)")
        for name in names:
            back = io.decode(os.path.join(out, name))
            if (not np.array_equal(back[..., :3], want[name])
                    or (back[..., 3] != 255).any()):
                raise AssertionError(f"CLI file {name} != the API render")
        log(f"[{tag}] {len(names)} PNGs decode equal to the API render")
    shutil.rmtree(work, ignore_errors=True)


def allfocus_setup(focus, focus_range, cols, rows, h, w, exact=True,
                   focus_views=32, pyramid=False):
    """An all-focus render's host params and its device tensors."""
    from lfinterpolator_tpu_torch import RenderConfig, state

    cfg = RenderConfig(focus=focus, focus_range=focus_range, exact_focus_taps=exact,
                       focus_map_views=focus_views, focus_pyramid=pyramid)
    p = state.allfocus_params(TRAJECTORY, cols=cols, rows=rows, height=h,
                              width=w, config=cfg)
    return p, *state.upload_allfocus(p, "cuda")


def slow_share(torch, p) -> float:
    """The share of (candidate, pixel) pairs that the exact rule's clean
    flags send down the nine-tap loop, for the host params `p` (CPU ops)."""
    from lfinterpolator_tpu_torch.ops import focus_torch
    from lfinterpolator_tpu_torch.ops.estimate_geometry import FocusTables

    return focus_torch.slow_share(*focus_torch.clean_flags(
        torch.from_numpy(p.offsets[p.focus_ids]),
        FocusTables(*(torch.from_numpy(t) for t in p.tables)), p.radius, H, W))


def estimate_equal(torch, name, args, errs) -> dict:
    """Both tap rules of focus_estimate against the plain version on `args`
    (selected, sel_offsets, tables, radius); -> the maps by rule. The
    largest byte difference measured goes into `errs` by rule (kept at its
    maximum over the calls); anything but equal maps raises."""
    from lfinterpolator_tpu_torch.ops import focus_estimate

    maps = {}
    for rule, exact in (("exact", True), ("fast", False)):
        got = focus_estimate.focus_estimate(*args, exact)
        want = focus_estimate.focus_estimate_reference(*args, exact)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        if err or not torch.equal(got, want):
            raise AssertionError(
                f"focus_estimate ({rule}) != plain version {name}: "
                f"{int((got != want).sum())} bytes differ, max {err}")
        errs[rule] = max(errs.get(rule, 0), err)
        maps[rule] = got
    return maps


def estimate_parts_equal(torch, selected, sel_offsets, tables, radius) -> None:
    """The estimate's other two kernels, each alone against its plain
    version at the main path's shapes: the RGBx pack on all the focus views,
    the map pass on the first and the last candidate."""
    from lfinterpolator_tpu_torch.ops import focus_estimate, focus_torch

    words = focus_estimate.rgbx(selected)
    if not torch.equal(words, focus_estimate.rgbx_reference(selected)):
        raise AssertionError("rgbx != plain version")
    log(f"[7] rgbx: kernel == plain on {words.numel()} words {tuple(words.shape)}")
    del words
    maps = focus_estimate.cheby_maps(selected, sel_offsets, tables, radius)
    for i in (0, maps.shape[0] - 1):
        want = focus_torch.cheby_map(selected, sel_offsets, tables.candidates[i], radius)
        if not torch.equal(maps[i], want):
            raise AssertionError(
                f"cheby_maps[{i}] != plain version: {int((maps[i] != want).sum())} "
                f"bytes differ, max {int((maps[i].int() - want.int()).abs().max())}")
    log(f"[7] cheby_maps: kernel == plain on candidates 0 and {maps.shape[0] - 1}, "
        f"{maps[0].numel()} bytes each {tuple(maps.shape)}")


def phase7_estimate_vs_plain(torch, np, stack, smi) -> tuple:
    from lfinterpolator_tpu_torch.ops import focus_estimate
    from lfinterpolator_tpu_torch.state import upload_images

    images = upload_images(stack, "cuda")
    p, weights, offsets, ids, tables = allfocus_setup(0.1, 0.3, COLS, ROWS, H, W)
    selected, sel_offsets = images[ids], offsets[ids]
    log(f"[7] K={len(ids)} focus views, {len(p.tables.candidates)} candidates, "
        f"radius {p.radius}, filter radius {p.filter_radius}")
    base = (selected, sel_offsets, tables, p.radius)
    errs = {}
    maps = estimate_equal(torch, "on the random stack at focus 0.1", base, errs)
    estimate_parts_equal(torch, *base)
    timed = {}
    for rule, exact in (("exact", True), ("fast", False)):
        args = (*base, exact)
        ms = event_ms(lambda: focus_estimate.focus_estimate(*args), runs=5)
        plain_ms = event_ms(lambda: focus_estimate.focus_estimate_reference(*args), runs=2)
        parts = focus_estimate.pass_times(*args)
        timed[rule] = {"ms": ms, "plain_ms": plain_ms, **parts}
        log(f"[7] {rule}: kernels == plain on {maps[rule].numel()} map bytes "
            f"({len(torch.unique(maps[rule]))} distinct); estimate {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms; parts, each alone: "
            + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in parts.items()) + f" ({smi})")
    # the focus of a small sweep at which the nine-tap loop has most to do
    shares = {f: slow_share(torch, allfocus_setup(f, 0.3, COLS, ROWS, H, W)[0])
              for f in (-0.6, -0.3, 0.0, 0.3)}
    worst = max(shares, key=shares.get)
    pw, _, offsets_w, ids_w, tables_w = allfocus_setup(worst, 0.3, COLS, ROWS, H, W)
    args_w = (selected, offsets_w[ids_w], tables_w, pw.radius)
    estimate_equal(torch, f"at focus {worst}", args_w, errs)
    worst_ms = event_ms(lambda: focus_estimate.focus_estimate(*args_w), runs=5)
    log(f"[7] slow share by focus {shares}: at focus {worst} both rules == plain; "
        f"exact estimate {worst_ms:.3f} ms ({smi})")
    # a coherent scene: three textured planes at candidates of the search
    cands = p.tables.candidates
    planes = cands[[0, len(cands) // 2, len(cands) - 1]]
    scene = torch.from_numpy(structured_selected(
        np, p.offsets[p.focus_ids], planes, SEED + 7)).cuda()
    on_scene = estimate_equal(torch, "on the three-plane scene",
                              (scene, sel_offsets, tables, p.radius), errs)
    log(f"[7] three-plane scene (planes {planes.tolist()}): both rules == plain; "
        f"distinct map bytes exact {len(torch.unique(on_scene['exact']))}, "
        f"fast {len(torch.unique(on_scene['fast']))}")
    del selected, scene
    # max_abs_err: the largest over this phase's three comparisons of a rule
    stats = {rule: {"max_abs_err": errs[rule], **timed[rule]} for rule in timed}
    return stats, (p, images, weights, offsets, tables, maps["exact"])


def phase8_allfocus_vs_plain(torch, smi, state7) -> dict:
    from lfinterpolator_tpu_torch.ops import allfocus_blend, focus_torch

    p, images, weights, offsets, tables, map0 = state7
    map1 = focus_torch.filter_focus_map(map0, p.filter_radius)
    from lfinterpolator_tpu_torch.ops import blend_torch

    max_err, timing = 0, None
    for name, fmap in (("raw map0", map0), ("filtered map1", map1)):
        args = (images, weights, offsets, fmap, tables.decode)
        got = allfocus_blend.allfocus_blend(*args)
        want = allfocus_blend.allfocus_blend_reference(*args)
        torch.cuda.synchronize()
        err, differ = check_1lsb(torch, f"allfocus_blend against plain on the {name}",
                                 got, want)
        max_err = max(max_err, err)
        del want
        rule = check_rule(torch, f"allfocus_blend on the {name}", got,
                          blend_torch.allfocus_selected(images, offsets, fmap,
                                                        tables.decode), weights)
        log(f"[8] {name} ({len(torch.unique(fmap))} distinct bytes): near-tie rule holds "
            f"on {rule['bytes']} bytes ({rule['lax']} in the lax band); <= 1 LSB from "
            f"plain, {differ} bytes differ")
        del got
        if timing is None:
            ms = event_ms(lambda: allfocus_blend.allfocus_blend(*args))
            plain_ms = event_ms(lambda: allfocus_blend.allfocus_blend_reference(*args), runs=3)
            timing = (ms, plain_ms)
            flat = torch.full_like(fmap, int(fmap[H // 2, W // 2]))
            flat_ms = event_ms(lambda: allfocus_blend.allfocus_blend(
                images, weights, offsets, flat, tables.decode))
            log(f"[8] 8x8/1080p/64v: kernel {ms:.3f} ms on this map (per-pixel noise: "
                f"every gather its own sector), {flat_ms:.3f} ms on a constant map; "
                f"plain {plain_ms:.3f} ms ({smi})")
    return {"max_abs_err": max_err, "ms": timing[0], "plain_ms": timing[1]}


def oracle_estimate(np, views, offsets, cands, cand_bytes, radius):
    """[K, H, W, 3] u8 views, [K, 2] (x, y) offsets -> [H, W] u8 map.

    The exact-tap disparity search written out sequentially: per candidate
    f, taps at clip(trunc(f32(q) + f32(f*o)) + s), cost the sum over the
    3x3 taps of max_c(max_k - min_k), first strict minimum wins."""
    k, h, w = views.shape[:3]
    rx, ry = radius
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    best = np.full((h, w), np.iinfo(np.int64).max)
    best_i = np.zeros((h, w), dtype=np.int64)
    for i, f in enumerate(cands):
        lo = np.full((9, h, w, 3), 255, dtype=np.int64)
        hi = np.zeros((9, h, w, 3), dtype=np.int64)
        for v in range(k):
            cy = np.trunc(ys + f * offsets[v, 1]).astype(np.int64)
            cx = np.trunc(xs + f * offsets[v, 0]).astype(np.int64)
            for t, (sy, sx) in enumerate((a, b) for a in (-ry, 0, ry) for b in (-rx, 0, rx)):
                px = views[v][np.clip(cy + sy, 0, h - 1), np.clip(cx + sx, 0, w - 1)]
                lo[t] = np.minimum(lo[t], px)
                hi[t] = np.maximum(hi[t], px)
        cost = (hi - lo).max(axis=-1).sum(axis=0)
        better = cost < best
        best = np.where(better, cost, best)
        best_i = np.where(better, i, best_i)
    return cand_bytes[best_i]


def oracle_allfocus(np, images, wm, offsets, fmap, decode):
    """[G, H, W, >=3] u8 -> [V, H, W, 3] float64: each image read at
    clip(trunc(f32(q) + f32(f*o))) with f = decode[map]; the exact sums."""
    g_count, h, w = images.shape[:3]
    f = decode[fmap]
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    acc = np.zeros((wm.shape[0], h, w, 3), dtype=np.float64)
    for g in range(g_count):
        cy = np.clip(np.trunc(ys + f * offsets[g, 1]).astype(np.int64), 0, h - 1)
        cx = np.clip(np.trunc(xs + f * offsets[g, 0]).astype(np.int64), 0, w - 1)
        px = images[g][cy, cx][..., :3].astype(np.float64)
        acc += wm[:, g].astype(np.float64)[:, None, None, None] * px[None]
    return acc


def phase9_new_kernels_vs_oracle(torch, np) -> None:
    from lfinterpolator_tpu_torch.ops import allfocus_blend, focus_estimate, focus_torch
    from lfinterpolator_tpu_torch.state import upload_images

    rng = np.random.default_rng(SEED + 3)
    stack = rng.integers(0, 256, (16, 48, 64, 4), dtype=np.uint8)
    images = upload_images(stack, "cuda")
    for focus, focus_range in ((0.1, 0.3), (-0.8, 1.6)):
        p, weights, offsets, ids, tables = allfocus_setup(
            focus, focus_range, 4, 4, 48, 64, focus_views=8)
        map0 = focus_estimate.focus_estimate(
            images[ids], offsets[ids], tables, p.radius, True)
        want = oracle_estimate(np, stack[p.focus_ids, ..., :3], p.offsets[p.focus_ids],
                               p.tables.candidates, p.tables.candidate_bytes, p.radius)
        if not np.array_equal(map0.cpu().numpy(), want):
            raise AssertionError(f"focus_estimate != oracle at focus {focus}")
        for fmap in (map0, focus_torch.filter_focus_map(map0, (2, 2))):
            got = allfocus_blend.allfocus_blend(images, weights, offsets, fmap,
                                                tables.decode)
            check_rule_np(torch, f"allfocus_blend at focus {focus}",
                          got.permute(0, 2, 3, 1),
                          oracle_allfocus(np, stack, p.weights, p.offsets,
                                          fmap.cpu().numpy(), p.tables.decode))
    # the blend alone at G = 256 and G = 4, on random maps, with random weights
    for cols, rows, h, w in ((16, 16, 12, 20), (2, 2, 48, 64)):
        stack = rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8)
        p, _, offsets, _, tables = allfocus_setup(0.1, 0.3, cols, rows, h, w,
                                                  focus_views=min(8, cols * rows))
        wm = (rng.random(p.weights.shape) * 4 / (cols * rows)).astype(np.float16)
        wm = wm.astype(np.float32)
        fmap = rng.integers(0, 256, (h, w), dtype=np.uint8)
        got = allfocus_blend.allfocus_blend(
            upload_images(stack, "cuda"), torch.from_numpy(wm).cuda(), offsets,
            torch.from_numpy(fmap).cuda(), tables.decode)
        check_rule_np(torch, f"allfocus_blend on {cols}x{rows}/{h}x{w}",
                      got.permute(0, 2, 3, 1),
                      oracle_allfocus(np, stack, wm, p.offsets, fmap, p.tables.decode))
    log("[9] focus_estimate (exact) == its NumPy oracle and allfocus_blend obeys the "
        "near-tie rule against NumPy's exact sums on 4x4/48x64, K=8, 32 candidates, "
        "64v; the blend also on 16x16/12x20 and 2x2/48x64 with random maps and weights")


def phase10_allfocus_api(torch, np, lf, smi) -> tuple:
    from lfinterpolator_tpu_torch import RenderConfig
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.ops import blend_torch, focus_torch
    from lfinterpolator_tpu_torch.utils import profiling

    interps = {exact: Interpolator(lf, device="cuda", progress=False,
                                   config=RenderConfig(exact_focus_taps=exact))
               for exact in (True, False)}
    runs = (("TEN", "TEN", True), ("STD", "STD", True), ("TEN fast", "TEN", False))
    before = profiling.launch_counts()  # count only the main path's launches
    results = {
        name: interps[exact].interpolate(TRAJECTORY, focus=0.1, focus_range=0.3,
                                         method=method, benchmark_runs=5,
                                         progress=False)
        for name, method, exact in runs
    }
    counted = profiling.launch_counts() - before
    launches = {k: counted[k] for k in ("focus_estimate_exact", "focus_estimate_fast",
                                        "allfocus_blend")}
    log(f"[10] kernel launches in the all-focus renders: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the all-focus path never ran: {launches}")
    for name, method, exact in runs:
        res = results[name]
        if res.views.shape != (VIEWS, H, W, 3) or res.maps.shape != (2, H, W):
            raise AssertionError(f"{name}: views {res.views.shape}, maps {res.maps.shape}")
        distinct = [len(np.unique(m)) for m in res.maps]
        if distinct[0] < 2:
            raise AssertionError(f"{name}: map0 is constant, the check proves nothing")
        # the plain pipeline on the same CUDA tensors
        images = interps[exact].images
        p, weights, offsets, ids, tables = allfocus_setup(
            0.1, 0.3, COLS, ROWS, H, W, exact)
        map0 = focus_torch.estimate_focus_map(images[ids], offsets[ids], tables,
                                              p.radius, exact)
        map1 = focus_torch.filter_focus_map(map0, p.filter_radius)
        if not (np.array_equal(res.maps[0], map0.cpu().numpy())
                and np.array_equal(res.maps[1], map1.cpu().numpy())):
            raise AssertionError(f"{name}: maps != the plain pipeline's")
        views = blend_torch.render_allfocus(
            images, weights, offsets, map1 if method == "STD" else map0,
            tables.decode)
        _, differ = check_1lsb(torch, f"{name}: views against the plain pipeline's",
                               res.views, blend_torch.from_planar(views).cpu())
        del views
        log(f"[10] {name}: {res.avg_ms:.3f} ms/frame (estimate, filter, blend), "
            f"{res.megapixels_per_s / 1e3:.3f} output GP/s over 5 runs ({smi}); "
            f"distinct bytes map0 {distinct[0]}, map1 {distinct[1]}; maps == the plain "
            f"pipeline, views <= 1 LSB from it ({differ} bytes differ)")
    del interps
    torch.cuda.empty_cache()
    return results["TEN"], launches


def check_equal(torch, name, got, want) -> int:
    """Raise unless the kernel's output `got` equals the plain version's
    `want`; -> the max abs difference (0)."""
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name} != plain version: "
                             f"{int((got != want).sum())} bytes differ, max {err}")
    return err


def presence_density(torch, pres, sc: int, steps: int) -> str:
    """The share of (block, candidate) pairs a presence table searches, and
    the share of blocks that search every candidate."""
    bits = (pres[..., None] >> torch.arange(sc, device=pres.device, dtype=torch.int32)) & 1
    per_block = bits.reshape(pres.shape[0], pres.shape[1], -1).sum(-1)
    return (f"{float(bits.sum()) / (pres.shape[0] * pres.shape[1] * steps):.4f} "
            f"({float((per_block == steps).float().mean()):.4f} of "
            f"{pres.shape[0] * pres.shape[1]} blocks search all {steps})")


def phase12_presence_vs_plain(torch, np, smi) -> tuple:
    """The predicated estimate kernel against its plain masked version at
    full size: a seeded random K = 32 stack and a seeded random presence
    table of density ~0.5, on the headline pyramid's block grain."""
    from lfinterpolator_tpu_torch.ops import focus_estimate, focus_torch

    p, _, offsets, ids, tables = allfocus_setup(0.1, 0.3, COLS, ROWS, H, W, pyramid=True)
    plan = p.pyramid
    if plan is None:
        raise AssertionError("the headline geometry has no pyramid plan")
    steps = len(p.tables.candidates)
    rng = np.random.default_rng(SEED + 4)
    selected = torch.from_numpy(
        rng.integers(0, 256, (len(ids), 3, H, W), dtype=np.uint8)).cuda()
    pres = torch.from_numpy(rng.integers(
        0, 2**plan.sc, (plan.nb, plan.n_wc, steps // plan.sc), dtype=np.int32)).cuda()
    density = presence_density(torch, pres, plan.sc, steps)
    args = (selected, offsets[ids], tables, p.radius)
    err = check_equal(torch, "focus_estimate (presence)",
                      focus_estimate.focus_estimate(*args, True, pres, plan),
                      focus_torch.estimate_presence(*args, pres, plan))
    ms = event_ms(lambda: focus_estimate.focus_estimate(*args, True, pres, plan),
                  runs=5)
    exact_ms = event_ms(lambda: focus_estimate.focus_estimate(*args), runs=5)
    plain_ms = event_ms(lambda: focus_torch.estimate_presence(*args, pres, plan),
                        runs=2)
    log(f"[12] {plan}; random presence table, density {density}: kernel == "
        f"plain on {H * W} map bytes; kernel {ms:.3f} ms, exact sweep {exact_ms:.3f} "
        f"ms, plain {plain_ms:.3f} ms ({smi})")
    return ({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms},
            {"random_density": density, "presence_ms": ms,
             "exact_ms": exact_ms})


def structured_selected(np, sel_off, planes, seed):
    """[K, 3, H, W] u8: three horizontal bands, each a textured plane at one
    of `planes` (focus values on the candidate grid), as the JAX tests'
    _structured_selected builds at 96x512: the pyramid's coarse map is
    coherent there, and its presence table prunes."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(np.abs(planes).max() * np.abs(sel_off).max())) + 8
    t = rng.integers(0, 256, (3, H + 2 * m, W + 2 * m), dtype=np.uint8).astype(np.float32)
    tex = ((t + np.roll(t, 1, 1) + np.roll(t, 2, 2)) / 3).astype(np.uint8)
    del t
    band = H // 3
    out = np.empty((len(sel_off), 3, H, W), np.uint8)
    for v in range(len(sel_off)):
        y0 = 0
        for f, hb in zip(planes, (band, band, H - 2 * band)):
            dx = int(round(-f * sel_off[v, 0])) + m
            dy = int(round(-f * sel_off[v, 1])) + m
            out[v, :, y0:y0 + hb] = tex[:, dy + y0:dy + y0 + hb, dx:dx + W]
            y0 += hb
    return out


def phase13_pyramid_vs_plain(torch, np, smi) -> None:
    """The coarse-to-fine estimate (both passes on the kernel, the presence
    table in torch ops) against its plain version at full size on a
    three-plane scene; its time against the exact sweep's."""
    from lfinterpolator_tpu_torch.ops import focus_estimate, focus_torch

    p, _, offsets, ids, tables = allfocus_setup(0.1, 0.3, COLS, ROWS, H, W, pyramid=True)
    plan = p.pyramid
    cands = p.tables.candidates
    planes = cands[[0, len(cands) // 2, len(cands) - 1]]
    selected = torch.from_numpy(structured_selected(
        np, p.offsets[p.focus_ids], planes, SEED + 5)).cuda()
    args = (selected, offsets[ids], tables, p.radius)
    got = focus_estimate.focus_estimate_pyramid(*args, plan)
    err = check_equal(torch, "focus_estimate_pyramid", got,
                      focus_torch.estimate_pyramid(*args, plan))
    s = plan.scale
    coarse = focus_estimate.focus_estimate(selected[:, :, ::s, ::s], offsets[ids] / s,
                                           tables, plan.radius_c)
    pres = focus_torch.presence_from_coarse(coarse, plan, len(cands))
    density = presence_density(torch, pres, plan.sc, len(cands))
    exact = focus_estimate.focus_estimate(*args)
    agree = float((got == exact).float().mean())
    ms = event_ms(lambda: focus_estimate.focus_estimate_pyramid(*args, plan), runs=5)
    coarse_ms = event_ms(lambda: focus_estimate.focus_estimate(
        selected[:, :, ::s, ::s], offsets[ids] / s, tables, plan.radius_c), runs=5)
    exact_ms = event_ms(lambda: focus_estimate.focus_estimate(*args), runs=5)
    plain_ms = event_ms(lambda: focus_torch.estimate_pyramid(*args, plan), runs=1)
    log(f"[13] three-plane scene (planes {planes.tolist()}): pyramid kernels == plain "
        f"(max err {err}); presence density {density}; map == exact sweep on "
        f"{agree:.6f} of pixels; pyramid {ms:.3f} ms (coarse pass {coarse_ms:.3f} ms), "
        f"exact sweep {exact_ms:.3f} ms, plain pyramid {plain_ms:.3f} ms ({smi})")


def phase14_pyramid_api(torch, np, lf, smi) -> int:
    """The pyramid through the Interpolator on phase 5's light field
    (focus 0.1, range 0.3, TEN): kernel launches counted, views and maps
    equal to the plain pipeline on the same tensors."""
    from lfinterpolator_tpu_torch import RenderConfig
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.ops import blend_torch, focus_estimate, focus_torch
    from lfinterpolator_tpu_torch.utils import profiling

    interp = Interpolator(lf, device="cuda", progress=False,
                          config=RenderConfig(focus_pyramid=True))
    before = profiling.launch_counts()  # the main path's
    res = interp.interpolate(TRAJECTORY, focus=0.1, focus_range=0.3, method="TEN",
                             benchmark_runs=5, progress=False)
    counted = profiling.launch_counts() - before
    launches = {rule: counted[f"focus_estimate_{rule}"] for rule in ("exact", "fast", "pyramid")}
    log(f"[14] estimate kernel launches in the pyramid renders: {launches}")
    if launches["pyramid"] < 1 or launches["exact"] != launches["pyramid"]:
        raise AssertionError(f"the pyramid path did not run its kernels: {launches}")
    p, weights, offsets, ids, tables = allfocus_setup(0.1, 0.3, COLS, ROWS, H, W,
                                                      pyramid=True)
    images = interp.images
    map0 = focus_torch.estimate_pyramid(images[ids], offsets[ids], tables, p.radius,
                                        p.pyramid)
    map1 = focus_torch.filter_focus_map(map0, p.filter_radius)
    if not (np.array_equal(res.maps[0], map0.cpu().numpy())
            and np.array_equal(res.maps[1], map1.cpu().numpy())):
        raise AssertionError("pyramid maps != the plain pipeline's")
    views = blend_torch.render_allfocus(images, weights, offsets, map0, tables.decode)
    _, differ = check_1lsb(torch, "pyramid views against the plain pipeline's",
                           res.views, blend_torch.from_planar(views).cpu())
    exact = focus_torch.estimate_focus_map(images[ids], offsets[ids], tables, p.radius)
    s = p.pyramid.scale
    coarse = focus_estimate.focus_estimate(images[ids][:, :, ::s, ::s], offsets[ids] / s,
                                           tables, p.pyramid.radius_c)
    density = presence_density(
        torch, focus_torch.presence_from_coarse(coarse, p.pyramid, len(p.tables.candidates)),
        p.pyramid.sc, len(p.tables.candidates))
    log(f"[14] TEN pyramid: {res.avg_ms:.3f} ms/frame (estimate, filter, blend), "
        f"{res.megapixels_per_s / 1e3:.3f} output GP/s over 5 runs ({smi}); "
        f"presence density {density}; map0 == exact sweep on "
        f"{float((map0 == exact).float().mean()):.6f} of pixels; maps == the plain "
        f"pipeline, views <= 1 LSB from it ({differ} bytes differ)")
    del views, interp
    torch.cuda.empty_cache()
    return launches["pyramid"]


def phase15_quilt_blend_vs_plain(torch, np, smi) -> tuple:
    """The quilt instantiation against its plain version (the first 45
    views of the plain render, then the montage) at full size, focus 0.1,
    and shift_blend's 64 views in the same run for scale."""
    from lfinterpolator_tpu_torch.ops import blend_torch, quilt, shift_blend
    from lfinterpolator_tpu_torch.state import to_device_state

    rng = np.random.default_rng(SEED + 6)
    stack = rng.integers(0, 256, (COLS * ROWS, H, W, 3), dtype=np.uint8)
    wm, fo = weights_and_shifts(COLS, ROWS, H, W, 0.1)
    args = to_device_state(stack, wm, fo, "cuda")
    del stack
    got = quilt.quilt_blend(*args)
    if got.shape != (3, 9 * H, 5 * W):
        raise AssertionError(f"quilt_blend canvas {tuple(got.shape)}")
    err, differ = check_1lsb(torch, "quilt_blend against plain", got,
                             quilt.quilt_blend_reference(*args))
    # the canvas as its 45 tiles [45, C, H, W]: shift_blend's views, exactly
    tiles = got.reshape(3, 9, H, 5, W).permute(1, 3, 0, 2, 4).reshape(45, 3, H, W)
    if not torch.equal(tiles, shift_blend.shift_blend(*args)[:45]):
        raise AssertionError("quilt_blend tiles != shift_blend views")
    rule = check_rule(torch, "quilt_blend", tiles,
                      blend_torch.shift_stack(args[0], args[2]), args[1][:45])
    del got, tiles
    ms = event_ms(lambda: quilt.quilt_blend(*args))
    blend_ms = event_ms(lambda: shift_blend.shift_blend(*args))
    plain_ms = event_ms(lambda: quilt.quilt_blend_reference(*args), runs=3)
    log(f"[15] quilt_blend tiles == shift_blend views (torch.equal); near-tie rule holds "
        f"on {rule['bytes']} canvas bytes ({rule['lax']} in the lax band); <= 1 LSB from "
        f"plain, {differ} bytes differ; kernel "
        f"{ms:.3f} ms, shift_blend (64 views) {blend_ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"({smi})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}, args[0]


def phase16_quilt_copy_vs_plain(torch, np, tiles, smi) -> dict:
    """The tile copy against its plain version (reshape/permute) at full
    size: 45 of 64 1080x1920 tiles into the 5x9 canvas."""
    from lfinterpolator_tpu_torch.ops import quilt, quilt_torch

    err = check_equal(torch, "quilt_copy", quilt.quilt_copy(tiles),
                      quilt_torch.montage(tiles, 5, 9))
    ms = event_ms(lambda: quilt.quilt_copy(tiles))
    plain_ms = event_ms(lambda: quilt_torch.montage(tiles, 5, 9))
    moved = 2 * 45 * 3 * H * W
    log(f"[16] quilt_copy == plain on {moved // 2} canvas bytes; kernel {ms:.3f} ms "
        f"({moved / ms / 1e9:.3f} TB/s of reads + writes), plain {plain_ms:.3f} ms "
        f"({smi})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def montage(np, views, cols=5, rows=9):
    """[V, h, w, 3] -> [rows*h, cols*w, 3], view i at (i // cols, i % cols)."""
    h, w = views.shape[1:3]
    return (views[:cols * rows].reshape(rows, cols, h, w, 3).transpose(0, 2, 1, 3, 4)
            .reshape(rows * h, cols * w, 3))


def phase17_render_quilt(torch, np, lf, smi) -> dict:
    """render_quilt on phase 5's light field at focus 0.1: the fused route
    (TEN, the quilt kernel) and the two-stage route (STD, then the tile
    copy), each timed over 10 runs, launches counted; the quilts equal each
    other and the montage of the TEN render's views."""
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.utils import profiling

    interp = Interpolator(lf, device="cuda", progress=False)
    launches = {}
    results = {}
    for name, method, key in (("fused", "TEN", "quilt_blend"),
                              ("two-stage", "STD", "quilt_copy")):
        before = profiling.launch_counts()  # the main path's
        results[name] = interp.render_quilt(TRAJECTORY, focus=0.1, method=method,
                                            benchmark_runs=10, progress=False)
        counted = profiling.launch_counts() - before
        launches[key] = counted[key]
        if launches[key] < 1 or results[name].fused is not (name == "fused"):
            raise AssertionError(f"{name} quilt: launches {dict(counted)}, "
                                 f"fused {results[name].fused}")
    fused, two = results["fused"].quilt, results["two-stage"].quilt
    if fused.shape != (9 * H, 5 * W, 3):
        raise AssertionError(f"the fused quilt is {fused.shape}")
    _, differ = check_1lsb(torch, "the fused quilt against the two-stage quilt", fused, two)
    views = interp.interpolate(TRAJECTORY, focus=0.1, method="TEN", progress=False).views
    if not np.array_equal(fused, montage(np, views)):
        raise AssertionError("the quilt != the montage of the rendered views")
    del interp, views
    torch.cuda.empty_cache()
    log(f"[17] render_quilt 5x9 of 1080x1920 tiles: fused {results['fused'].avg_ms:.3f} "
        f"ms, two-stage (64-view STD render + tile copy) "
        f"{results['two-stage'].avg_ms:.3f} ms over 10 runs ({smi}); fused == the montage "
        f"of the TEN views, <= 1 LSB from the two-stage quilt ({differ} bytes differ); "
        f"launches {launches}")
    return launches


def phase18_cli(torch, np, lf) -> None:
    """The quilt CLI (--quilt-only, --quilt) at a quarter of the resolution
    and the pyramid CLI (-r 0.3 --focus-pyramid) at 960x270 (the pyramid
    needs W >= 512); their PNGs decode equal to the API's output. The --quilt run
    is also the fixed-focus CLI's: its 64 views beside the quilt."""
    from lfinterpolator_tpu_torch import RenderConfig, state
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.io import LightField

    small = LightField(np.ascontiguousarray(lf.images[:, ::4, ::4]), COLS, ROWS)
    interp = Interpolator(small, device="cuda", progress=False)
    q = interp.render_quilt(TRAJECTORY, focus=0.1, method="TEN", progress=False)
    ten = interp.interpolate(TRAJECTORY, focus=0.1, method="TEN", progress=False)
    run_cli(np, 18, small.images, [
        (["-m", "TEN", "-f", "0.1", "--quilt-only"], {"quilt.png": q.quilt}),
        (["-m", "TEN", "-f", "0.1", "--quilt"],
         {**view_files(np, ten.views), "quilt.png": q.quilt}),
    ])
    wide = LightField(np.ascontiguousarray(lf.images[:, ::4, ::2]), COLS, ROWS)
    cfg = RenderConfig(focus_pyramid=True)
    p = state.allfocus_params(TRAJECTORY, cols=COLS, rows=ROWS, height=H // 4,
                              width=W // 2, config=RenderConfig(
                                  focus=0.1, focus_range=0.3, focus_pyramid=True))
    if p.pyramid is None:
        raise AssertionError(f"no pyramid at {W // 2}x{H // 4}")
    af = Interpolator(wide, device="cuda", progress=False, config=cfg).interpolate(
        TRAJECTORY, focus=0.1, focus_range=0.3, method="TEN", progress=False)
    del interp
    torch.cuda.empty_cache()
    run_cli(np, 18, wide.images, [
        (["-m", "TEN", "-f", "0.1", "-r", "0.3", "--focus-pyramid"],
         view_files(np, af.views, af.maps))])


# H100 SXM peaks (NVIDIA's data sheet). "int32" is the integer rate outside
# the tensor cores, where a min/max has to run: the sheet's 67 TFLOP/s of
# fp32 are 2 flops on each of 128 lanes an SM, and 64 of those lanes take
# integer instructions, so a quarter of that number.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp16": 989e12, "int8": 1979e12, "int32": 67e12 / 4}


def bound(nbytes: float, ops: float, ops_type: str) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the operations over the peak rate of their type."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[ops_type] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def wall_ms(torch, fn, runs: int = 3) -> tuple[list, object]:
    """Host-clock ms of `runs` calls of fn, each ending in a synchronize."""
    times, out = [], None
    for _ in range(runs):
        out = None  # the last result is released before the next call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def fmt(times) -> str:
    return "/".join(f"{t:.1f}" for t in times)


def phase19_download(torch, np, lf, smi) -> dict:
    """The download of one 64-view headline frame (398 MB), four ways:
    pageable .cpu() of the [V, H, W, C] copy; a pinned buffer kept and
    reused, plus the copy out of it into a fresh array; the port's
    Downloader, pinned memory per download from PyTorch's caching host
    allocator handed to the caller (first call, then with each result
    dropped, then with every result kept); and the pinned copy alone."""
    from lfinterpolator_tpu_torch.ops import blend_torch, shift_blend
    from lfinterpolator_tpu_torch.state import to_device_state
    from lfinterpolator_tpu_torch.utils import transfer

    wm, fo = weights_and_shifts(COLS, ROWS, H, W, 0.1)
    images, weights, shifts = to_device_state(lf.images, wm, fo, "cuda")
    views = shift_blend.shift_blend(images, weights, shifts)
    del images
    hwc = blend_torch.from_planar(views)
    pageable_t, pageable = wall_ms(torch, lambda: hwc.cpu().numpy())
    kept = torch.empty(hwc.shape, dtype=torch.uint8, pin_memory=True)
    kept_t, _ = wall_ms(torch, lambda: kept.copy_(hwc).numpy().copy())
    d2h = event_ms(lambda: kept.copy_(hwc, non_blocking=True), runs=5)
    del kept
    dl = transfer.Downloader("cuda")
    first_t, got = wall_ms(torch, lambda: dl.start(views).wait(), runs=1)
    if not np.array_equal(pageable, got):
        raise AssertionError("the pinned download != the pageable one")
    del got, pageable
    reused_t, _ = wall_ms(torch, lambda: dl.start(views).wait(), runs=4)
    held = []
    fresh_t, _ = wall_ms(torch, lambda: held.append(dl.start(views).wait()), runs=3)
    del held
    gb = hwc.numel() / 1e9
    log(f"[19] download of a 64-view frame ({gb:.3f} GB): pageable .cpu() {fmt(pageable_t)} "
        f"ms; a kept pinned buffer + copy-out {fmt(kept_t)} ms; the Downloader (pinned "
        f"per download, cached) first call {fmt(first_t)} ms, result dropped each call "
        f"{fmt(reused_t)} ms, results kept {fmt(fresh_t)} ms; the pinned copy alone "
        f"{d2h:.3f} ms ({gb / d2h * 1e3:.1f} GB/s) ({smi})")
    return {"pageable_ms": pageable_t, "kept_buffer_copy_out_ms": kept_t,
            "downloader_first_ms": first_t[0], "downloader_reused_ms": reused_t,
            "downloader_kept_results_ms": fresh_t, "d2h_pinned_ms": d2h}


def phase20_stream(torch, np, stack, smi) -> dict:
    """The streaming TEN path: 8 headline frames, each a roll of the seeded
    stack, prefetch 2. Every frame torch.equal to the plain version on the
    card; shift_blend launched once a frame; fps beside the serial sum of
    the host copy into pinned memory, upload, render and download, each
    measured alone."""
    from lfinterpolator_tpu_torch import RenderConfig, StreamingRenderer
    from lfinterpolator_tpu_torch.ops import blend_torch, shift_blend
    from lfinterpolator_tpu_torch.utils import profiling
    from lfinterpolator_tpu_torch.utils import transfer

    frames = [np.roll(stack, 16 * t, axis=2) for t in range(8)]
    sr = StreamingRenderer(COLS, ROWS, W, H, TRAJECTORY, prefetch=2,
                           config=RenderConfig(method="TEN", focus=0.1))

    def stream_s() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in sr.render_stream(frames):  # a consumer that drops each frame
            pass
        return time.perf_counter() - t0

    # The first pass also allocates the pinned input buffers and the
    # pinned outputs the host allocator caches for the next frames.
    before = profiling.launch_counts()  # the main path's
    first = stream_s()
    total = stream_s()
    launches = (profiling.launch_counts() - before)["shift_blend"]
    if launches != 2 * len(frames):
        raise AssertionError(f"{launches} shift_blend launches for 2 x {len(frames)} frames")
    outs = list(sr.render_stream(frames))  # again, kept for the check
    max_err = differ = 0
    for t, (frame, out) in enumerate(zip(frames, outs)):
        planar = blend_torch.to_planar(torch.from_numpy(frame).cuda())
        got = torch.from_numpy(out).cuda()
        if not torch.equal(got, blend_torch.from_planar(
                shift_blend.shift_blend(planar, sr.weights, sr.shifts))):
            raise AssertionError(f"streamed frame {t} != a one-pass shift_blend")
        want = blend_torch.from_planar(
            shift_blend.shift_blend_reference(planar, sr.weights, sr.shifts))
        err, n = check_1lsb(torch, f"streamed frame {t} against plain", got, want)
        max_err, differ = max(max_err, err), differ + n
        del planar, want, got
    # each stage alone on one frame; the decode thread's host copy into a
    # pinned input buffer, as the stream makes it (torch's copy_) and on
    # one core (np.copyto)
    pinned = torch.from_numpy(frames[0]).pin_memory()
    host_t, _ = wall_ms(torch, lambda: pinned.copy_(torch.from_numpy(frames[1])))
    host_np_t, _ = wall_ms(torch, lambda: np.copyto(pinned.numpy(), frames[1]))
    host_ms = sum(host_t) / len(host_t)
    dev = torch.empty(pinned.shape, dtype=torch.uint8, device="cuda")
    upload_ms = event_ms(lambda: dev.copy_(pinned, non_blocking=True), runs=5)
    planar = blend_torch.to_planar(dev)
    render_ms = event_ms(lambda: shift_blend.shift_blend(
        blend_torch.to_planar(dev), sr.weights, sr.shifts), runs=5)
    kernel_ms = event_ms(lambda: shift_blend.shift_blend(planar, sr.weights, sr.shifts))
    plain_ms = event_ms(lambda: shift_blend.shift_blend_reference(
        planar, sr.weights, sr.shifts), runs=3)
    views = shift_blend.shift_blend(planar, sr.weights, sr.shifts)
    dl = transfer.Downloader("cuda")
    dl.start(views).wait()
    download_t, _ = wall_ms(torch, lambda: dl.start(views).wait())
    download_ms = sum(download_t) / len(download_t)
    serial = host_ms + upload_ms + render_ms + download_ms
    fps, first_fps = len(frames) / total, len(frames) / first
    log(f"[20] stream of {len(frames)} TEN frames (8x8/1080p/64v, prefetch 2): {fps:.3f} fps, "
        f"{1e3 / fps:.1f} ms/frame (first pass {first_fps:.3f} fps); "
        f"alone: host copy into pinned {fmt(host_t)} ms ({torch.get_num_threads()} threads; "
        f"np.copyto {fmt(host_np_t)} ms), upload {upload_ms:.3f} ms, render (planar copy + "
        f"shift_blend) {render_ms:.3f} ms, download {download_ms:.1f} ms, serial sum "
        f"{serial:.1f} ms; every frame == a one-pass shift_blend (torch.equal) and <= 1 LSB "
        f"from the plain version ({differ} bytes differ); shift_blend launches {launches} "
        f"in 2 passes; kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms ({smi})")
    del frames, outs, pinned, dev, planar, views, sr
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "fps": fps, "first_pass_fps": first_fps,
            "ms_per_frame": 1e3 / fps,
            "host_copy_ms": host_ms, "host_copy_np_ms": sum(host_np_t) / len(host_np_t),
            "upload_ms": upload_ms, "render_ms": render_ms, "download_ms": download_ms}


def phase21_allfocus_stream(torch, np, lf, smi) -> dict:
    """The all-focus stream, 3 frames (rolls of the seeded light field),
    map refresh 1 and 2: each frame equal to the Interpolator's render of
    it (refresh 2: frame 1 blends with frame 0's maps); the first frame
    also against the plain pipeline."""
    from lfinterpolator_tpu_torch import RenderConfig, StreamingRenderer
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.io import LightField
    from lfinterpolator_tpu_torch.models import pipeline
    from lfinterpolator_tpu_torch.ops import blend_torch, focus_torch

    frames = [np.roll(lf.images, 24 * t, axis=2) for t in range(3)]
    solo = []
    for f in frames:
        interp = Interpolator(LightField(f, COLS, ROWS), device="cuda", progress=False)
        res = interp.interpolate(TRAJECTORY, focus=0.1, focus_range=0.3, method="TEN",
                                 progress=False)
        solo.append((res.views, res.maps))
        del interp
    fps = {}
    for refresh in (1, 2):
        sr = StreamingRenderer(COLS, ROWS, W, H, TRAJECTORY, prefetch=2, config=RenderConfig(
            method="TEN", focus=0.1, focus_range=0.3, focus_map_refresh=refresh))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = list(sr.render_stream(frames))
        fps[refresh] = len(frames) / (time.perf_counter() - t0)
        for t, (views, maps) in enumerate(outs):
            if t % refresh == 0:
                ok = np.array_equal(views, solo[t][0]) and np.array_equal(maps, solo[t][1])
            else:  # the maps of frame t - 1, blended with frame t
                images = blend_torch.to_planar(torch.from_numpy(frames[t]).cuda())
                want = pipeline.blend_all_focus(
                    images, sr.weights, sr._offsets, torch.from_numpy(solo[t - 1][1]).cuda(),
                    sr._tables.decode, method="TEN")
                ok = (np.array_equal(maps, solo[t - 1][1]) and np.array_equal(
                    views, blend_torch.from_planar(want).cpu().numpy()))
                del images, want
            if not ok:
                raise AssertionError(f"all-focus stream, refresh {refresh}, frame {t} "
                                     "!= the Interpolator's render")
        if refresh == 1:  # the first frame against the plain pipeline
            p = sr._params
            images = blend_torch.to_planar(torch.from_numpy(frames[0]).cuda())
            map0 = focus_torch.estimate_focus_map(images[sr._ids], sr._offsets[sr._ids],
                                                  sr._tables, p.radius)
            map1 = focus_torch.filter_focus_map(map0, p.filter_radius)
            views = blend_torch.render_allfocus(images, sr.weights, sr._offsets, map0,
                                                sr._tables.decode)
            if not (np.array_equal(outs[0][1][0], map0.cpu().numpy())
                    and np.array_equal(outs[0][1][1], map1.cpu().numpy())):
                raise AssertionError("the first all-focus frame's maps != the plain pipeline's")
            check_1lsb(torch, "the first all-focus frame against the plain pipeline",
                       outs[0][0], blend_torch.from_planar(views).cpu())
            del images, map0, map1, views
        del sr, outs
        torch.cuda.empty_cache()
    log(f"[21] all-focus stream of 3 TEN frames: refresh 1 {fps[1]:.3f} fps, refresh 2 "
        f"{fps[2]:.3f} fps; frames == the Interpolator's renders (array_equal), frame 0's "
        f"maps == the plain pipeline's and its views <= 1 LSB from it ({smi})")
    return fps


def phase22_render_to_dir(torch, np, lf) -> None:
    """render_to_dir at a quarter of the resolution: 3 frames of 64 PNGs
    that decode equal to the stream's views."""
    from lfinterpolator_tpu_torch import RenderConfig, StreamingRenderer, io

    frames = [np.ascontiguousarray(np.roll(lf.images, 24 * t, axis=2)[:, ::4, ::4])
              for t in range(3)]
    h, w = frames[0].shape[1:3]
    sr = StreamingRenderer(COLS, ROWS, w, h, TRAJECTORY,
                           config=RenderConfig(method="TEN", focus=0.1))
    out = os.path.join(ROOT, "build", "smoke_stream")
    shutil.rmtree(out, ignore_errors=True)
    stats = sr.render_to_dir(frames, out)
    views = list(sr.render_stream(frames))
    for t in range(3):
        d = os.path.join(out, f"frame_{t:05d}")
        names = sorted(os.listdir(d))
        if names != [f"{i:02d}.png" for i in range(VIEWS)]:
            raise AssertionError(f"render_to_dir wrote {names[:3]}... in {d}")
        for i, name in enumerate(names):
            if not np.array_equal(io.decode(os.path.join(d, name))[..., :3], views[t][i]):
                raise AssertionError(f"{d}/{name} != the stream's view")
    shutil.rmtree(out, ignore_errors=True)
    log(f"[22] render_to_dir: 3 frames of {VIEWS} PNGs at {w}x{h} in {stats.total_s:.1f} s "
        f"({stats.fps:.3f} fps); they decode equal to the stream's views")


def phase23_batch(torch, np, lf, smi) -> dict:
    """interpolate_batch at full size: four trajectories share a center,
    one has another; fixed TEN and all-focus TEN. Each result equals its
    solo interpolate; one blend launch and one estimate per group."""
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.utils import profiling

    trajs = ["0,0,1,1", "0.2,0.2,0.8,0.8", "1,0,0,1", "0,0.5,1,0.5", "0,0,0.5,0.5"]
    interp = Interpolator(lf, device="cuda", progress=False)
    stats = {}
    for name, kw, want in (
            ("fixed", dict(focus=0.1), {"shift_blend": 2}),
            ("all-focus", dict(focus=0.1, focus_range=0.3),
             {"focus_estimate_exact": 2, "allfocus_blend": 2})):
        before = profiling.launch_counts()  # the main path's
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = interp.interpolate_batch(trajs, method="TEN", progress=False, **kw)
        batch_s = time.perf_counter() - t0
        counted = profiling.launch_counts() - before
        launches = {k: counted[k] for k in ("shift_blend", "focus_estimate_exact",
                                            "allfocus_blend")}
        if {k: v for k, v in launches.items() if v} != want:
            raise AssertionError(f"{name} batch launches {launches}, expected {want}")
        t0 = time.perf_counter()
        for t, res in zip(trajs, batch):
            solo = interp.interpolate(t, method="TEN", progress=False, **kw)
            if not (np.array_equal(res.views, solo.views)
                    and (solo.maps is None or np.array_equal(res.maps, solo.maps))):
                raise AssertionError(f"{name} batch result for {t} != its solo render")
        solo_s = time.perf_counter() - t0
        stats[name] = {"batch_s": batch_s, "solo_s": solo_s, "launches": launches}
        log(f"[23] interpolate_batch {name}, 5 trajectories (2 centers): {batch_s:.3f} s "
            f"against {solo_s:.3f} s for the 5 solo renders, both with downloads; launches "
            f"{launches}; every result == its solo render ({smi})")
        del batch
    del interp
    torch.cuda.empty_cache()
    return stats


def phase24_view_batches(torch, np, lf, smi) -> dict:
    """A forced view-batched render at full size (LFI_HBM_BYTES), fixed and
    all in focus, of at least 3 batches: equal to the one-pass render."""
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.core import capacity
    from lfinterpolator_tpu_torch.utils import profiling

    interp = Interpolator(lf, device="cuda", progress=False)
    budget = 700 * 10**6
    stats = {}
    for name, kw, k, kernel in (("fixed", dict(focus=0.1), 0, "shift_blend"),
                                ("all-focus", dict(focus=0.1, focus_range=0.3), 32,
                                 "allfocus_blend")):
        one_t, ref = wall_ms(torch, lambda: interp.interpolate(
            TRAJECTORY, method="TEN", progress=False, **kw), runs=2)
        plan = capacity.plan_render(COLS * ROWS, 3, H, W, VIEWS, method="TEN",
                                    focus_views=k, budget=budget)
        nb = -(-VIEWS // plan.view_batch) if plan.batched else 1
        if nb < 3:
            raise AssertionError(f"{name}: the forced plan has {nb} batches")
        os.environ["LFI_HBM_BYTES"] = str(budget)
        try:
            before = profiling.launch_counts()
            batched_t, out = wall_ms(torch, lambda: interp.interpolate(
                TRAJECTORY, method="TEN", progress=False, **kw), runs=2)
        finally:
            del os.environ["LFI_HBM_BYTES"]
        launched = (profiling.launch_counts() - before)[kernel]
        if launched != 2 * nb:
            raise AssertionError(f"{name}: {launched} launches for 2 x {nb} batches")
        if not (np.array_equal(out.views, ref.views)
                and (ref.maps is None or np.array_equal(out.maps, ref.maps))):
            raise AssertionError(f"{name}: the view-batched render != the one-pass render")
        stats[name] = {"batches": nb, "view_batch": plan.view_batch,
                       "one_pass_ms": one_t, "batched_ms": batched_t}
        log(f"[24] {name} in {nb} view batches of {plan.view_batch} (budget {budget / 1e6:.0f} "
            f"MB beyond the stack): {fmt(batched_t)} ms per call against {fmt(one_t)} ms in "
            f"one pass, downloads included; == the one-pass render ({smi})")
        del ref, out
    del interp
    torch.cuda.empty_cache()
    return stats


def phase25_library(torch, np, stack, smi) -> dict:
    """The yardsticks: one PyTorch call for each kernel's function where
    there is one, timed here and used nowhere in the port. The blends'
    contraction alone: torch.matmul of the [V, G] weights by a pre-shifted
    [G, C*H*W] stack, in fp16 and in f32 with TF32 off; the tile copy: one
    permute(...).contiguous()."""
    from lfinterpolator_tpu_torch.ops import blend_torch
    from lfinterpolator_tpu_torch.state import to_device_state

    wm, fo = weights_and_shifts(COLS, ROWS, H, W, 0.1)
    images, weights, shifts = to_device_state(stack, wm, fo, "cuda")
    x16 = blend_torch.shift_stack(images, shifts).reshape(COLS * ROWS, -1).half()
    del images
    w16 = weights.half()
    f16 = {v: event_ms(lambda v=v: torch.matmul(w16[:v], x16)) for v in (VIEWS, 45)}
    x32 = x16.float()
    del x16
    f32 = event_ms(lambda: blend_torch.matmul_f32(weights, x32), runs=5)
    del x32
    tiles = torch.from_numpy(stack[:45]).cuda().permute(0, 3, 1, 2).contiguous()
    copy = event_ms(lambda: tiles.reshape(9, 5, 3, H, W).permute(2, 0, 3, 1, 4)
                    .contiguous())
    del tiles
    torch.cuda.empty_cache()
    log(f"[25] contraction only, torch.matmul [64, 64] x [64, {3 * H * W}]: fp16 "
        f"{f16[VIEWS]:.3f} ms, f32 (TF32 off) {f32:.3f} ms; 45 views fp16 {f16[45]:.3f} ms; "
        f"tile copy permute().contiguous() {copy:.3f} ms ({smi})")
    return {"blend_fp16": f16[VIEWS], "blend_f32": f32, "quilt_fp16": f16[45],
            "copy": copy}


SCRIPTS = os.path.join(ROOT, "scripts")


def script(name: str):
    """Import scripts/<name>.py (the port's scripts import only the port)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def launched(name: str, counts: dict, needed) -> dict:
    """Raise unless every kernel of `needed` launched at least once in
    `counts` (the launches of one path); -> the nonzero counts."""
    missing = [k for k in needed if not counts.get(k)]
    if missing:
        raise AssertionError(f"{name}: kernels {missing} were launched no time ({counts})")
    return {k: v for k, v in counts.items() if v}


def slice6_launches(name: str, run: dict) -> int:
    """One kernel's launches on one path of phases 26-29: K2's are the
    shift_blend launches of the path's streamed frames, counted apart
    (``stream_launches``), and K1's the path's other shift_blend launches."""
    streamed = run["stream_launches"].get("shift_blend", 0)
    if name == "shift_blend (stream)":
        return streamed
    return run["launches"].get(name, 0) - (streamed if name == "shift_blend" else 0)


def phase26_gate_start() -> tuple:
    """Start the quality gate's three runs on the card, each a subprocess."""
    runs = {"plane": ["--scene", "plane"], "occlusion": ["--scene", "occlusion"],
            "pyramid": ["--scene", "plane", "--size", "192x512"]}
    work = os.path.join(ROOT, "build", "smoke_gate")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = {}
    for name, args in runs.items():  # output to files: nothing waits on a pipe
        with open(os.path.join(work, f"{name}.out"), "w") as out, \
                open(os.path.join(work, f"{name}.err"), "w") as err:
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.join(SCRIPTS, "torch_quality_gate.py"),
                 "--device", "cuda", *args], cwd=ROOT, stdout=out, stderr=err)
    log(f"[26] the gate's {len(runs)} runs started")
    return time.perf_counter(), work, procs


def phase26_gate(started, smi) -> dict:
    """The quality gate's three runs, read: every gated row >= 45 dB, the
    maps equal to the oracle's, the kernels of the path launched."""
    t0, work, procs = started
    out, launches, stream = {}, {}, {}
    for name, proc in procs.items():
        proc.wait(timeout=900)
        with open(os.path.join(work, f"{name}.out")) as f_out, \
                open(os.path.join(work, f"{name}.err")) as f_err:
            stdout, stderr = f_out.read(), f_err.read()
        if proc.returncode != 0 or not stdout.strip():
            raise AssertionError(f"the gate ({name}) exit {proc.returncode}: "
                                 f"{stdout[-2000:]} {stderr[-4000:]}")
        payload = json.loads(stdout.strip().splitlines()[-1])
        low = {k: v for k, v in payload["psnr_db"].items()
               if k in payload["gated"] and v != "inf" and v < payload["threshold_db"]}
        if not payload["pass"] or low or not all(payload["maps_equal_oracle"].values()):
            raise AssertionError(f"the gate ({name}) failed: {payload}")
        if (name == "pyramid") != ("pyramid/TEN" in payload["psnr_db"]):
            raise AssertionError(f"the gate ({name}): pyramid row {payload['psnr_db']}")
        needed = ["shift_blend", "allfocus_blend", "focus_estimate_exact",
                  "focus_estimate_fast", "quilt_blend"]
        launched(f"the gate ({name})", payload["launches"],
                 needed + ["focus_estimate_pyramid"] * (name == "pyramid"))
        launched(f"the gate's streamed frames ({name})", payload["stream_launches"],
                 ["shift_blend", "allfocus_blend"])
        for k, v in payload["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in payload["stream_launches"].items():
            stream[k] = stream.get(k, 0) + v
        out[name] = {k: payload[k] for k in ("psnr_db", "size", "grid")}
        if "pyramid_map_bytes_differ" in payload:
            out[name]["pyramid_map_bytes_differ"] = payload["pyramid_map_bytes_differ"]
        log(f"[26] gate, {name} scene {payload['scene']} at {payload['size']} "
            f"({payload['grid']}): {json.dumps(payload['psnr_db'])}; maps == oracle; "
            + (f"pyramid map bytes off the exact sweep "
               f"{payload['pyramid_map_bytes_differ']:.6f}; "
               if "pyramid_map_bytes_differ" in payload else "")
            + f"pass ({smi})")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[26] the gate's 3 runs ended {time.perf_counter() - t0:.1f} s after their start; "
        f"launches {launches}, of them in the streamed frames {stream}")
    return {"runs": out, "launches": launches, "stream_launches": stream}


def phase29_8k(torch, smi) -> dict:
    """The 8K all-focus TEN render under the card's real budget, through
    the Interpolator, with its band check."""
    from lfinterpolator_tpu_torch.utils import profiling

    bench = script("torch_bench_8k")
    torch.cuda.empty_cache()
    profiling.reset_launch_counts()
    res = bench.run(["TEN"], device="cuda", verify=True,
                    log=lambda m: log(f"[29] {m}"))
    torch.cuda.empty_cache()
    ten = res["methods"]["TEN"]
    if not ten["verify"]["ok"]:
        raise AssertionError(f"the 8K band check failed: {ten['verify']}")
    if set(ten["phases_ms"]) != set(bench.PHASES):
        raise AssertionError(f"the 8K render timed {ten['phases_ms']}, not {bench.PHASES}")
    launches = launched("the 8K render", profiling.launch_counts(),
                        ["focus_estimate_exact", "allfocus_blend"])
    log(f"[29] 8K TEN: {ten['plan']['arm']}, {ten['plan']['bytes_planned'] / 1e9:.3f} GB "
        f"planned + {ten['plan']['stack_bytes'] / 1e9:.3f} GB stack against "
        f"max_memory_allocated {ten['max_memory_allocated'] / 1e9:.3f} GB; upload "
        f"{res['upload_s']:.2f} s; first call {ten['first_call_s']:.3f} s, steady "
        f"{ten['steady_call_s']:.3f} s; {json.dumps(ten['phases_ms'])} ms; band check "
        f"rows {ten['verify']['rows']} passed; host peak {res['host_peak_rss_gib']:.1f} GiB; "
        f"launches {launches} ({smi})")
    return {"result": res, "launches": launches, "stream_launches": {}}  # streams nothing


def phase27_map_refresh(smi) -> dict:
    """The map-refresh harness at 1080p: 4x4, 6 frames, refresh 4, the
    occluders drifting 2 and 30 px a frame (30 px of 1920 is the share of
    the frame width that 2 px is of the harness's default 128)."""
    from lfinterpolator_tpu_torch.utils import profiling

    mr = script("torch_map_refresh_quality")
    out = {}
    profiling.reset_launch_counts()
    for speed in (2, 30):
        args = mr.parse_args(["--size", "1080x1920", "--grid", "4x4", "--frames", "6",
                              "--refresh", "4", "--speed", str(speed), "--device", "cuda"])
        t0 = time.perf_counter()
        text = json.dumps(mr.run(args), allow_nan=False)  # strict: raises on NaN/inf
        result = json.loads(text)
        if result["refresh"]["4"]["stale_frames"] != 4:
            raise AssertionError(f"map refresh at speed {speed}: {text}")
        out[speed] = result
        log(f"[27] map refresh 4 at 1080x1920, 4x4, 6 frames, {speed} px/frame in "
            f"{time.perf_counter() - t0:.1f} s: {text} ({smi})")
    launches = launched("the map-refresh harness", profiling.launch_counts(),
                        ["focus_estimate_exact", "allfocus_blend"])
    log(f"[27] launches {launches}")
    return {"results": out, "launches": launches, "stream_launches": launches}  # all streamed


def phase28_render_video(np) -> dict:
    """The video script on a seeded 4x4 tree of 3 frames at 270x480 (TEN,
    focus 0.1): its PNGs decode equal to the stream's views of the same
    frames, and a --resume run skips all 3."""
    import contextlib
    import io as pyio

    from lfinterpolator_tpu_torch import RenderConfig, StreamingRenderer
    from lfinterpolator_tpu_torch import io
    from lfinterpolator_tpu_torch.utils import profiling

    work = os.path.join(ROOT, "build", "smoke_video")
    shutil.rmtree(work, ignore_errors=True)
    cols = rows = 4
    h, w = 270, 480
    rng = np.random.default_rng(SEED + 3)
    frames = [rng.integers(0, 256, (cols * rows, h, w, 4), dtype=np.uint8) for _ in range(3)]
    for t, frame in enumerate(frames):
        frame[..., 3] = 255
        d = os.path.join(work, "in", f"f{t:03d}")
        os.makedirs(d)
        for i in range(cols * rows):
            io.encode_png(os.path.join(d, f"{i // rows}_{i % rows}.png"), frame[i])
    video = script("torch_render_video")
    argv = ["-i", os.path.join(work, "in"), "-o", os.path.join(work, "out"), "-t", TRAJECTORY,
            "-m", "TEN", "-f", "0.1", "--device", "cuda"]
    profiling.reset_launch_counts()
    text = pyio.StringIO()
    with contextlib.redirect_stdout(text):
        if video.main(argv) != 0:
            raise AssertionError("the video script failed")
    stats = json.loads(text.getvalue().strip().splitlines()[-1])
    launches = launched("the video script", profiling.launch_counts(),
                        ["shift_blend"])
    sr = StreamingRenderer(cols, rows, w, h, TRAJECTORY,
                           config=RenderConfig(method="TEN", focus=0.1))
    for t, views in enumerate(sr.render_stream(frames)):
        d = os.path.join(work, "out", f"frame_{t:05d}")
        names = sorted(os.listdir(d))
        if names != [f"{i:02d}.png" for i in range(VIEWS)]:
            raise AssertionError(f"the video script wrote {names[:3]}... in {d}")
        for i, name in enumerate(names):
            if not np.array_equal(io.decode(os.path.join(d, name))[..., :3], views[i]):
                raise AssertionError(f"{d}/{name} != the stream's view")
    text = pyio.StringIO()
    with contextlib.redirect_stdout(text):
        if video.main(argv + ["--resume"]) != 0:
            raise AssertionError("the video script's --resume run failed")
    resumed = json.loads(text.getvalue().strip().splitlines()[-1])
    if resumed["skipped"] != 3 or resumed["rendered"] != 0:
        raise AssertionError(f"--resume did not skip every frame: {resumed}")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[28] the video script: 3 frames of {VIEWS} PNGs at {w}x{h} in "
        f"{stats['total_s']:.2f} s ({stats['fps']:.3f} fps; decode {stats['decode_s']:.2f} s, "
        f"encode {stats['encode_s']:.2f} s summed over the writer threads); they decode "
        f"equal to the stream's views; --resume skipped all 3; launches {launches}")
    return {"stats": stats, "launches": launches, "stream_launches": launches}  # all streamed


# -- phase 32: multi-GPU rendering (slice 5) ---------------------------------

# (tag, method, focus range, exact taps) of the renders both meshes drive
MESH_RENDERS = [("fixed TEN", "TEN", 0.0, True), ("all-focus TEN", "TEN", 0.3, True),
                ("all-focus STD", "STD", 0.3, True), ("fast", "TEN", 0.3, False)]
MESH_TRAJECTORIES = ["0,0,1,1", "0.2,0.2,0.8,0.8", "0,0.5,1,0.5"]
MESH_TIMEOUT_S = 300


def digest(np, *arrays) -> str:
    """A 128-bit hash of the arrays' bytes: equal digests stand for
    torch.equal between processes."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(memoryview(np.ascontiguousarray(a)).cast("B"))
    return h.hexdigest()


def set_taps(interp, exact: bool) -> None:
    """The tap rule of `interp`'s later all-focus renders."""
    import dataclasses

    interp.config = dataclasses.replace(interp.config, exact_focus_taps=exact)


def ms3(times) -> str:
    return "/".join(f"{t:.3f}" for t in times)


def mesh_render(interp, method: str, focus_range: float, exact: bool):
    """One of MESH_RENDERS at focus 0.1."""
    set_taps(interp, exact)
    return interp.interpolate(TRAJECTORY, focus=0.1, focus_range=focus_range,
                              method=method, progress=False)


def result_digest(np, res) -> str:
    return digest(np, res.views, *([] if res.maps is None else [res.maps]))


def shard_bytes(nv: int, ns: int) -> dict:
    """Per-rank bytes of a fixed TEN and an all-focus TEN render at the
    headline size on an (nv, ns) mesh (parallel.mesh's arithmetic): the
    shard step's peak ("render") and the gather's, each with the stack."""
    from lfinterpolator_tpu_torch.core import geometry
    from lfinterpolator_tpu_torch.parallel import mesh

    radius = geometry.block_radius(W, H)
    g = COLS * ROWS
    fixed = mesh.fixed_shard_bytes(nv, ns, g, 3, H, W, VIEWS, method="TEN")
    af = mesh.allfocus_shard_bytes(nv, ns, g, 32, 3, H, W, VIEWS, radius=radius,
                                   filter_radius=(radius[0] // 2, radius[1] // 2),
                                   steps=32)
    return {"fixed TEN": {"resident": fixed["stack"], "render": fixed["render"],
                          "gather": fixed["gather"]},
            "all-focus TEN": {"resident": af["stack"],
                              "render": max(af["estimate"], af["filter"], af["blend"]),
                              "gather": af["gather"]}}


def mesh_peaks(torch, interp, focus_range: float) -> dict:
    """max_memory_allocated of a TEN render on `interp`'s mesh, per part:
    the shard step ("render"), the gather of the views and maps to every
    rank ("gather"), and their download beside them ("download"); and what
    was allocated before the step ("resident": the stack and whatever else
    the process holds)."""
    set_taps(interp, True)
    cfg, key = interp._config(0.1, focus_range, "TEN", None, None)
    step = interp._render_step(TRAJECTORY, cfg, key, False)
    torch.cuda.synchronize()
    peaks = {"resident": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    peaks["render"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full = interp._collect(*out)
    torch.cuda.synchronize()
    peaks["gather"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    interp._to_host(*full)
    peaks["download"] = torch.cuda.max_memory_allocated()
    return peaks


def peaks_line(peaks: dict, arithmetic: dict) -> str:
    return "; ".join(
        f"{tag}: " + ", ".join(f"{part} {peaks[tag][part] / 1e9:.3f}"
                               + (f" (arithmetic {arithmetic[tag][part] / 1e9:.3f})"
                                  if part in arithmetic[tag] else "")
                               for part in peaks[tag])
        for tag in peaks) + " GB"


def mesh_timings(torch, interp, m, runs: int = 3) -> dict:
    """ms of this rank's all-focus TEN shard step (CUDA events; it holds
    the map's all-gather), of the map's all-gather alone and of the views'
    all-gather (host clock), each run starting after a barrier."""
    from lfinterpolator_tpu_torch.parallel import mesh

    set_taps(interp, True)
    cfg, key = interp._config(0.1, 0.3, "TEN", None, None)
    step = interp._render_step(TRAJECTORY, cfg, key, False)
    views_l, maps_l = step()
    out = {"step_ms": [], "map_gather_ms": [], "views_gather_ms": []}
    for _ in range(runs):
        mesh.sync("cuda")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step()
        end.record()
        end.synchronize()
        out["step_ms"].append(start.elapsed_time(end))
        for name, fn in (("map_gather_ms", lambda: mesh.gather_rows(m, maps_l[0])),
                         ("views_gather_ms", lambda: mesh.gather_views_device(m, views_l))):
            mesh.sync("cuda")
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[name].append(1000 * (time.perf_counter() - t0))
    return out


def mesh_rank(rank: int, work: str, want: dict) -> None:
    """One of the four gloo ranks of phase 32 (a spawned process; the
    kernels were built by the parent): the seeded headline light field
    from the seed, the renders of MESH_RENDERS on the (2, 2) mesh, each
    one's digest against the parent's one-device render, launches,
    timings and peak memory to work/rank<rank>.json."""
    import numpy as np
    import torch

    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.parallel import distributed, mesh
    from lfinterpolator_tpu_torch.utils import profiling

    distributed.initialize("file://" + os.path.join(work, "gloo"), 4, rank,
                           backend="gloo", timeout_s=120)
    try:
        m = mesh.make_mesh()
        interp = Interpolator(seeded_light_field(np), device="cuda", progress=False,
                              mesh=m)
        out = {"rank": rank, "coordinate": list(m.get_coordinate()), "equal": {}}
        profiling.reset_launch_counts()
        for tag, method, focus_range, exact in MESH_RENDERS:
            out["equal"][tag] = result_digest(
                np, mesh_render(interp, method, focus_range, exact)) == want[tag]
        out["launches"] = profiling.launch_counts()
        out["max_memory_allocated"] = {"fixed TEN": mesh_peaks(torch, interp, 0.0),
                                       "all-focus TEN": mesh_peaks(torch, interp, 0.3)}
        out.update(mesh_timings(torch, interp, m))
        out["foreign"] = [k for k in sys.modules if k in ("jax", "lfinterpolator_tpu")
                          or k.startswith(("jax.", "jaxlib", "lfinterpolator_tpu."))]
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        mesh.sync("cuda")
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def phase32_mesh(torch, np, lf, smi) -> dict:
    """The multi-GPU path on one card: a (1, 1) mesh over NCCL in this
    process, then a (2, 2) mesh of four gloo ranks sharing the card, each
    render equal to the one-device render of the same call."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.parallel import distributed, mesh
    from lfinterpolator_tpu_torch.utils import profiling

    work = tempfile.mkdtemp(prefix="lfi_mesh_")
    renders = MESH_RENDERS + [("fixed STD", "STD", 0.0, True)]
    one = Interpolator(lf, device="cuda", progress=False)
    want = {tag: mesh_render(one, *r) for tag, *r in renders}
    want_quilt = one.render_quilt(TRAJECTORY, focus=0.1, method="TEN", progress=False)
    want_batch = one.interpolate_batch(MESH_TRAJECTORIES, focus=0.1, method="TEN",
                                       progress=False)
    set_taps(one, True)
    cfg, key = one._config(0.1, 0.3, "TEN", None, None)
    one_ms = event_ms(one._render_step(TRAJECTORY, cfg, key, False), runs=5)
    del one
    torch.cuda.empty_cache()

    # (1, 1) over NCCL, in this process
    t0 = time.perf_counter()
    distributed.initialize("file://" + os.path.join(work, "nccl"), 1, 0, backend="nccl")
    m = mesh.make_mesh()
    init_ms = 1000 * (time.perf_counter() - t0)
    try:
        meshed = Interpolator(lf, device="cuda", progress=False, mesh=m)
        profiling.reset_launch_counts()  # the mesh path's launches
        got = {tag: mesh_render(meshed, *r) for tag, *r in renders}
        got_quilt = meshed.render_quilt(TRAJECTORY, focus=0.1, method="TEN",
                                        progress=False)
        got_batch = meshed.interpolate_batch(MESH_TRAJECTORIES, focus=0.1, method="TEN",
                                             progress=False)
        nccl_launches = launched(
            "the (1, 1) NCCL mesh", profiling.launch_counts(),
            ["shift_blend", "allfocus_blend", "focus_estimate_exact",
             "focus_estimate_fast", "quilt_copy"])
        for tag, _, _, _ in renders:
            if not (np.array_equal(got[tag].views, want[tag].views)
                    and (want[tag].maps is None
                         or np.array_equal(got[tag].maps, want[tag].maps))):
                raise AssertionError(f"(1, 1) mesh {tag} != the one-device render")
        if got_quilt.fused or not np.array_equal(got_quilt.quilt, want_quilt.quilt):
            raise AssertionError("the (1, 1) mesh's two-stage quilt != the fused quilt")
        for t, a, b in zip(MESH_TRAJECTORIES, got_batch, want_batch):
            if not np.array_equal(a.views, b.views):
                raise AssertionError(f"(1, 1) mesh batch result for {t} != one device")
        mesh_ms = event_ms(meshed._render_step(TRAJECTORY, cfg, key, False), runs=5)
        nccl_peaks = {"fixed TEN": mesh_peaks(torch, meshed, 0.0),
                      "all-focus TEN": mesh_peaks(torch, meshed, 0.3)}
        del meshed
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    nccl_bytes = shard_bytes(1, 1)
    log(f"[32] (1, 1) mesh over NCCL in this process: init {init_ms:.1f} ms; fixed TEN "
        f"and STD, all-focus TEN and STD, --fast-focus, render_quilt (two-stage) and "
        f"interpolate_batch of {len(MESH_TRAJECTORIES)} trajectories each equal to the "
        f"one-device call (views and maps); launches {nccl_launches}; all-focus TEN step "
        f"{mesh_ms:.3f} ms against {one_ms:.3f} ms on one device (CUDA events); "
        f"max_memory_allocated {peaks_line(nccl_peaks, nccl_bytes)} ({smi})")

    # (2, 2) over gloo: four ranks sharing the card
    digests = {tag: result_digest(np, want[tag]) for tag, *_ in MESH_RENDERS}
    del want
    t0 = time.perf_counter()
    ctx = mp.start_processes(mesh_rank, args=(work, digests), nprocs=4, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):  # raises if a rank failed
            if time.monotonic() > deadline:
                raise AssertionError(f"the gloo ranks ran over {MESH_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(4):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)
    for out in ranks:
        if not all(out["equal"].values()) or out["foreign"]:
            raise AssertionError(f"gloo rank {out['rank']}: equal {out['equal']}, "
                                 f"foreign modules {out['foreign'][:5]}")
        launched(f"gloo rank {out['rank']}", out["launches"],
                 ["shift_blend", "allfocus_blend", "focus_estimate_exact",
                  "focus_estimate_fast"])
    gloo_bytes = shard_bytes(2, 2)
    for out in ranks:
        log(f"[32] gloo rank {out['rank']} at {out['coordinate']}: all-focus TEN shard "
            f"step {ms3(out['step_ms'])} ms (CUDA events), map all-gather "
            f"{ms3(out['map_gather_ms'])} ms, views all-gather {ms3(out['views_gather_ms'])} "
            f"ms (host clock); max_memory_allocated "
            f"{peaks_line(out['max_memory_allocated'], gloo_bytes)}; launches "
            f"{ {k: v for k, v in out['launches'].items() if v} }")
    log(f"[32] (2, 2) mesh of four gloo ranks time-sharing one card (not a scaling "
        f"measurement): fixed TEN, all-focus TEN and STD and --fast-focus equal to the "
        f"one-device render on every rank (views and maps, by 128-bit digests); gloo took "
        f"the CUDA tensors of every broadcast and all-gather as they are; "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start; one-device all-focus TEN "
        f"step {one_ms:.3f} ms ({smi})")
    return {"nccl": {"init_ms": init_ms, "step_ms": mesh_ms, "one_device_ms": one_ms,
                     "max_memory_allocated": nccl_peaks, "bytes": nccl_bytes,
                     "launches": nccl_launches},
            "gloo": {"ranks": ranks, "bytes": gloo_bytes}}


# -- phase 33: the archive's 17x17 grid, past 256 images ---------------------

WIDE = 17  # the Stanford Light Field Archive's gantry grid: 17x17 views
WIDE_HW = 1024
WIDE_FOCUS = 0.2  # fixed focus, on the refocus slider of the benchmark's cell
WIDE_WINDOW = (0.0, 0.07)  # all in focus: the benchmark cell's focus window


def wide_row(torch, name, kernel_fn, plain_fn, got, stack, weights, nbytes, smi) -> dict:
    """A blend wrapper's launch `got` of the 17x17 grid held to its plain
    version (at most 1 LSB) and to the exact sums of `stack` (the near-tie
    rule), both timed; -> the kernels line's fields."""
    rule = check_rule(torch, f"{name} at 17x17/1024^2", got, stack, weights)
    err, differ = check_1lsb(torch, f"{name} against plain at 17x17/1024^2", got,
                             plain_fn())
    ms = event_ms(kernel_fn)
    plain_ms = event_ms(plain_fn, runs=3)
    g, n = weights.shape[1], 3 * WIDE_HW * WIDE_HW
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes, 2 * VIEWS * g * n, "fp16")}
    log(f"[33] {name}: near-tie rule holds on {rule['bytes']} bytes ({rule['lax']} in the "
        f"lax band); <= 1 LSB from plain, {differ} bytes differ; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms ({smi})")
    return row


def phase33_wide_grid(torch, np, smi) -> list:
    """The Interpolator on a seeded 17x17 grid of 1024x1024 images (289, so
    both blends run in passes over the images), fixed TEN and all in focus,
    each render's launches and passes counted from a reset just before it;
    the blend wrappers on the same inputs equal to the render and held to
    their plain versions. -> the kernels line's two rows."""
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.io import LightField
    from lfinterpolator_tpu_torch.ops import (
        _build, allfocus_blend, blend_torch, focus_torch, shift_blend)
    from lfinterpolator_tpu_torch.state import render_params, upload_params
    from lfinterpolator_tpu_torch.utils import profiling, scenes

    g, hw, n = WIDE * WIDE, WIDE_HW, 3 * WIDE_HW * WIDE_HW
    focus, window = WIDE_WINDOW
    lf = LightField(images=scenes.make_occlusion_scene(
        WIDE, WIDE, hw, hw, plane_foci=scenes.occlusion_foci(focus, window)),
        cols=WIDE, rows=WIDE)
    interp = Interpolator(lf, device="cuda", progress=False)
    del lf
    images = interp.images
    passes = _build.load().lfi_blend_grid_passes(g)
    if passes < 2:
        raise AssertionError(f"a grid of {g} images runs in {passes} pass")
    src = "lfinterpolator_tpu_torch/csrc/"
    rows = []

    def counted(kernel, **kw):
        profiling.reset_launch_counts()
        res = interp.interpolate(TRAJECTORY, method="TEN", benchmark_runs=5,
                                 progress=False, **kw)
        counts = profiling.launch_counts()
        launches = counts[kernel]
        if launches < 1:
            raise AssertionError(f"{kernel} was launched no time: {dict(counts)}")
        log(f"[33] {kernel}: {res.avg_ms:.3f} ms/frame over 5 runs; launches "
            f"{dict(counts)}, {passes} passes each ({smi})")
        return res, {"launches": launches, "passes": launches * passes}

    res, counts = counted("shift_blend", focus=WIDE_FOCUS)
    wm, fo = render_params(TRAJECTORY, cols=WIDE, rows=WIDE, height=hw, width=hw,
                           focus=WIDE_FOCUS, effect=EFFECT, views=VIEWS)
    weights, shifts = upload_params(wm, fo, "cuda")
    got = shift_blend.shift_blend(images, weights, shifts)
    if not np.array_equal(blend_torch.from_planar(got).cpu().numpy(), res.views):
        raise AssertionError("shift_blend at 17x17 != the Interpolator's TEN render")
    del res
    rows.append({"name": "shift_blend (17x17)", "route": "cuda", "source": src + "shift_blend.cu",
                 "replaces": "the shift_blend row's, at G = 289: shift_blend_kernel<*, true>, "
                             "in passes over the images",
                 **counts, **wide_row(
                     torch, "shift_blend", lambda: shift_blend.shift_blend(images, weights, shifts),
                     lambda: shift_blend.shift_blend_reference(images, weights, shifts), got,
                     blend_torch.shift_stack(images, shifts), weights,
                     g * n + VIEWS * n + 4 * VIEWS * g + 8 * g, smi)})
    del got
    torch.cuda.empty_cache()

    res, counts = counted("allfocus_blend", focus=focus, focus_range=window)
    p, weights, offsets, ids, tables = allfocus_setup(focus, window, WIDE, WIDE, hw, hw)
    map0 = focus_torch.estimate_focus_map(images[ids], offsets[ids], tables, p.radius, True)
    map1 = focus_torch.filter_focus_map(map0, p.filter_radius)
    if not (np.array_equal(res.maps[0], map0.cpu().numpy())
            and np.array_equal(res.maps[1], map1.cpu().numpy())):
        raise AssertionError("the 17x17 all-focus maps != the plain pipeline's")
    distinct = len(torch.unique(map0))
    if distinct < 2:
        raise AssertionError("the 17x17 map0 is constant, the check proves nothing")
    args = (images, weights, offsets, map0, tables.decode)
    got = allfocus_blend.allfocus_blend(*args)
    if not np.array_equal(blend_torch.from_planar(got).cpu().numpy(), res.views):
        raise AssertionError("allfocus_blend at 17x17 != the Interpolator's TEN render")
    del res
    log(f"[33] all in focus: maps == the plain pipeline's ({distinct} distinct bytes in map0)")
    rows.append({"name": "allfocus_blend (17x17)", "route": "cuda",
                 "source": src + "allfocus_blend.cu",
                 "replaces": "the allfocus_blend row's, at G = 289: allfocus_blend_kernel<true>, "
                             "in passes over the images",
                 **counts, **wide_row(
                     torch, "allfocus_blend", lambda: allfocus_blend.allfocus_blend(*args),
                     lambda: allfocus_blend.allfocus_blend_reference(*args), got,
                     blend_torch.allfocus_selected(images, offsets, map0, tables.decode),
                     weights, g * n + VIEWS * n + 4 * VIEWS * g + 8 * g + hw * hw + 1024,
                     smi)})
    del got, interp, images
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    import lfinterpolator_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    smi = phase1_environment(torch)
    phase2_build()
    rng = np.random.default_rng(SEED)
    stack = rng.integers(0, 256, (COLS * ROWS, H, W, 3), dtype=np.uint8)
    k3 = phase3_kernel_vs_plain(torch, np, stack, smi)
    phase4_oracle(torch, np)
    lf = seeded_light_field(np)
    ten, std, launches = phase5_api(torch, np, lf, smi)
    del ten, std
    est, state7 = phase7_estimate_vs_plain(torch, np, stack, smi)
    k8 = phase8_allfocus_vs_plain(torch, smi, state7)
    del state7, stack
    torch.cuda.empty_cache()
    phase9_new_kernels_vs_oracle(torch, np)
    af_ten, af_launches = phase10_allfocus_api(torch, np, lf, smi)
    run_cli(np, 11, lf.images, [(["-m", "TEN", "-f", "0.1", "-r", "0.3"],
                                 view_files(np, af_ten.views, af_ten.maps))])
    del af_ten
    k9, pyr = phase12_presence_vs_plain(torch, np, smi)
    torch.cuda.empty_cache()
    phase13_pyramid_vs_plain(torch, np, smi)
    torch.cuda.empty_cache()
    pyr_launches = phase14_pyramid_api(torch, np, lf, smi)
    k4, tiles = phase15_quilt_blend_vs_plain(torch, np, smi)
    k5 = phase16_quilt_copy_vs_plain(torch, np, tiles, smi)
    del tiles
    torch.cuda.empty_cache()
    quilt_launches = phase17_render_quilt(torch, np, lf, smi)
    phase18_cli(torch, np, lf)
    download = phase19_download(torch, np, lf, smi)
    stack = np.random.default_rng(SEED).integers(0, 256, (COLS * ROWS, H, W, 3),
                                                 dtype=np.uint8)  # phase 3's
    k2 = phase20_stream(torch, np, stack, smi)
    af_fps = phase21_allfocus_stream(torch, np, lf, smi)
    phase22_render_to_dir(torch, np, lf)
    batch = phase23_batch(torch, np, lf, smi)
    view_batches = phase24_view_batches(torch, np, lf, smi)
    lib = phase25_library(torch, np, stack, smi)
    del stack
    torch.cuda.empty_cache()
    gate = phase26_gate_start()
    try:
        slice6 = {"map_refresh": phase27_map_refresh(smi), "video": phase28_render_video(np)}
        slice6["gate"] = phase26_gate(gate, smi)
    finally:  # no gate run outlives a failure
        for proc in gate[2].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    slice6["8k"] = phase29_8k(torch, smi)
    mesh_run = phase32_mesh(torch, np, lf, smi)
    wide = phase33_wide_grid(torch, np, smi)
    foreign = [m for m in sys.modules if m in ("jax", "lfinterpolator_tpu")
               or m.startswith(("jax.", "jaxlib", "lfinterpolator_tpu."))]
    if foreign:
        raise AssertionError(f"the port imported jax or the JAX package: {foreign[:5]}")
    log("[30] no module of jax or of the JAX package (lfinterpolator_tpu) is loaded "
        "(parallel.distributed and parallel.mesh included, after phase 32's NCCL mesh; "
        "each gloo rank checked its own)")
    g, n, k, s_ = COLS * ROWS, 3 * H * W, 32, 32
    blend_bound = bound(g * n + VIEWS * n + 4 * VIEWS * g + 8 * g, 2 * VIEWS * g * n, "fp16")
    contraction = {"library_ms": lib["blend_fp16"], "library_f32_ms": lib["blend_f32"],
                   "library": "torch.matmul [V, G] x [G, C*H*W] of a pre-shifted stack, "
                              "contraction only (fp16; library_f32_ms: f32, TF32 off)"}
    # the estimate reads the RGBx words once and writes the map; its
    # operations are the word min/max of the hoisted formulation (a min and
    # a max per view, candidate and pixel of the frame extended by the
    # radius), at the integer rate outside the tensor cores
    from lfinterpolator_tpu_torch.core import geometry

    rx, ry = geometry.block_radius(W, H)  # phase 7's stencil radius
    est_ops = 2 * k * s_ * (H + 2 * ry) * (W + 2 * rx)
    est_bound = bound(4 * k * H * W + H * W, est_ops, "int32")
    no_library = {"library_ms": None, "library": "none: no PyTorch call computes it"}
    src = "lfinterpolator_tpu_torch/csrc/"
    kernels = [
        {"name": "shift_blend", "route": "cuda", "source": src + "shift_blend.cu",
         "replaces": "lfinterpolator_tpu/ops/shift_pallas.py:277 "
                     "(_pshift_kernel), lfinterpolator_tpu/ops/blend_pallas.py:217 "
                     "(_blend_tiled_kernel), lfinterpolator_tpu/ops/blend_pallas.py:165 "
                     "(_blend_kernel)",
         "launches": launches, **k3, **blend_bound, **contraction},
        {"name": "shift_blend (stream)", "route": "cuda", "source": src + "shift_blend.cu",
         "replaces": "lfinterpolator_tpu/ops/shift_pallas.py:90 (_shift_kernel)",
         "launches": k2["launches"], "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], **blend_bound, **contraction},
        {"name": "allfocus_blend", "route": "cuda", "source": src + "allfocus_blend.cu",
         "replaces": "lfinterpolator_tpu/ops/allfocus_pallas.py:102 (_af_kernel), "
                     "lfinterpolator_tpu/ops/blend_pallas.py:217 (_blend_tiled_kernel)",
         "launches": af_launches["allfocus_blend"], **k8,
         **bound(g * n + VIEWS * n + 4 * VIEWS * g + 8 * g + H * W + 1024,
                 2 * VIEWS * g * n, "fp16"), **contraction},
        {"name": "focus_estimate_exact", "route": "cuda",
         "source": src + "focus_estimate.cu",
         "replaces": "lfinterpolator_tpu/ops/estimate_pallas.py:271 (_est_kernel)",
         "launches": af_launches["focus_estimate_exact"], **est["exact"], **est_bound,
         **no_library},
        {"name": "focus_estimate_fast", "route": "cuda",
         "source": src + "focus_estimate.cu",
         "replaces": "lfinterpolator_tpu/ops/estimate_pallas.py:587 (_est_fast_kernel)",
         "launches": af_launches["focus_estimate_fast"], **est["fast"], **est_bound,
         **no_library},
        {"name": "focus_estimate_pyramid", "route": "cuda",
         "source": src + "focus_estimate.cu",
         "replaces": "lfinterpolator_tpu/ops/estimate_pallas.py:271 "
                     "(_est_kernel, predicated=True: :320-338, 502, 540; entries "
                     "_estimate_fused_pres :1238, estimate_fused_pyramid :1251)",
         "launches": pyr_launches, **k9,
         **bound(4 * k * H * W + H * W,
                 est_ops * float(pyr["random_density"].split()[0]), "int32"),
         **no_library},
        {"name": "quilt_blend", "route": "cuda", "source": src + "shift_blend.cu",
         "replaces": "lfinterpolator_tpu/ops/blend_pallas.py:311 (_blend_quilt_kernel), "
                     "lfinterpolator_tpu/ops/shift_pallas.py:277 (_pshift_kernel)",
         "launches": quilt_launches["quilt_blend"], **k4,
         **bound(g * n + 45 * n + 4 * VIEWS * g + 8 * g, 2 * 45 * g * n, "fp16"),
         "library_ms": lib["quilt_fp16"],
         "library": "torch.matmul [45, G] x [G, C*H*W] fp16, contraction only"},
        {"name": "quilt_copy", "route": "cuda", "source": src + "quilt.cu",
         "replaces": "lfinterpolator_tpu/ops/quilt.py:38 (_copy_kernel)",
         "launches": quilt_launches["quilt_copy"], **k5,
         **bound(2 * 45 * n, 0, "fp16"), "library_ms": lib["copy"],
         "library": "tiles.reshape(9, 5, C, H, W).permute(2, 0, 3, 1, 4).contiguous()"},
    ]
    kernels += wide
    for kernel in kernels:
        kernel["launches_slice6"] = {  # phases 26-29, each path's own count
            path: slice6_launches(kernel["name"], r) for path, r in slice6.items()}
        # phase 32: the (1, 1) NCCL mesh's launches and each gloo rank's
        kernel["launches_mesh"] = {
            "nccl_1x1": mesh_run["nccl"]["launches"].get(kernel["name"], 0),
            "gloo_2x2_ranks": [r["launches"].get(kernel["name"], 0)
                               for r in mesh_run["gloo"]["ranks"]]}
    log(f"[31] download {json.dumps(download)}")
    log(f"[31] stream {json.dumps(k2)}; all-focus stream fps {json.dumps(af_fps)}")
    log(f"[31] batch {json.dumps(batch)}")
    log(f"[31] view batches {json.dumps(view_batches)}")
    log(f"[31] predicated estimate at full size: {pyr}")
    log(f"[31] gate {json.dumps(slice6['gate']['runs'])}")
    log(f"[31] 8K {json.dumps(slice6['8k']['result'])}")
    log(f"[31] mesh {json.dumps({k: v for k, v in mesh_run['nccl'].items()})}")
    log(f"[31] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
