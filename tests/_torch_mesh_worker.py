"""The ranks of tests/test_torch_mesh.py: gloo processes on the CPU.

``launch(world, work_dir, case)`` spawns `world` ranks of one process group
(a ``file://`` store under `work_dir`, so that concurrent test workers
never share a port), each running ``CASES[case]`` on the inputs the test
saved in ``work_dir/inputs.npz``; rank 0 saves the results to
``work_dir/<case>.npz``. A rank that raises fails the launch with its
traceback, and a launch that outlives its time limit is killed. This module
imports nothing of jax or the JAX package: the ranks run the port alone.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120  # one launch
GROUP_TIMEOUT_S = 60  # one collective


def launch(world: int, work_dir: str, case: str, timeout_s: float = TIMEOUT_S) -> dict:
    """Run ``CASES[case]`` on `world` gloo ranks; -> rank 0's results (the
    arrays, and "json": its other values)."""
    ctx = mp.start_processes(_rank_main, args=(world, work_dir, case), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {case} launch of {world} ranks took over "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    with np.load(os.path.join(work_dir, f"{case}.npz")) as f:
        out = dict(f)
    out["json"] = json.loads(str(out["json"]))
    return out


def _rank_main(rank: int, world: int, work_dir: str, case: str) -> None:
    torch.set_num_threads(1)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch.distributed as dist

    from lfinterpolator_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{os.path.join(work_dir, 'store')}", world, rank,
                           backend="gloo", timeout_s=GROUP_TIMEOUT_S)
    try:
        with np.load(os.path.join(work_dir, "inputs.npz")) as f:
            inputs = dict(f)
        arrays, values = CASES[case](inputs)
        if rank == 0:
            np.savez(os.path.join(work_dir, f"{case}.npz"), json=json.dumps(values),
                     **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _error(fn) -> str:
    """The message of the ValueError that `fn()` raises ("" if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def case_fixed(inputs: dict) -> tuple[dict, dict]:
    """World 8: mesh shapes, initialize twice, local_shard_info, and
    render_fixed_sharded for STD and TEN at view factors 1, 2, 4 and 8."""
    import torch.distributed as dist

    from lfinterpolator_tpu_torch.parallel import distributed, mesh

    values = {"shapes": {}}
    for vp in (None, 1, 2, 4, 8):
        m = mesh.make_mesh(vp)
        values["shapes"][str(vp)] = [mesh.axis_size(m, "view"), mesh.axis_size(m, "space")]
    values["bad_split"] = _error(lambda: mesh.make_mesh(3))
    distributed.initialize("file:///nonexistent/store", 8, 0, backend="gloo")  # no-op
    values["world_after_second_init"] = dist.get_world_size()
    values["info"] = distributed.local_shard_info()
    values["multi_host"] = distributed.is_multi_host()

    images = torch.from_numpy(np.ascontiguousarray(
        inputs["images"][..., :3].transpose(0, 3, 1, 2)))
    weights = torch.from_numpy(inputs["weights"])
    shifts = torch.from_numpy(inputs["shifts"])
    arrays = {}
    for vp in (1, 2, 4, 8):
        m = mesh.make_mesh(vp)
        imgs, w_l = mesh.shard_inputs(m, images.clone(), weights)
        for method in ("STD", "TEN"):
            out = mesh.render_fixed_sharded(m, imgs, w_l, shifts, method)
            arrays[f"views_{vp}_{method}"] = mesh.gather_views(m, out)
    m = mesh.make_mesh(2)
    short = images[:, :, :30].contiguous()  # 30 rows over 4 space ranks
    values["bad_rows"] = _error(
        lambda: mesh.render_fixed_sharded(m, short, mesh.shard_weights(m, weights), shifts))
    return arrays, values


def _tables(inputs):
    from lfinterpolator_tpu_torch.ops.estimate_geometry import FocusTables

    return FocusTables(*(torch.from_numpy(inputs[k])
                         for k in ("candidates", "candidate_bytes", "decode")))


def case_allfocus(inputs: dict) -> tuple[dict, dict]:
    """World 4, mesh (2, 2): render_all_focus_sharded for STD, TEN and the
    fast tap rule."""
    from lfinterpolator_tpu_torch.parallel import mesh

    m = mesh.make_mesh()
    images = torch.from_numpy(np.ascontiguousarray(
        inputs["images"][..., :3].transpose(0, 3, 1, 2)))
    images, weights_l = mesh.shard_inputs(m, images, torch.from_numpy(inputs["weights"]))
    offsets = torch.from_numpy(inputs["offsets"])
    ids = torch.from_numpy(inputs["ids"].astype(np.int64))
    arrays = {}
    for tag, method, exact in (("STD", "STD", True), ("TEN", "TEN", True),
                               ("fast", "TEN", False)):
        views_l, maps_l = mesh.render_all_focus_sharded(
            m, images, weights_l, offsets, ids, _tables(inputs), method=method,
            radius=tuple(inputs["radius"]), filter_radius=tuple(inputs["filter_radius"]),
            exact_taps=exact)
        arrays[f"views_{tag}"] = mesh.gather_views(m, views_l)
        arrays[f"maps_{tag}"] = mesh.gather_rows(m, maps_l).numpy()
    return arrays, {}


def case_api(inputs: dict) -> tuple[dict, dict]:
    """World 4, mesh (2, 2): the Interpolator's mesh arms."""
    from lfinterpolator_tpu_torch.api import Interpolator
    from lfinterpolator_tpu_torch.core.config import RenderConfig
    from lfinterpolator_tpu_torch.io import LightField
    from lfinterpolator_tpu_torch.ops import focus_estimate
    from lfinterpolator_tpu_torch.parallel import mesh

    m = mesh.make_mesh()
    lf = LightField(inputs["images"], 4, 4)
    cfg = RenderConfig(view_count=8, focus_map_views=8, focus_steps=8)
    interp = Interpolator(lf, config=cfg, progress=False, device="cpu", mesh=m)
    arrays, values = {}, {}
    for method in ("STD", "TEN"):
        r = interp.interpolate("0,0,1,1", focus=0.3, method=method, progress=False)
        arrays[f"fixed_{method}"] = r.views
    for tag, method, exact in (("STD", "STD", True), ("TEN", "TEN", True),
                               ("fast", "TEN", False)):
        it = Interpolator(lf, config=RenderConfig(
            view_count=8, focus_map_views=8, focus_steps=8, exact_focus_taps=exact),
            progress=False, device="cpu", mesh=m)
        r = it.interpolate("0,0,1,1", focus=0.0, focus_range=0.5, method=method,
                           progress=False)
        arrays[f"af_views_{tag}"], arrays[f"af_maps_{tag}"] = r.views, r.maps
    r = interp.interpolate("0,0,1,1", focus=0.3, method="TEN", benchmark_runs=2,
                           progress=False)
    values["run_times"] = len(r.run_times_s)
    q = interp.render_quilt("0,0,1,1", focus=0.3, method="TEN", cols=4, rows=2,
                            progress=False)
    arrays["quilt"], values["quilt_fused"] = q.quilt, q.fused
    trajs = ["0,0,1,1", "0.25,0.25,0.75,0.75", "0,0.5,1,0.5"]
    for tag, kw in (("fixed", {"focus": 0.3}), ("af", {"focus": 0.1, "focus_range": 0.2})):
        for i, res in enumerate(interp.interpolate_batch(trajs, progress=False, **kw)):
            arrays[f"batch_{tag}_{i}"] = res.views
            if res.maps is not None:
                arrays[f"batch_{tag}_maps_{i}"] = res.maps

    values["bad_height"] = _error(lambda: Interpolator(
        LightField(inputs["images"][:, :31], 4, 4), config=cfg, progress=False,
        device="cpu", mesh=m))
    values["bad_views"] = _error(lambda: Interpolator(
        lf, config=RenderConfig(view_count=7), progress=False, device="cpu", mesh=m))
    os.environ["LFI_HBM_BYTES"] = "200000"
    try:
        values["capacity_fixed"] = _error(
            lambda: interp.interpolate("0,0,1,1", focus=0.1, progress=False))
        values["capacity_allfocus"] = _error(lambda: interp.interpolate(
            "0,0,1,1", focus=0.1, focus_range=0.2, progress=False))
    finally:
        del os.environ["LFI_HBM_BYTES"]

    # --focus-pyramid is ignored on a mesh: the exact sweep runs
    calls = []
    pyramid = focus_estimate.focus_estimate_pyramid
    focus_estimate.focus_estimate_pyramid = lambda *a, **k: calls.append(1) or pyramid(*a, **k)
    try:
        wide = Interpolator(LightField(inputs["wide"], 2, 2), config=RenderConfig(
            view_count=4, focus_map_views=4, focus_steps=8, focus_pyramid=True),
            progress=False, device="cpu", mesh=m)
        r = wide.interpolate("0,0,1,1", focus=0.0, focus_range=0.21, method="TEN",
                             progress=False)
    finally:
        focus_estimate.focus_estimate_pyramid = pyramid
    arrays["pyramid_views"], arrays["pyramid_maps"] = r.views, r.maps
    values["pyramid_calls"] = len(calls)
    return arrays, values


CASES = {"fixed": case_fixed, "allfocus": case_allfocus, "api": case_api}
