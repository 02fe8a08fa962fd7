"""Multi-GPU rendering over a (view x space) mesh of ``torch.distributed``
ranks.

Port of ``lfinterpolator_tpu/parallel/mesh.py``. The problem is pixel- and
view-parallel, so the mesh is 2-D:

  * "view": the [V, G] weight matrix (and the output's view dimension) is
    split into ``nv`` blocks of rows, like a tensor-parallel layer;
  * "space": the output rows are split into ``ns`` blocks; a rank renders
    only its block, by launching the kernels on its rows
    (``row_start``/``row_count``), which clamp against the full frame.

JAX runs one program over every device (``shard_map``); PyTorch runs one
process per GPU, so a mesh of ``nv x ns`` devices is ``nv x ns`` ranks,
rank ``iv * ns + is`` at coordinate ``(iv, is)``. Each rank holds the full,
replicated image stack (``replicate``: rank 0's bytes, broadcast) and
renders views ``[iv * V/nv, (iv + 1) * V/nv)`` and rows
``[is * H/ns, (is + 1) * H/ns)``. A fixed-focus shard needs no
communication. An all-in-focus shard estimates its rows of the focus map,
all-gathers the raw map over its "space" group -- the box filter's halo
crosses the row blocks, and it is the only collective of the hot loop --
then filters and blends its rows. ``gather_views`` and ``gather_rows``
bring the results to every rank, as the JAX package's ``_fetch``
(``process_allgather``) does.

A shard that does not fit its GPU raises ``ValueError`` with the per-rank
arithmetic (``fixed_shard_bytes``, ``allfocus_shard_bytes``) and
``capacity.MESH_HINT`` before anything is allocated; there is no
view-batched or row-blocked arm on a mesh, as in the JAX package.

Not ported: ``_shard_slab`` and ``_est_slab_dims``, the TPU's per-shard slab
operands (edge-padded row windows with their alignment): the kernels read
the replicated stack with clamped indices, so a shard needs no slab.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import pipeline
from ..ops import blend_torch, focus_estimate, focus_torch
from ..ops.estimate_geometry import FocusTables
from ..utils import profiling

AXES = ("view", "space")

def make_mesh(view_parallel: int | None = None) -> DeviceMesh:
    """A (view, space) mesh over every rank of the default process group
    (``distributed.initialize`` first). By default the views split 2 ways
    when the world is even, the rows take the rest (views come in 64s,
    rows in thousands). The mesh's device type is "cuda" under NCCL and
    "cpu" under gloo (several ranks sharing one GPU); where a render runs
    is the Interpolator's device."""
    n = dist.get_world_size()
    if view_parallel is None:
        view_parallel = 2 if n % 2 == 0 and n > 1 else 1
    if view_parallel < 1 or n % view_parallel != 0:
        raise ValueError(f"{n} devices not divisible by view_parallel={view_parallel}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(view_parallel, n // view_parallel)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along `axis` ("view" or "space")."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _coordinate(mesh: DeviceMesh) -> tuple[int, int]:
    iv, is_ = mesh.get_coordinate()
    return int(iv), int(is_)


def rows_of(mesh: DeviceMesh, h: int) -> tuple[int, int]:
    """-> (r0, hb): this rank's block of the `h` rows. Raises ValueError
    unless the space axis divides `h`."""
    ns = axis_size(mesh, "space")
    if h % ns != 0:
        raise ValueError(f"H={h} must divide by the space axis ({ns})")
    hb = h // ns
    return _coordinate(mesh)[1] * hb, hb


def replicate(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """`x` as rank 0 holds it, on every rank (an in-place broadcast over the
    mesh's ranks, all of the default group); -> `x`."""
    if not x.is_contiguous():
        raise ValueError("replicate needs a contiguous tensor")
    dist.broadcast(x, src=0)
    return x


def shard_weights(mesh: DeviceMesh, weights):
    """This rank's rows of a [V, G] weight matrix (tensor or array): block
    ``iv`` of the view axis's ``nv``."""
    nv = axis_size(mesh, "view")
    v = weights.shape[0]
    if v % nv != 0:
        raise ValueError(f"V={v} must divide by the view axis ({nv})")
    vl = v // nv
    iv = _coordinate(mesh)[0]
    return weights[iv * vl:(iv + 1) * vl]


def shard_inputs(mesh: DeviceMesh, images: torch.Tensor, weights: torch.Tensor):
    """-> (the replicated stack, this rank's weight rows)."""
    return replicate(mesh, images), shard_weights(mesh, weights)


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """`x` of every rank of `group`, in group-rank order (the list form of
    ``dist.all_gather``: ``all_gather_into_tensor`` is deprecated in newer
    PyTorch, and the card's version is not fixed). NCCL and gloo both take
    CUDA tensors as they are (gloo stages them through the host itself)."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


def gather_rows(mesh: DeviceMesh, block: torch.Tensor) -> torch.Tensor:
    """[..., hb, W] blocks of every rank of this rank's "space" group ->
    the full [..., H, W] on each (the raw focus map's gather inside a
    render, the maps' after it: every view rank holds the same maps)."""
    parts = _all_gather(block, mesh.get_group("space"))
    return torch.cat(parts, dim=-2)


def render_fixed_sharded(
    mesh: DeviceMesh,
    images: torch.Tensor,  # [G, C, H, W] uint8, replicated
    weights_l: torch.Tensor,  # [V/nv, G] float32, this rank's rows
    shifts: torch.Tensor,  # [G, 2] int32 (dx, dy)
    method: str = "TEN",
) -> torch.Tensor:
    """Fixed-focus render of this rank's views and rows -> [V/nv, C, H/ns,
    W] uint8: STD on the plain row-block ops, TEN on the ``shift_blend``
    kernel. The counterpart of both ``render_fixed_sharded`` (XLA, the JAX
    STD route) and ``render_fixed_sharded_pallas`` (``mesh.py:71-149``).
    Raises ValueError unless the space axis divides H."""
    r0, hb = rows_of(mesh, images.shape[2])
    return pipeline.render_fixed_focus(images, weights_l, shifts, method=method,
                                       row_start=r0, row_count=hb)


def render_all_focus_sharded(
    mesh: DeviceMesh,
    images: torch.Tensor,  # [G, C, H, W] uint8, replicated
    weights_l: torch.Tensor,  # [V/nv, G] float32, this rank's rows
    offsets: torch.Tensor,  # [G, 2] float32 (x, y)
    focus_ids: torch.Tensor,  # [K] int64
    tables: FocusTables,
    *,
    method: str = "STD",
    radius: tuple[int, int],
    filter_radius: tuple[int, int],
    exact_taps: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-in-focus render of this rank's views and rows
    (``mesh.py:341-467``): the estimate of its rows (exact or fast taps),
    the all-gather of the raw map over the "space" group, the filter of its
    rows, and the per-pixel-focus blend of its rows and views (STD with the
    filtered map, TEN with the raw one, as ``pipeline.blend_all_focus``).

    Returns (views [V/nv, C, H/ns, W], maps [2, H/ns, W]: raw, filtered)."""
    r0, hb = rows_of(mesh, images.shape[2])
    map0_l = pipeline.estimate_focus(images, offsets, focus_ids, tables,
                                     radius=radius, exact_taps=exact_taps,
                                     row_start=r0, row_count=hb)
    map0 = gather_rows(mesh, map0_l)
    map1_l = focus_torch.filter_focus_map_block(map0, filter_radius, r0, hb)
    del map0
    maps_l = torch.stack([map0_l, map1_l])
    views_l = pipeline.blend_all_focus(images, weights_l, offsets, maps_l,
                                       tables.decode, method=method,
                                       row_start=r0, row_count=hb)
    return views_l, maps_l


def gather_views_device(mesh: DeviceMesh, views_l: torch.Tensor) -> torch.Tensor:
    """Every rank's [V/nv, C, H/ns, W] block -> the full [V, C, H, W] on
    every rank: an all-gather over the world into a list of blocks (V*C*H*W
    bytes), each copied into its place in one new tensor (as many again)."""
    nv, ns = axis_size(mesh, "view"), axis_size(mesh, "space")
    vl, c, hb, w = views_l.shape
    blocks = _all_gather(views_l, None)
    out = torch.empty((nv * vl, c, ns * hb, w), dtype=views_l.dtype,
                      device=views_l.device)
    for rank, block in enumerate(blocks):
        iv, is_ = divmod(rank, ns)
        out[iv * vl:(iv + 1) * vl, :, is_ * hb:(is_ + 1) * hb] = block
    return out


def gather_views(mesh: DeviceMesh, views_l: torch.Tensor) -> np.ndarray:
    """Every rank's block -> host [V, H, W, C] uint8 on every rank."""
    return blend_torch.from_planar(gather_views_device(mesh, views_l)).cpu().numpy()


def sync(device) -> None:
    """Wait for this rank's device work, then for every rank (a barrier)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(step, *, runs: int, device) -> profiling.BenchResult:
    """Host-clock times of `runs` calls of `step` across the ranks: each
    starts after every rank's earlier work and ends when every rank's
    device has finished (``sync``), the counterpart of the JAX package's
    ``_tiny_sync`` (``api.py:43-62``)."""
    times = []
    for _ in range(runs):
        sync(device)
        t0 = time.perf_counter()
        step()
        sync(device)
        times.append(time.perf_counter() - t0)
    return profiling.BenchResult(times_s=times, device=profiling.device_name(device))


def fixed_shard_bytes(
    n_view: int, n_space: int, g: int, c: int, h: int, w: int, v: int, *,
    method: str,
) -> dict[str, int]:
    """Per-rank device bytes of a mesh fixed-focus render
    (``mesh.py:312-338``, for what the port allocates). Keys: "stack" (the
    replicated [G, C, H, W] stack), "render" (stack + the shard's output,
    and for STD the plain ops' temporaries, ``blend_torch.temp_bytes``),
    "gather" (stack + the shard's output + the views' all-gather: the list
    of every rank's block and the assembled [V, C, H, W], V*C*H*W each;
    the assembled views then beside their [V, H, W, C] copy for the
    download, as much), and "peak", their max. Feed "peak" to
    ``capacity.check_capacity`` with ``capacity.MESH_HINT``."""
    if h % n_space != 0 or v % n_view != 0:
        raise ValueError(
            f"H={h} / V={v} must divide by the mesh axes ({n_space}, {n_view})")
    hb, vl = h // n_space, v // n_view
    stack = g * c * h * w
    out_l = vl * c * hb * w
    temp = blend_torch.temp_bytes(g, vl, c, hb, w) if method == "STD" else 0
    render = stack + out_l + temp
    gather = stack + out_l + 2 * v * c * h * w
    return {"stack": stack, "render": render, "gather": gather,
            "peak": max(render, gather)}


def allfocus_shard_bytes(
    n_view: int, n_space: int, g: int, k: int, c: int, h: int, w: int, v: int, *,
    radius: tuple[int, int],
    filter_radius: tuple[int, int],
    steps: int,
) -> dict[str, int]:
    """Per-rank device bytes of a mesh all-in-focus render
    (``mesh.py:229-309``, for what the port allocates; the TPU's slabs,
    pads and (8, 128) alignment are not the port's and are not counted).
    Keys, each with the replicated stack:

      "estimate": the K focus views gathered [K, C, H, W] and their RGBx
                  words (4*K*H*W; the full height: the kernels read every
                  row a block's taps reach), the map pass's maps of one
                  chunk of candidates on the block's extended rows and the
                  running best (``focus_estimate.map_chunk``), the clean
                  flags (the frame's and the block's rows) and their
                  temporaries (at most four f32 copies of one chunk of
                  ``focus_torch._FLAG_ELEMENTS`` elements), the block's map;
      "filter":   the raw map's all-gather (the list of blocks and the
                  full [H, W] map), the box filter's int64 window and
                  integral image (48 bytes a pixel of the block's window);
      "blend":    the block's maps [2, hb, W] and views [V/nv, C, hb, W];
      "gather":   those, the views' all-gather (the list of blocks and the
                  assembled [V, C, H, W], V*C*H*W each, then the assembled
                  views beside their copy for the download) and the maps'
                  (2 * 2 * H * W);
      "peak":     the max.

    Feed "peak" to ``capacity.check_capacity`` with ``capacity.MESH_HINT``."""
    if h % n_space != 0 or v % n_view != 0:
        raise ValueError(
            f"H={h} / V={v} must divide by the mesh axes ({n_space}, {n_view})")
    hb, vl = h // n_space, v // n_view
    rx, ry = int(radius[0]), int(radius[1])
    frx, fry = int(filter_radius[0]), int(filter_radius[1])
    stack = g * c * h * w
    chunk = focus_estimate.map_chunk(hb, w, radius, steps)
    scratch = chunk * (hb + 2 * ry) * (w + 2 * rx) + (4 * hb * w if chunk < steps else 0)
    flags = steps * (h + w) + steps * (hb + w) + 16 * focus_torch._FLAG_ELEMENTS
    estimate = stack + k * c * h * w + 4 * k * h * w + scratch + flags + hb * w
    filt = stack + hb * w + 2 * h * w + 48 * (hb + 2 * fry + 1) * (w + 2 * frx + 1)
    maps_l, out_l = 2 * hb * w, vl * c * hb * w
    blend = stack + maps_l + out_l
    gather = blend + 2 * v * c * h * w + 2 * 2 * h * w
    return {"stack": stack, "estimate": estimate, "filter": filt, "blend": blend,
            "gather": gather, "peak": max(estimate, filt, blend, gather)}
