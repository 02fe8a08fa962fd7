"""Multi-process initialization: one process per GPU.

Port of ``lfinterpolator_tpu/parallel/distributed.py``. JAX drives every
device of a host from one process; PyTorch runs one process per GPU, so a
mesh of ``nv x ns`` devices is ``nv x ns`` ranks of one process group.
Typical launch, one process per GPU on each host::

    torchrun --nproc-per-node 4 my_render.py

    from lfinterpolator_tpu_torch.parallel import distributed, mesh
    distributed.initialize()            # env:// from torchrun
    m = mesh.make_mesh()                # (view, space) over every rank
    interp = Interpolator(path, mesh=m)
    result = interp.interpolate("0,0,1,1", focus=0.1)   # on every rank

Every rank loads the same light field; ``Interpolator`` then broadcasts
rank 0's stack so that every rank holds the same bytes.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

#: Seconds a collective waits for the other ranks before it fails, so that
#: a rank that died cannot hang the others for the default 30 minutes.
TIMEOUT_S = 300.0


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout_s: float = TIMEOUT_S,
) -> None:
    """Initialize the default process group (no-op if already initialized).

    With no arguments, ``env://``: the variables ``torchrun`` sets
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). Otherwise
    `coordinator_address` is ``host:port`` (``tcp://`` is added) or a full
    init method such as ``file:///path``, with the world size
    `num_processes` and this process's rank `process_id`. `backend`
    defaults to ``nccl`` where a CUDA device is present and ``gloo``
    otherwise (several ranks sharing one GPU need an explicit ``gloo``:
    NCCL puts at most one rank on a GPU). Each rank's current CUDA device
    becomes ``LOCAL_RANK % device_count()`` (the rank where LOCAL_RANK is
    unset)."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK")
        rank = int(local) if local is not None else int(
            process_id if process_id is not None else os.environ.get("RANK", 0))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def is_multi_host() -> bool:
    """True when more than one process renders (the JAX package's test for
    a multi-process run)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_shard_info() -> dict:
    """Process/device topology summary for logging, under the JAX
    package's keys: this rank, the world size, the GPUs this process
    drives (one) and the GPUs of the mesh (one a rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }
