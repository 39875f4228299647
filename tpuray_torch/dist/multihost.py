"""Multi-process start (counterpart of tpuray/dist/multihost.py).

The JAX package wires jax.distributed and one global Mesh over every
process's devices. The port runs one process per device under
torch.distributed: `initialize` joins the process group (NCCL for a CUDA
device, gloo for the CPU: the device asked for decides the backend), and
`global_mesh` is this process's view of it. Nothing in the render or train
step changes: dist/sharding.py, dist/frame.py and
train/optimize.py:make_sharded_train_step take the mesh.

Start N processes with torchrun (`torchrun --nproc-per-node N script.py`,
which sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK) or
with `python -m tpuray_torch.dist.dryrun N`, which sets the TPURAY_*
variables below.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from tpuray_torch.dist.sharding import BACKENDS, Mesh, make_mesh, pad_rows


def _env_int(*names: str) -> int | None:
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, local_rank: int | None = None,
               device="cuda", timeout_s: float = 600.0) -> bool:
    """Join the process group if a multi-process run is configured; True
    iff it runs on more than one process.

    Configuration, in order: the arguments; torchrun's variables
    (MASTER_ADDR and MASTER_PORT -> init_method "env://", WORLD_SIZE, RANK,
    LOCAL_RANK); the aliases of tpuray's names (TPURAY_COORDINATOR, a
    host:port or a URL such as file:///path/store, TPURAY_NUM_PROCESSES,
    TPURAY_PROCESS_ID, TPURAY_LOCAL_RANK). Without any of them the process
    runs alone and nothing is initialised. A CUDA process takes the card of
    its local rank; NCCL cannot put two ranks on one card, so a local rank
    past the card count raises."""
    env = os.environ
    if init_method is None:
        if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            init_method = "env://"
        elif env.get("TPURAY_COORDINATOR"):
            c = env["TPURAY_COORDINATOR"]
            init_method = c if "://" in c else f"tcp://{c}"
    if world_size is None:
        world_size = _env_int("WORLD_SIZE", "TPURAY_NUM_PROCESSES")
    if rank is None:
        rank = _env_int("RANK", "TPURAY_PROCESS_ID")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK", "TPURAY_LOCAL_RANK")
    if init_method is None and world_size is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError(f"initialize: incomplete configuration (init_method "
                         f"{init_method!r}, world_size {world_size}, rank {rank})")
    device = torch.device(device)
    backend = BACKENDS[device.type]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU (gloo)")
        local = rank if local_rank is None else local_rank
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"initialize: local rank {local} but "
                               f"{torch.cuda.device_count()} CUDA devices; NCCL "
                               "needs a card for each rank")
        torch.cuda.set_device(local)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def global_mesh() -> Mesh:
    """The mesh of every rank of the default group on this process's
    device: the card initialize() set for an NCCL group, the CPU for a gloo
    one; alone (no group), a world of one on the card."""
    if dist.is_initialized() and dist.get_backend() == BACKENDS["cpu"]:
        return make_mesh("cpu")
    return make_mesh("cuda")


def process_rows(height: int, world_size: int | None = None,
                 rank: int | None = None) -> tuple[int, int]:
    """This process's row span [lo, hi) of a frame padded to the world size
    (what it renders and writes locally); the process group's world size
    and rank unless given."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    rows = pad_rows(height, world_size) // world_size
    lo = rank * rows
    return min(lo, height), min(lo + rows, height)


def shutdown() -> None:
    """Leave the process group (no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
