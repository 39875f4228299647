"""Ray-tile data parallelism over torch.distributed (counterpart of
tpuray/dist/sharding.py).

The image is split by rows across the ranks of a process group, one
process per device (NCCL on the card, gloo on the CPU), and the scene is
replicated. The JAX package's single-controller Mesh becomes `Mesh`, this
process's view of the group: its rank, the world size and its device. The
only cross-rank traffic of a traced frame is the all-gather a caller makes
to assemble the full image (gather_rows), and the all-reduce of parameter
gradients in training (train/optimize.py:make_sharded_train_step).

Every per-ray computation keys its RNG off global pixel coordinates, so a
sharded render equals the single-device one, whatever the world size.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tpuray_torch.integrator.gather_tables import PackedScene
from tpuray_torch.integrator.path_tracer import KERNELS, PTOutput, Tracer, trace_paths
from tpuray_torch.kernels.trace import TraceTables
from tpuray_torch.render.tiling import pixel_rays
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.types import Camera

Tensor = torch.Tensor

# the backend each device type takes: the device decides, never what the
# machine happens to offer
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the row-sharded group: `group` is None when no
    process group is initialised (a world of one process)."""

    rank: int
    size: int
    device: torch.device
    group: object = None
    distributed: bool = False  # a process group carries the collectives

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this group's `rank` (P2P peers)."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device with its index; "cuda" raises without a
    CUDA card (pass device="cpu" to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def make_mesh(device="cuda", group=None) -> Mesh:
    """The mesh of this process: every rank of `group` (the default group
    when None) over the rows, or a world of one when no process group is
    initialised. The group's backend must be the device's (NCCL for
    "cuda", gloo for "cpu")."""
    device = resolve_device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("make_mesh: a group was given but torch.distributed "
                             "is not initialised")
        return Mesh(rank=0, size=1, device=device)
    backend = dist.get_backend(group)
    if backend != BACKENDS[device.type]:
        raise ValueError(f"make_mesh: a {device.type} mesh needs the "
                         f"{BACKENDS[device.type]} backend, the group has {backend}")
    return Mesh(rank=dist.get_rank(group), size=dist.get_world_size(group),
                device=device, group=group, distributed=True)


def pad_rows(height: int, n: int) -> int:
    return (height + n - 1) // n * n


def shard_span(height: int, mesh: Mesh) -> tuple[int, int]:
    """(row0, rows) of this rank's rows of the image padded to the world
    size (row 0 is the top image row)."""
    rows = pad_rows(height, mesh.size) // mesh.size
    return mesh.rank * rows, rows


def shard_rays(camera: Camera, height: int, width: int, row0: int, rows: int
               ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The primary rays of rows row0 .. row0 + rows, row-major with global
    pixel coordinates -> (orig, d, px, py) as tiling.pixel_rays gives
    them: the directions and RNG keys of the single-device render. Rows
    past the image (padding) repeat the last one."""
    dev = camera.eye.device
    yy, xx = torch.meshgrid(
        torch.clamp_max(torch.arange(row0, row0 + rows, device=dev, dtype=torch.int32),
                        height - 1),
        torch.arange(width, device=dev, dtype=torch.int32), indexing="ij")
    return pixel_rays(camera, height, width, xx.reshape(-1), yy.reshape(-1))


def trace_rows(scene, camera: Camera, cfg: RenderConfig, height: int, width: int,
               row0: int, rows: int, frame: int, tracer: Tracer = KERNELS,
               tables: TraceTables | None = None, pk: PackedScene | None = None,
               rays=shard_rays) -> PTOutput:
    """Path-trace rows row0 .. row0 + rows of a frame (rays: shard_rays)
    -> trace_paths' PTOutput, its lanes row-major: x.reshape(rows, W, ...)
    is the rows' image."""
    orig, d, px, py = rays(camera, height, width, row0, rows)
    return trace_paths(scene, orig, d, px, py, int(frame), cfg, common_origin=True,
                       tracer=tracer, tables=tables, pk=pk)


def render_tiled(scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                 height: int, width: int, frame: int = 0,
                 tracer: Tracer = KERNELS, tables: TraceTables | None = None,
                 pk: PackedScene | None = None
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """Path-trace this rank's rows of a frame (trace_rows) -> (color,
    emission, albedo), each (rows, W, 3) of the image padded to the world
    size (shard_span; gather_rows assembles the full image), on the mesh's
    device (the scene is moved there; pass tables and pk packed from it to
    pack them once)."""
    row0, rows = shard_span(height, mesh)
    pt = trace_rows(scene.to(mesh.device), camera.to(mesh.device), cfg, height, width,
                    row0, rows, frame, tracer, tables, pk)
    return tuple(x.reshape(rows, width, 3) for x in (pt.color, pt.emission, pt.albedo))


def gather_rows(mesh: Mesh, x: Tensor, height: int | None = None) -> Tensor:
    """All-gather every rank's row shard (equal shapes) into the full image
    on every rank, cropped to `height` rows (the padding dropped)."""
    if mesh.distributed:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        x = torch.cat(parts, dim=0)
    return x if height is None else x[:height]
