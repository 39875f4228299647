"""Differentiable rendering: recover materials and lights from a target.

Counterpart of tpuray/train/optimize.py (split_trainable, render_flat,
make_train_step). The path tracer differentiates as the JAX package's
does: the traversal is topology only and resolve_hit detaches the hit
distance, so pixel gradients reach the MaterialTable and PointLights
tensors through the shading. The JAX params pytree becomes a dict of
MaterialTable / PointLights whose tensors are leaves with
requires_grad=True, and the optax optimizer a torch.optim one that updates
them in place.

The entry points run on the card unless asked otherwise: split_trainable
moves the scene to `device` ("cuda" by default) and raises without CUDA
unless given device="cpu", as the Renderer does. make_sharded_train_step
is the row-parallel step over torch.distributed (dist/sharding.py): each
rank renders its rows, and the gradients and the loss are all-reduced
before every rank takes the same optimizer step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from tpuray_torch.dist.sharding import shard_span, trace_rows
from tpuray_torch.integrator.path_tracer import KERNELS, Tracer, pack_traversal
from tpuray_torch.kernels.trace import TraceTables
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.types import Camera

Tensor = torch.Tensor


def _trainable(table):
    """A copy of a MaterialTable / PointLights whose tensors are fresh
    leaves that require grad."""
    return table.replace(**{
        f.name: getattr(table, f.name).detach().clone().requires_grad_(True)
        for f in dataclasses.fields(table)})


def parameters(params: dict) -> list[Tensor]:
    """The leaf tensors of a split_trainable params dict, for an optimizer."""
    return [getattr(table, f.name) for table in params.values()
            for f in dataclasses.fields(table)]


def split_trainable(scene, train_materials: bool = True,
                    train_lights: bool = True, device="cuda"):
    """-> (params, rebuild(params) -> Scene). The scene is moved to
    `device`; params holds "materials" and / or "lights" as copies whose
    tensors are leaves with requires_grad=True."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("split_trainable: no CUDA device is available; "
                           "pass device='cpu' to train on the CPU")
    scene = scene.to(device)
    params = {}
    if train_materials:
        params["materials"] = _trainable(scene.materials)
    if train_lights:
        params["lights"] = _trainable(scene.lights)

    def rebuild(p):
        s = scene
        if "materials" in p:
            s = s.replace(materials=p["materials"])
        if "lights" in p:
            s = s.replace(lights=p["lights"])
        return s

    return params, rebuild


def render_flat(scene, camera: Camera, cfg: RenderConfig, height: int,
                width: int, frame: int, tracer: Tracer = KERNELS,
                tables: TraceTables | None = None) -> Tensor:
    """(H, W, 3) 1-spp radiance of row-major primary rays (row 0 the top
    image row; px = x, py = H-1-y, the RNG keys: trace_rows over every
    row), differentiable with respect to the scene's materials and lights.
    tables: the scene's pack_traversal, built here when not given."""
    camera = camera.to(scene.triangles.p0.device)
    pt = trace_rows(scene, camera, cfg, height, width, 0, height, frame, tracer, tables)
    return pt.color.reshape(height, width, 3)


class TrainState(NamedTuple):
    params: Any     # split_trainable's dict, updated in place
    opt_state: Any  # the torch.optim.Optimizer over parameters(params)


def make_train_step(rebuild: Callable, cfg: RenderConfig, height: int,
                    width: int, optimizer: Callable | None = None,
                    tracer: Tracer = KERNELS):
    """Single-device train step -> (init, step):
    init(params) -> TrainState; step(state, target, camera, frame) ->
    (state, loss), one MSE backward and one optimizer step.

    optimizer: a factory list[Tensor] -> torch.optim.Optimizer; the default
    is Adam(lr=1e-2), which is optax.adam(1e-2) (b1 0.9, b2 0.999, eps 1e-8
    added outside the square root). The traversal tables are packed once,
    from the first scene: rebuild changes materials and lights only."""
    make_opt = optimizer or (lambda leaves: torch.optim.Adam(leaves, lr=1e-2))
    packed: list[TraceTables] = []

    def loss_fn(params, target, camera, frame) -> Tensor:
        scene = rebuild(params)
        if not packed:
            packed.append(pack_traversal(scene))
        img = render_flat(scene, camera, cfg, height, width, frame,
                          tracer=tracer, tables=packed[0])
        return torch.mean((img - target) ** 2)

    def step(state: TrainState, target: Tensor, camera: Camera, frame
             ) -> tuple[TrainState, Tensor]:
        state.opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, target, camera, frame)
        loss.backward()
        state.opt_state.step()
        return state, loss.detach()

    def init(params) -> TrainState:
        return TrainState(params, make_opt(parameters(params)))

    return init, step


def make_sharded_train_step(rebuild: Callable, cfg: RenderConfig, height: int,
                            width: int, mesh, optimizer: Callable | None = None,
                            tracer: Tracer = KERNELS):
    """Row-parallel train step over `mesh` (dist/sharding.py:make_mesh) ->
    (init, step), as make_train_step's:
    step(state, target_rows, camera, frame) -> (state, loss).

    Each rank renders its rows of the image from global pixel coordinates
    (render_tiled's rays) and takes the sum of its squared errors over
    H * W * 3, the global mean's share; target_rows is its (rows, W, 3)
    shard (shard_span). After the backward pass every parameter's gradient
    and the loss are all-reduced (SUM) in one flat buffer, so each rank
    holds the single-device gradient and takes the same optimizer step:
    the parameters stay identical on every rank. The loss returned is the
    global mean."""
    if height % mesh.size:
        raise ValueError(f"height {height} is not a multiple of {mesh.size} ranks")
    row0, rows = shard_span(height, mesh)
    make_opt = optimizer or (lambda leaves: torch.optim.Adam(leaves, lr=1e-2))
    packed: list[TraceTables] = []

    def loss_fn(params, target, camera, frame) -> Tensor:
        scene = rebuild(params)
        if not packed:
            packed.append(pack_traversal(scene))
        pt = trace_rows(scene, camera.to(mesh.device), cfg, height, width, row0, rows,
                        frame, tracer, tables=packed[0])
        img = pt.color.reshape(rows, width, 3)
        return torch.sum((img - target) ** 2) / (height * width * 3)

    def step(state: TrainState, target: Tensor, camera: Camera, frame
             ) -> tuple[TrainState, Tensor]:
        state.opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, target, camera, frame)
        loss.backward()
        leaves = parameters(state.params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        if mesh.distributed:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        i = 0
        for p, g in zip(leaves, grads):
            p.grad = flat[i:i + g.numel()].view_as(g)
            i += g.numel()
        state.opt_state.step()
        return state, flat[-1]

    def init(params) -> TrainState:
        return TrainState(params, make_opt(parameters(params)))

    return init, step
