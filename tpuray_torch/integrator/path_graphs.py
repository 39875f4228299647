"""The path tracer's frame work replayed as CUDA graphs.

Renderer.step on the card hands a frame's primary rays and path tracing to
PathGraphs when `engages` holds: a CUDA device, the KERNELS tracer (the
PLAIN tracer's wavefront reads the host), the NEE integrator (MIS has no
graphs) and grad off (the train step records autograd's graph). Every
other caller runs trace_paths eagerly: the train step, the sharded frame
(dist/frame.py), render_frame called directly, the CPU.

PathGraphs runs path_tracer.nee_paths, the sequence trace_paths runs, with
its own part runner: each part ("U"; or "A", then the host's read of the
hit count, then "B" or "B'") is captured as a CUDA graph and replayed. The
graphs are kept for one key at a time: H, W and the config's fields that
the parts read (path_tracer.path_key; the Renderer's compaction bucket is
one of them, its denoiser settings are not). A key's first frame runs the
parts uncaptured, so that a key that changes every frame (a slider held
down) costs what the eager frame costs; its later frames capture each part
the first time it runs (B' the first time a frame overflows) and replay
it from then on. While a torch.profiler session records, a part not yet
captured runs uncaptured.

The graphs read the frame's scalars from one device block: pixel_seed's
term, the Sobol point of each bounce (rng.FrameKeys) and the camera. Before
each frame they are written into one of two pinned host blocks, which
alternate so that a block is never rewritten while its copy may be pending,
and copied with one non-blocking copy on the stream. The parts are
nee_paths' own functions, so every output is bit-equal to the eager
frame's.

Memory: a PathGraphs' graphs share one private pool. Held between frames
are what A hands to B (t0, idx0, the selection) and one set of final
outputs, which B and B' both write; B recomputes the camera rays rather
than hold them. The outputs are overwritten by the next replay, so nothing
that outlives the frame may alias them (render/tiling.py:untile copies).
A key change frees the old key's outputs at once and keeps its graphs
until the new key's first capture holds the pool: the new key then reuses
the old key's memory, and none of the pool goes back to the device.

A graph is captured and destroyed only under one lock (_CAPTURE), so no
graph of any PathGraphs is destroyed while another thread captures. Graphs
that outlive their PathGraphs (a Renderer dropped on another thread) wait
in _RETIRED for the next PathGraphs frame or close() to destroy them.

Counters (utils/metrics.count): frame_idx, and through nee_paths lanes,
shaded_lanes and residual, with the eager path's values; pt_graph (1 when
every part of the frame was a replay of a graph captured before it) and
pt_graph_captures. kernels.launches() counts replays: a graph's launches
are tallied as it is captured and added at each later replay.
"""
from __future__ import annotations

import gc
import threading
import weakref
from typing import Callable

import numpy as np
import torch

from tpuray_torch import kernels
from tpuray_torch.integrator import path_tracer as pt
from tpuray_torch.render.tiling import camera_rays, padded_size
from tpuray_torch.sampling import rng
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.types import Camera
from tpuray_torch.utils.metrics import count, span

_CAMERA = (("eye", (3,)), ("cam_to_world", (3, 3)), ("view_proj", (4, 4)),
           ("tan_half_fov", ()))


def engages(device, tracer: pt.Tracer, cfg: RenderConfig) -> bool:
    """Whether a Renderer frame replays the path tracer's graphs."""
    return (torch.device(device).type == "cuda" and tracer is pt.KERNELS
            and cfg.integrator == "nee" and not torch.is_grad_enabled())


class FrameBlock:
    """A frame's scalars as the graphs read them: pixel_seed's term (int64),
    the Sobol points ((depth, 2) float32) and the camera's fields (float32),
    in one device block (`keys`, `camera`) written by stage(). Off the card
    (the CPU tests) the host blocks are not pinned and the copy waits."""

    def __init__(self, depth: int, device):
        device = torch.device(device)
        self._pinned = device.type == "cuda"
        n32 = 2 * depth + sum(int(np.prod(s)) for _, s in _CAMERA)
        nbytes = 8 + 4 * n32
        self._host = [torch.zeros(nbytes, dtype=torch.uint8, pin_memory=self._pinned)
                      for _ in range(2)]
        self._views = [(h.numpy()[:8].view(np.int64), h.numpy()[8:].view(np.float32))
                       for h in self._host]
        self._copied: list = [None, None]  # the event after each block's last copy
        self._turn = 0
        self.depth = depth
        self.block = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        f32 = self.block[8:].view(torch.float32)
        self.keys = rng.FrameKeys(seed_term=self.block[:8].view(torch.int64)[0],
                                  sobol=f32[:2 * depth].view(depth, 2))
        self._cam = f32[2 * depth:]
        fields, o = {}, 0
        for name, shape in _CAMERA:
            size = int(np.prod(shape))
            fields[name] = self._cam[o:o + size].view(shape)
            o += size
        self.camera = Camera(**fields)

    def stage(self, frame: int, camera: Camera) -> None:
        """Write frame `frame`'s scalars and copy them to the device block,
        behind the work queued so far."""
        k = self._turn
        self._turn ^= 1
        if self._copied[k] is not None:
            self._copied[k].synchronize()  # that block's last copy has landed
        i64, f32 = self._views[k]
        i64[0] = rng.seed_term(frame)
        o = 2 * self.depth
        f32[:o] = rng.sobol_points(frame, self.depth).reshape(-1)
        fields = [getattr(camera, name) for name, _ in _CAMERA]
        on_host = all(t.device.type == "cpu" for t in fields)
        if on_host:
            for t in fields:
                a = t.detach().numpy().reshape(-1)
                f32[o:o + a.size] = a
                o += a.size
        self.block.copy_(self._host[k], non_blocking=self._pinned)
        if self._pinned:
            self._copied[k] = torch.cuda.Event()
            self._copied[k].record()
        if not on_host:
            self._cam.copy_(torch.cat([t.detach().reshape(-1).to(torch.float32)
                                       for t in fields]))


# held across every capture and every destruction of a graph, so that no
# graph is destroyed while any thread captures
_CAPTURE = threading.RLock()
# parts of PathGraphs that were dropped: destroyed at the next safe point
_RETIRED: list = []


class GraphPart:
    """One captured part of a frame: fn's work as a CUDA graph in `pool`
    (new_pool()), with fn's outputs (`out`), which each replay() writes
    again."""

    @staticmethod
    def new_pool(device):
        """A private memory pool and the stream that captures into it."""
        return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)

    def __init__(self, fn: Callable, pool):
        handle, stream = pool
        self.graph = torch.cuda.CUDAGraph()
        self.tally: dict[str, int] = {}
        # no collection inside the capture: no destructor of collected
        # garbage makes a CUDA call on the capturing thread
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _CAPTURE, torch.cuda.stream(stream):
                self.graph.capture_begin(handle, capture_error_mode="thread_local")
                try:
                    self.out = fn()
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()

    def reset(self) -> None:
        """Destroy the graph (under _CAPTURE, never inside a capture)."""
        self.graph.reset()


def _reset(parts: list, keep=()) -> None:
    """Destroy the parts' graphs, but those in `keep`, and take them off
    the list: under _CAPTURE, so that no thread captures meanwhile."""
    with _CAPTURE:
        for p in [p for p in parts if not any(p is k for k in keep)]:
            p.reset()
            parts.remove(p)


def _retire(parts: list) -> None:
    """A PathGraphs' parts as it goes: outputs freed, graphs to _RETIRED."""
    for p in parts:
        p.out = None
    _RETIRED.extend(parts)
    parts.clear()


class PathGraphs:
    """The path tracer of a Renderer's frames as replayed graphs (module
    docstring). Call it in place of camera_rays + trace_paths."""

    def __init__(self, scene, tables, pk, device, tracer: pt.Tracer = pt.KERNELS):
        self.scene, self.tables, self.pk, self.tracer = scene, tables, pk, tracer
        self.device = torch.device(device)
        self._key = None
        self._block: FrameBlock | None = None
        self.parts: dict[str, GraphPart] = {}  # the key's captured parts
        self._live: list = []  # every part whose graph is not destroyed yet
        self._pool = None
        weakref.finalize(self, _retire, self._live)

    def close(self) -> None:
        """Destroy every graph now; the next frame starts afresh."""
        for p in self._live:
            p.out = None
        _reset(self._live)
        self.parts, self._key, self._block, self._pool = {}, None, None, None

    def __call__(self, camera: Camera, frame: int, cfg: RenderConfig,
                 height: int, width: int) -> pt.PTOutput:
        _reset(_RETIRED)
        key = (pt.path_key(cfg), height, width)
        first = key != self._key
        if first:
            # the old key's outputs go now; its graphs keep the pool until
            # this key's first capture holds it (_run)
            for p in self.parts.values():
                p.out = None
            self.parts = {}
            self._key = key
            if self._block is None or self._block.depth != cfg.max_tracing_depth:
                self._block = FrameBlock(cfg.max_tracing_depth, self.device)
        block = self._block
        with span("tpuray.trace_paths"):
            block.stage(frame, camera)
            count("frame_idx", int(frame))
            self._captures, self._fresh = 0, 0
            out = pt.nee_paths(
                self.pk, self.tables, self.tracer, cfg,
                lambda: camera_rays(block.camera, height, width),
                padded_size(height) * padded_size(width), block.keys,
                pt.resolve_aniso(self.scene, cfg), common_origin=True,
                run=lambda name, fn: self._run(name, fn, first))
            count("pt_graph", int(self._fresh == 0))
            count("pt_graph_captures", self._captures)
            return out

    def _run(self, name, fn: Callable, first: bool):
        """Part `name` (nee_paths'): fn run uncaptured on the key's first
        frame, as trace_paths runs it; later a replay when it is captured,
        else fn captured and replayed, or run uncaptured under a profiler.
        Its launches are counted once either way."""
        if first:
            self._fresh += 1
            return fn()
        name = name() if callable(name) else name
        part = self.parts.get(name)
        if part is not None:
            kernels.add_launches(part.tally)
            part.replay()
            return part.out
        self._fresh += 1
        if torch.autograd._profiler_enabled():
            return fn()
        other = self.parts.get({"B": "B'", "B'": "B"}.get(name))
        if other is not None:
            fn = _into(fn, other.out)  # B and B' hold one set of outputs
        if self._pool is None:
            self._pool = GraphPart.new_pool(self.device)
        before = kernels.launches()
        part = GraphPart(fn, self._pool)
        part.tally = {k: v - before[k] for k, v in kernels.launches().items()}
        self._live.append(part)
        self.parts[name] = part
        self._captures += 1
        _reset(self._live, keep=list(self.parts.values()))  # earlier keys' graphs
        part.replay()
        return part.out


def _into(fn: Callable, out: pt.PTOutput) -> Callable:
    """fn, writing its outputs into `out` and returning it."""
    def run() -> pt.PTOutput:
        for dst, src in zip(out, fn()):
            if dst is not src:
                dst.copy_(src)
        return out
    return run
