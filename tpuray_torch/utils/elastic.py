"""Elastic render-loop supervision: fault detection and checkpointed resume
(counterpart of tpuray/utils/elastic.py).

The whole inter-frame state is an explicit FrameState
(render/frame_state.py), so a restartable render loop is cheap: the
supervisor checkpoints every `checkpoint_every` frames, classifies the
exceptions of the frame function as device faults or programming errors,
and on a fault reloads the last checkpoint and replays the frames since.
A frame is a function of (scene, camera, state), so a replayed run is bit
for bit the uninterrupted one (tests/test_torch_elastic.py injects faults).

is_device_fault classifies PyTorch's errors (tpuray matches JAX's status
tokens instead):

  exception                                          | is_device_fault
  ---------------------------------------------------+-----------------
  torch.distributed DistBackendError,                | True (a rank or
    DistNetworkError, DistStoreError                 |  the store failed)
  RuntimeError / torch.AcceleratorError whose        | True
    message starts with "CUDA error:" (an illegal    |
    address, a launch failure, ECC, a lost device)   |
  ... unless the CUDA error is one that a replay     | False
    repeats: out of memory, invalid argument,        |
    invalid configuration argument, no kernel image, |
    invalid device function                          |
  RuntimeError naming an NCCL failure ("NCCL error", | True
    nccl{UnhandledCuda,System,Internal,Remote}Error, |
    an aborted communicator, a watchdog timeout)     |
  torch.cuda.OutOfMemoryError                        | False
  anything else (ValueError, TypeError, a kernel     | False: re-raised
    wrapper's "launch failed: cudaError_t", ...)     |  at once
  KeyboardInterrupt, SystemExit                      | False

A sticky CUDA error (an illegal address, for example) poisons the CUDA
context of the process, and no call inside the process clears it: every
replay then fails the same way, and the loop re-raises after
`max_restarts`. Only a restarted process resumes from the checkpoint, which
the loop keeps on disk for it (load_frame_state, then run_elastic again).

Multi-process runs (dist/multihost.py) layer on top: each process
supervises its own loop and restores from its own checkpoint; re-forming
the process group after a fault is the launcher's job, not this module's.
"""
from __future__ import annotations

import logging
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.distributed as dist

from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.utils.checkpoint import load_frame_state, save_frame_state

log = logging.getLogger("tpuray_torch.elastic")

_DIST_FAULTS = tuple(getattr(dist, name) for name in
                     ("DistBackendError", "DistNetworkError", "DistStoreError")
                     if hasattr(dist, name))
_CUDA_PREFIX = "CUDA error:"
# CUDA errors that a replay repeats: resources or a bad launch, not a fault
_CUDA_NOT_FAULTS = ("out of memory", "invalid argument",
                    "invalid configuration argument", "no kernel image",
                    "invalid device function")
_NCCL_RE = re.compile(
    r"\bNCCL error\b|\bnccl(UnhandledCuda|System|Internal|Remote)Error\b"
    r"|\bNCCL communicator was aborted\b|\bWatchdog caught collective operation timeout\b",
    re.IGNORECASE)


def is_device_fault(exc: BaseException) -> bool:
    """True for a device or runtime fault, worth a restore and replay;
    False for an error that a replay repeats (the module docstring's
    table)."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit, torch.cuda.OutOfMemoryError)):
        return False
    if _DIST_FAULTS and isinstance(exc, _DIST_FAULTS):
        return True
    if not isinstance(exc, RuntimeError):  # torch.AcceleratorError is one
        return False
    msg = str(exc).lstrip()
    if msg.startswith(_CUDA_PREFIX):
        what = msg[len(_CUDA_PREFIX):].lstrip().lower()
        return not what.startswith(_CUDA_NOT_FAULTS)
    return _NCCL_RE.search(msg) is not None


def _synchronize(state: FrameState) -> None:
    """Wait for the frame's device work: a fault surfaces here, inside
    the supervised call, not in a later frame."""
    dev = state.illum_hist.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class ElasticStats:
    frames_done: int = 0
    faults: int = 0
    restores: int = 0
    replayed_frames: int = 0
    checkpoints: int = 0
    fault_log: list = field(default_factory=list)


def run_elastic(frame_fn: Callable[[FrameState, int], FrameState],
                initial_state: FrameState,
                n_frames: int,
                checkpoint_path: str,
                checkpoint_every: int = 8,
                max_restarts: int = 3,
                on_restore: Callable[[], None] | None = None
                ) -> tuple[FrameState, ElasticStats]:
    """Drive `frame_fn(state, frame_index) -> state` for n_frames under
    fault supervision.

    A checkpoint is written when the loop starts (so a first-frame fault
    restores this run's state, never a stale file), every
    `checkpoint_every` frames and after the last. On a device fault: call
    `on_restore` (a hook to drop caches or re-create resources), reload the
    checkpoint onto the state's device and replay from its frame index.
    Raises after `max_restarts` consecutive faults, and at once for any
    other exception. Returns (final state, stats)."""
    stats = ElasticStats()
    state = initial_state
    device = initial_state.illum_hist.device
    frame = int(state.frame_idx)
    restarts_in_row = 0
    save_frame_state(checkpoint_path, state)
    stats.checkpoints += 1

    while frame < n_frames:
        try:
            state = frame_fn(state, frame)
            _synchronize(state)
            frame += 1
            stats.frames_done += 1
            restarts_in_row = 0
            if frame % checkpoint_every == 0 or frame == n_frames:
                save_frame_state(checkpoint_path, state)
                stats.checkpoints += 1
        except Exception as exc:  # noqa: BLE001 (classified below)
            if not is_device_fault(exc):
                raise
            stats.faults += 1
            stats.fault_log.append((frame, repr(exc)[:200], time.time()))
            restarts_in_row += 1
            log.warning("device fault at frame %d (%d/%d): %r",
                        frame, restarts_in_row, max_restarts, exc)
            if restarts_in_row > max_restarts:
                raise
            if on_restore is not None:
                on_restore()
            if os.path.exists(checkpoint_path):
                state = load_frame_state(checkpoint_path, device)
                stats.restores += 1
            else:
                state = initial_state
            resumed = int(state.frame_idx)
            stats.replayed_frames += max(0, frame - resumed)
            frame = resumed

    return state, stats
