"""FrameState checkpoints as a flat npz (counterpart of
tpuray/utils/checkpoint.py:save_frame_state and load_frame_state): the same
field names, so a checkpoint of either package loads into the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuray_torch.render.frame_state import FrameState

_FIELDS = [f.name for f in dataclasses.fields(FrameState)]


def save_frame_state(path: str, state: FrameState) -> None:
    """Every field as an array; frame_idx as an int32 scalar, as the JAX
    package's FrameState holds it."""
    arrays = {f: np.asarray(getattr(state, f).detach().cpu())
              for f in _FIELDS if f != "frame_idx"}
    np.savez(path, frame_idx=np.int32(state.frame_idx), **arrays)


def load_frame_state(path: str, device="cpu") -> FrameState:
    with np.load(path) as z:
        kw = {f: torch.from_numpy(np.array(z[f], np.float32)).to(device)
              for f in _FIELDS if f != "frame_idx"}
        return FrameState(frame_idx=int(z["frame_idx"]), **kw)
