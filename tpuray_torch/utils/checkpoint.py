"""Checkpoints as flat npz files (counterpart of tpuray/utils/checkpoint.py).

save_frame_state / load_frame_state: the FrameState fields by name, so a
checkpoint of either package loads into the other. save_pytree /
load_pytree: the leaves of a nested structure (dicts, lists, tuples,
dataclasses such as MaterialTable; tensors or numpy arrays at the leaves)
in the JAX package's leaf order (dict keys sorted, dataclass fields in
declaration order), as leaf_0 ... leaf_{n-1} beside n: a params file of
either package loads into the other.
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


def tree_leaves(tree) -> list:
    """The tensors and arrays of `tree` in the JAX package's flatten order.
    Other values (ints, floats, None: a flax dataclass's static fields)
    hold no leaf."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    return []


def _unflatten(like, leaves):
    """`like` with its leaves replaced, in order, from the iterator `leaves`."""
    if isinstance(like, (torch.Tensor, np.ndarray)):
        return next(leaves)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(v, leaves) for v in like]
        if hasattr(like, "_fields"):  # a NamedTuple
            return type(like)(*items)
        return type(like)(items)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    return like


def save_pytree(path: str, tree) -> None:
    """Save the leaves of `tree` (tensors copied to the host)."""
    leaves = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in tree_leaves(tree)]
    np.savez(path, n=len(leaves), **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def load_pytree(path: str, like):
    """A tree shaped like `like` with the saved leaves: each a tensor on
    the device of the leaf it replaces, requiring grad where that one did.
    Raises ValueError when the file holds another number of leaves or a
    leaf of another shape."""
    like_leaves = tree_leaves(like)
    with np.load(path) as z:
        n = int(z["n"])
        if n != len(like_leaves):
            raise ValueError(f"{path} holds {n} leaves, the tree has {len(like_leaves)}")
        loaded = []
        for i, old in enumerate(like_leaves):
            arr = np.array(z[f"leaf_{i}"])
            if tuple(arr.shape) != tuple(old.shape):
                raise ValueError(f"leaf {i} has shape {arr.shape}, the tree's {tuple(old.shape)}")
            if isinstance(old, torch.Tensor):
                t = torch.from_numpy(arr).to(old.device)
                loaded.append(t.requires_grad_(True) if old.requires_grad else t)
            else:
                loaded.append(arr)
    return _unflatten(like, iter(loaded))
