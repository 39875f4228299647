"""K7: the one-hot hi/lo table gather (onehot_gather).

Counterpart of tpuray/kernels/gather_pallas.py. The CUDA kernel lives in
csrc/gather.cu (see its header for the design). Like the JAX kernel, which
nothing in tpuray calls, it is not wired into shading: its rounding would
change the image.

What it computes is not table[idx]: each value comes back as
f32(hi) + f32(lo) with hi = bf16(x) and lo = bf16(x - hi), the sum the TPU
kernel's two one-hot bf16 matmuls accumulate in f32 (~2^-17 relative to
x). Indices outside [0, T) return zero rows. The JAX kernel does that for
its zero padding rows [T, ceil512(T)) and for the negative indices that
its chunk slice wraps into them (-1, the miss sentinel, unless T is a
multiple of 512); other negative indices read row idx + ceil512(T) there,
and larger ones slice outside the table.

The wrapper
- raises if the table requires grad (forward only, as the pallas_call);
- runs the plain version when its tensors lie on the CPU;
- on CUDA tensors, checks device, dtype, shape and contiguity, allocates
  the output, launches the kernel on the current stream, raises if the
  launch failed, and adds one to LAUNCHES["k7"]. There is no fallback.
"""
from __future__ import annotations

import torch

from tpuray_torch.kernels import build

Tensor = torch.Tensor

# kernel launches since the last reset (the plain path never counts)
LAUNCHES = {"k7": 0}


def reset_launches() -> None:
    LAUNCHES["k7"] = 0


def onehot_gather_plain(table: Tensor, idx: Tensor) -> Tensor:
    """K7's function in plain PyTorch: the bf16 hi/lo split of table
    (T, W) f32 and its sum, gathered at idx (N,) integer; zero rows for
    indices outside [0, T)."""
    hi = table.to(torch.bfloat16).to(torch.float32)
    lo = (table - hi).to(torch.bfloat16).to(torch.float32)
    rows = hi + lo
    n_rows = table.shape[0]
    valid = (idx >= 0) & (idx < n_rows)
    out = rows[torch.clamp(idx.long(), 0, max(n_rows - 1, 0))]
    return torch.where(valid[:, None], out, 0.0)


def onehot_gather(table: Tensor, idx: Tensor) -> Tensor:
    """K7: table (T, W) f32 gathered at idx (N,) int32 through the exact
    bf16 hi/lo split -> (N, W) f32, zero rows outside [0, T)."""
    build.refuse_grad("onehot_gather (K7)",
                      "gather with table[idx] to differentiate", table)
    if table.device.type == "cpu":
        return onehot_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"onehot_gather: unsupported device {table.device}")
    dev = table.device
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"onehot_gather takes table (T, W) and idx (N,), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    n_rows, w = table.shape
    n = idx.shape[0]
    build.check(table, "table", torch.float32, (n_rows, w), dev)
    build.check(idx, "idx", torch.int32, (n,), dev)
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.load().tpuray_onehot_gather(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows, w, n,
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "onehot_gather (K7)")
    LAUNCHES["k7"] += 1
    return out
