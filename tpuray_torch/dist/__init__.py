"""Distribution over torch.distributed (counterpart of tpuray/dist/)."""
from tpuray_torch.dist.sharding import make_mesh, render_tiled
from tpuray_torch.dist.frame import render_frame_sharded, shard_state

__all__ = ["make_mesh", "render_tiled", "render_frame_sharded", "shard_state"]
