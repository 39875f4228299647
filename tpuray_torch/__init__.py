"""tpuray_torch — the PyTorch + CUDA port of tpuray for one NVIDIA H100.

The package mirrors tpuray/'s layout and names module for module. It
imports torch and numpy only, never jax or tpuray: the JAX package stays
as the reference, and tests/test_torch_*.py hold each module against it on
the CPU. The kernels are hand-written CUDA in csrc/, built with nvcc at
first use: the BVH traversal (K1 trace_packets, K2 trace_multi, K3
trace_batched, K6 trace_chunked for chunked forests), the SVGF reproject +
variance pass (K4), the a-trous iteration (K5) and the one-hot hi/lo
gather (K7, which no path calls). On CPU tensors their wrappers run the
plain PyTorch versions.

The Renderer renders RenderConfig() as it is (SVGF + TAA, bounce
compaction with its budget buckets) of a moving camera on the card
(device="cuda" by default; pass device="cpu" to render on the CPU), on a
single BVH or a chunked forest, with textures and normal maps, with the
NEE integrator (fused or separate walks) or the MIS integrator. Scenes
load from OBJ, HDR and image files (scene.builder.build_scene, io/), and
`python -m tpuray_torch.cli.main render` renders one to PNG (with
`--elastic`, under the supervised loop of utils/elastic.py that restores
and replays after a device fault); see ROADMAP.md for what raises
NotImplementedError until later slices. A frame differentiates with
respect to materials and lights (render_frame, train.optimize; the
traversal is topology only), and train.optimize holds the recovery step.
dist/ splits a frame and a train step by image rows across processes
under torch.distributed (NCCL on the card, gloo on the CPU): render_tiled,
render_frame_sharded with halo exchanges, make_sharded_train_step, and
multihost / dryrun to start the ranks.
"""

__version__ = "0.1.0"

from tpuray_torch.scene.types import (  # noqa: F401
    BVHSoA, Camera, EnvMap, MaterialTable, PointLights, Scene, TextureStack,
    TriangleSoA, scene_from_numpy, scene_to_numpy,
)
from tpuray_torch.scene.config import DebugView, RenderConfig  # noqa: F401
from tpuray_torch.render.frame_state import FrameState  # noqa: F401
from tpuray_torch.render.renderer import Renderer, render_frame  # noqa: F401
