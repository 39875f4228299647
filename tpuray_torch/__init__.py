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

The Renderer renders the default view (SVGF + TAA) of a moving camera on
the card (device="cuda" by default; pass device="cpu" to render on the
CPU), on a single BVH or a chunked forest, with the NEE integrator (fused
or separate walks) or the MIS integrator; see ROADMAP.md for what raises
NotImplementedError until later slices. A frame differentiates with
respect to materials and lights (render_frame, train.optimize; the
traversal is topology only), and train.optimize holds the recovery step.
"""

__version__ = "0.1.0"

from tpuray_torch.scene.types import (  # noqa: F401
    BVHSoA, Camera, EnvMap, MaterialTable, PointLights, Scene, TriangleSoA,
    scene_from_numpy, scene_to_numpy,
)
from tpuray_torch.scene.config import DebugView, RenderConfig  # noqa: F401
from tpuray_torch.render.frame_state import FrameState  # noqa: F401
from tpuray_torch.render.renderer import Renderer, render_frame  # noqa: F401
