# The benchmark's reference: a frozen copy of tpuray_torch/scene/config.py (its
# imports pointed here). The program may change; this copy does not.
"""Render configuration: a jax-free copy of tpuray/scene/config.py.

Same field names and defaults as the JAX package's RenderConfig (the GPU
machine has no jax, so the port cannot import it; tests hold the two
equal). Fields whose feature is not ported yet make the integrator or the
renderer raise NotImplementedError naming the ROADMAP.md item; none is
ignored silently. The comments below describe the JAX package's behaviour,
which the port follows where the feature is ported.
"""
from __future__ import annotations

import dataclasses
import enum


class DebugView(enum.IntEnum):
    """Intermediate buffers exposed for inspection (gui_config.h:7-17)."""

    PATH_TRACING_1SPP = 0
    SVGF_REPROJECTED = 1
    SVGF_VARIANCE = 2
    SVGF_ATROUS = 3
    SVGF_MODULATE = 4
    TAA = 5
    FINAL = 6
    ACCUMULATE_COLOR = 7


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # image
    width: int = 800
    height: int = 800

    # path tracing (gui_config.h:27-29)
    # "nee": the reference's active integrator (pdf-weighted env+point NEE,
    #        path_tracing.frag:948-968)
    # "mis": the reference's written-but-unused MIS integrator, made usable
    #        (path_tracing.frag:972-1052)
    integrator: str = "nee"
    max_tracing_depth: int = 2          # bounces per 1spp frame (slider 1-4)

    # Anisotropic Disney specular (GTR2_aniso + aniso Smith-GGX, the
    # reference's BRDF_Evaluate_aniso made live — path_tracing.frag:557-618):
    # "auto" resolves to True iff the material table has any
    # anisotropic > 0 row (resolved on concrete materials by the Renderer /
    # eager trace_paths; inside a jit trace "auto" degrades to False, so
    # direct render_frame callers with aniso scenes pass True). Isotropic
    # scenes keep the exact reference math and pay zero extra ops.
    enable_aniso: bool | str = "auto"
    clamp_threshold: float = 10.0       # radiance clamp
    accumulate: bool = True             # progressive accumulation
    use_normal_map: bool = False

    # SVGF (gui_config.h:21-26, 31)
    sigma_n: float = 128.0              # gPhiNormal
    sigma_l: float = 4.0                # gPhiColor
    reproj_depth_threshold: float = 10.0
    reproj_normal_threshold: float = 16.0
    num_atrous_iterations: int = 5      # step sizes 1<<i (main.cpp:499-504)
    history_cap: float = 32.0           # svgf_reproject.frag:185
    alpha_min: float = 0.2              # EMA floor, svgf_reproject.frag:187

    # feedback tap: which a-trous iteration feeds next frame's illum history
    # (the reference saves after iteration index 1, main.cpp:521-525)
    history_atrous_tap: int = 1

    # denoiser toggles
    enable_svgf: bool = True
    enable_taa: bool = True

    # denoise through the hand-written kernels: K4 (reproject + variance,
    # kernels/reproject.py) and K5 (the a-trous chain, kernels/atrous.py);
    # their wrappers run the plain versions on CPU tensors. False takes the
    # plain PyTorch stages on any device (the JAX package's jnp path).
    pallas_denoise: bool = True

    # moving-camera history-read strategy: "auto" and "exact" are the
    # per-pixel exact read (denoise/reproject.py), the one read of this
    # reference; the program's "tiled" read and fast_reproject=True are
    # refused here (__post_init__).
    reproject_gather: str = "auto"
    fast_reproject: bool = False

    # TPU throughput mode: draw the secondary-ray randoms (envmap sample,
    # light pick, BSDF-lobe/CPR rotation) once per 32x32 SCREEN tile instead
    # of per pixel, keyed on (tile_x, tile_y, frame) so it composes with
    # bounce-boundary compaction and image sharding. Keeps each packet's
    # shadow/bounce rays direction-coherent, which is what the packet
    # traversal kernel needs; per-pixel noise becomes per-tile noise (still
    # unbiased per pixel, refreshed per frame by the Sobol sequence).
    # Off = reference per-pixel semantics.
    tile_coherent_sampling: bool = False

    # Fused per-bounce secondary traversal (kernels/trace_pallas.trace_multi,
    # TPU single-tree scenes only): walk the bounce ray + envmap shadow +
    # point shadow — which share their origins — in ONE batched-K packet
    # traversal, paying the per-node scalar readback stall, the fixed
    # per-packet cost and the ray-operand DMA once for the union of the
    # three classes. Identical per-pixel radiance (shadow classes only
    # contribute their blocked/unblocked bit; the bounce class is
    # decision-equivalent to the separate walk).
    fused_secondary: bool = True

    # Bounce-boundary ray compaction (integrator/path_tracer.py): after the
    # primary trace, pack the surviving (hit) lanes densely into a buffer of
    # compact_frac * n rays and run the whole NEE + bounce loop at that
    # size — sky lanes stop paying for shading, gathers AND the incoherent
    # secondary traversals (dead packets at the compacted tail are skipped
    # by the packet kernel). Per-pixel output is identical up to XLA fusion
    # reassociation: every sample stream is keyed on (pixel, frame), not
    # lane position, so the math is the same, but the two programs fuse
    # differently and float reassociation can flip grazing shadow-
    # visibility tests at isolated pixels (tests/test_compaction uses
    # rtol=2e-4; exact-invariance users should set compact_frac=0 and
    # compact_auto=False). Frames where
    # more rays survive than the budget run a residual full-width pass for
    # the overflow lanes (lax.cond — only pays when it happens).
    # 0 disables.
    compact_frac: float = 0.5

    # Renderer-level auto-tuning of compact_frac: after each frame the
    # Renderer reads the frame's hit coverage (one scalar) and picks the
    # smallest budget bucket from {1/8, 1/4, 1/2} with ~30% headroom for
    # the NEXT frame (the reference clock scene covers only ~8% of the
    # 800x800 frame at the startup pose — a fixed 0.5 budget wastes most
    # of the compaction win). Each bucket is a separate XLA compilation
    # (cached); the residual pass keeps overflow frames exact while the
    # bucket catches up.
    compact_auto: bool = True

    # output
    tonemap_limit: float = 1.5          # output_pass.frag:13
    gamma: float = 2.2

    # the program's emulation of the original renderer's quirks: refused
    # here (__post_init__)
    reference_quirks: bool = False

    def __post_init__(self):
        """Refuse what no cell runs and this reference does not compute: a
        cell that needs one brings it, in files of its own."""
        if self.reproject_gather not in ("auto", "exact") or self.fast_reproject:
            raise NotImplementedError("the reference reads the history exactly: "
                                      f"reproject_gather={self.reproject_gather!r}, "
                                      f"fast_reproject={self.fast_reproject}")
        if self.reference_quirks:
            raise NotImplementedError("the reference has no reference_quirks")
        if self.integrator not in ("nee", "mis"):
            raise NotImplementedError("the reference integrates NEE and MIS only: "
                                      f"integrator={self.integrator!r}")
