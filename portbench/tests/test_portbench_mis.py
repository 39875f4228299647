"""The reference's MIS integrator (reference/mis.py) against the program's
(tpuray_torch/integrator/mis.py, through path_tracer.trace_paths), on the
CPU at 32x32: the same camera rays handed to both, each side with its own
scene built from the same inputs (scenes.py), one frame on a single tree
(the test scene: K1's and K3's plain versions) and one on a chunked forest
(a small sphere forest in chunks of 256 triangles: K6's plain version for
every walk), at depth 1 and 2. The textured file scene runs in
test_portbench_run.py's MIS cases. Every material is made emissive on
both sides, so that the BSDF arm's emission term adds to every
continuation ray that hits.

Tolerances, those of tests/test_torch_mis.py:test_trace_paths_mis_matches:
- color within rtol 2e-4 / atol 2e-5 on all but 1% of the rays: the two
  walks find the same nearest triangle but may break a tie or a grazing
  shadow test differently at isolated rays (the program walks a BVH, the
  reference every leaf its boxes admit, in another triangle order);
- first-hit validity exact: a primary ray hits or misses on both sides;
- albedo within rtol 1e-5 / atol 1e-7, and so the first hit's point,
  normal (where the ray hit) and emission, which come from the same hit
  distance and the same triangle through the same expressions: last-bit
  differences only.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import scenes, spec
from portbench.reference import camera as rcam
from portbench.reference import shade as rshade
from portbench.reference.config import RenderConfig as RefConfig

H = W = 32
EMISSIVE = [0.6, 0.5, 0.4]
# yaw, pitch (deg) and radius: close above the ground, so that geometry
# fills most of the image and 2-6% of the lanes reach bounce 1
CAMERA = (37.0, 45.0, 0.7)
SCENES = {
    "single_tree": dict(spec.config("mis.file20k"), scene=dict(
        spec.config("mis.file20k")["scene"], subdiv=2, texture_res=32, env_width=64)),
    "forest": dict(spec.config("forest131k"), scene=dict(
        spec.config("forest131k")["scene"], n_spheres=6, subdiv=2, max_chunk_tris=256,
        env_width=64)),
}


def both_scenes(conf: dict):
    """The program's scene and the reference's, from the same inputs, with
    every material's emissive set on both."""
    # an OBJ of its own: the cell's file (build/portbench/<config>.obj) may
    # be written by another test at the same time
    made = scenes.inputs(dict(conf, name="test_portbench_mis"))
    prog, _ = scenes.program_scene(conf, made, "cpu")
    ref = scenes.reference_scene(conf, made, "cpu")
    em = torch.tensor(EMISSIVE).expand_as(prog.materials.emissive).contiguous()
    prog = prog.replace(materials=prog.materials.replace(emissive=em))
    ref = ref.replace(materials=dict(ref.materials, emissive=em.clone()))
    return prog, ref


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("layout", list(SCENES))
def test_reference_mis_matches_program(layout, depth):
    from tpuray_torch.integrator import path_tracer
    from tpuray_torch.scene.config import RenderConfig

    conf = SCENES[layout]
    prog, ref = both_scenes(conf)
    assert bool(prog.bvh.chunk_nodes) == (layout == "forest")
    cam = rcam.on(rcam.orbit_camera(*CAMERA, W, H, 90.0), "cpu")
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    xx, yy = xx.reshape(-1), yy.reshape(-1)
    d = rcam.pixel_directions(cam, H, W, xx, yy)
    px, py = xx, H - 1 - yy
    frame = 5
    cfg = dict(width=W, height=H, integrator="mis", max_tracing_depth=depth)
    want = rshade.trace_paths(ref, cam["eye"], d, px, py, frame, RefConfig(**cfg))
    with torch.no_grad():
        got = path_tracer.trace_paths(prog, cam["eye"][None], d, px, py, frame,
                                      RenderConfig(**cfg), common_origin=True)

    np.testing.assert_array_equal(got.first_hit_valid.numpy(), want.valid.numpy())
    valid = want.valid.numpy()
    assert 0.2 < valid.mean() < 1.0
    off = ~np.isclose(got.color.numpy(), want.color.numpy(), rtol=2e-4, atol=2e-5).all(-1)
    assert off.mean() <= 0.01, f"{off.sum()} of {off.size} rays beyond rtol 2e-4"
    assert want.color.max() > 0.05
    for name, g, r in (("albedo", got.albedo, want.albedo),
                       ("emission", got.emission, want.emission),
                       ("point", got.first_hit_point, want.point)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
    # a missed ray's normal is that of triangle 0, which is another triangle
    # in each side's order: the G-buffer masks it
    np.testing.assert_allclose(got.first_hit_normal.numpy()[valid], want.normal.numpy()[valid],
                               rtol=1e-5, atol=1e-7, err_msg="normal")
    assert (want.emission.numpy()[valid] > 0).any()
