"""A configuration's inputs and its scene, for the program and for the
reference, by the configuration file's "scene" entry:

- "obj_file": the harness writes the icosphere-on-ground OBJ (subdiv) and
  makes the texture layers and the env map; the program loads them through
  tpuray_torch.scene.builder.build_scene, the reference through its own
  loader (reference/scene.py);
- "test_scene" and "sphere_forest": recipes both follow, the parameters of
  tpuray_torch.scene.procedural's make_test_scene and make_large_scene
  (the reference's test_scene and sphere_forest).
"""
from __future__ import annotations

import time

from portbench.reference import scene as ref_scene
from portbench.reference.host import procedural_room_envmap
from portbench.spec import ROOT

WORK_DIR = ROOT / "build" / "portbench"


def inputs(conf: dict, write: bool = True) -> dict:
    """What the harness makes for both sides. write=False takes the OBJ
    file that another process of the run has written."""
    spec = conf["scene"]
    out = dict(obj_path=None, textures=None, env=procedural_room_envmap(spec["env_width"]))
    if spec["kind"] == "obj_file":
        out["obj_path"] = str(WORK_DIR / f"{conf['name']}.obj")
        if write:
            WORK_DIR.mkdir(parents=True, exist_ok=True)
            ref_scene.write_test_scene_obj(out["obj_path"], spec["subdiv"])
        out["textures"] = ref_scene.procedural_texture_layers(spec["texture_res"])
    return out


def program_scene(conf: dict, made: dict, device):
    """-> (the program's Scene on `device`, seconds its builder took)."""
    spec = conf["scene"]
    t0 = time.perf_counter()
    if spec["kind"] == "obj_file":
        from tpuray_torch.scene import builder
        obj = builder.ObjectSpec(path=made["obj_path"], material=dict(spec["material"]),
                                 scale=tuple(spec["scale"]), textures=made["textures"])
        scene = builder.build_scene(
            [obj], point_lights=[tuple(map(tuple, light)) for light in spec["lights"]],
            envmap=made["env"], leaf_size=spec["leaf_size"], texture_res=spec["texture_res"],
            with_textures=True, max_chunk_tris=spec["max_chunk_tris"], device=device)
    elif spec["kind"] == "test_scene":
        from tpuray_torch.scene import procedural
        scene = procedural.make_test_scene(
            subdiv=spec["subdiv"], with_lights=True, env_width=spec["env_width"],
            leaf_size=spec["leaf_size"], device=device)
    elif spec["kind"] == "sphere_forest":
        from tpuray_torch.scene import procedural
        scene = procedural.make_large_scene(
            n_spheres=spec["n_spheres"], subdiv=spec["subdiv"],
            max_chunk_tris=spec["max_chunk_tris"], leaf_size=spec["leaf_size"],
            env_width=spec["env_width"], seed=spec["seed"], device=device)
    else:
        raise ValueError(f"unknown scene kind {spec['kind']!r}")
    if device != "cpu":
        import torch
        torch.cuda.synchronize()
    return scene, time.perf_counter() - t0


def reference_scene(conf: dict, made: dict, device):
    return ref_scene.build(conf["scene"], made["obj_path"], made["textures"], made["env"],
                           device)
