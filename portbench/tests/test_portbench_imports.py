"""Nothing the runs load is jax, jaxlib, flax or tpuray (compared by the
whole top-level name: tpuray_torch begins with tpuray), and the
reference loads nothing of tpuray_torch."""
import json
import subprocess
import sys

from portbench.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tpuray"}


def top_levels(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_chain_loads_no_jax():
    mods = top_levels(
        "import portbench.run, portbench.harness, portbench.control, portbench.check\n"
        "import portbench.clients, portbench.scenes, portbench.traceread\n"
        "from portbench import spec\n"
        "[spec.reader(m['name']) for m in spec.benchmark()['per_layer']]\n"
        "import tpuray_torch.render.renderer, tpuray_torch.train.optimize\n"
        "import tpuray_torch.scene.builder, tpuray_torch.scene.procedural\n"
        "import portbench.sharded, tpuray_torch.dist.frame, tpuray_torch.dist.multihost")
    assert not mods & FORBIDDEN, mods & FORBIDDEN
    assert "tpuray_torch" in mods


def test_reference_loads_no_program():
    mods = top_levels(
        "import portbench.reference.frame, portbench.reference.train, portbench.reference.mis\n"
        "import portbench.reference.scene, portbench.reference.trace")
    assert not mods & (FORBIDDEN | {"tpuray_torch"}), mods & (FORBIDDEN | {"tpuray_torch"})
