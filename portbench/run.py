"""Run one cell of the benchmark once, on the cards this process is given
(a cell on four chips runs this process as rank 0 of four: sharded.py).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A new process a run: set-up (imports, the
CUDA context, the kernel libraries loaded or built under build/, the
scene, the warm-up), the window of --seconds, with --trace 1 the traced
frames or steps, then the check against the reference. Context lines
first; the last line of standard output is the result's JSON object, and
the last lines of standard error each number the check compared beside
its limit. Exits 1, printing no result, without a CUDA device, with a
jax, jaxlib, flax or tpuray module loaded, or where BENCHMARK.json or the
program is missing.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build or kernel cache in fixed folders of the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "portbench" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "portbench" / "torch_extensions"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA device", file=sys.stderr)
        return 1
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import context, harness, spec
    bench = spec.benchmark()
    if torch.cuda.device_count() < spec.cell(args.workload, bench)["chips"]:
        print("portbench: fewer CUDA devices than the cell asks for", file=sys.stderr)
        return 1
    context.emit("versions", context.versions())
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), device="cuda", t0=T0, bench=bench)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
