"""The context of a run, printed before its result: the versions, the card
and its power limit, its clocks and temperature beside the window, and
what the scene makes the frame do. A wide spread can then be told from a
slow or throttled card."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

SMI_FIELDS = "name,power.limit,clocks.sm,clocks.mem,temperature.gpu,power.draw"


def _run(cmd: list[str]) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    return (out.stdout or out.stderr).strip()


def nvcc_version() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        return "not found"
    lines = _run([nvcc, "--version"]).splitlines()
    return lines[-1] if lines else "unknown"


def smi() -> list[str]:
    """One line per card: name, power limit, SM and memory clocks,
    temperature, power draw."""
    if shutil.which("nvidia-smi") is None:
        return ["nvidia-smi not found"]
    return _run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                 "--format=csv,noheader"]).splitlines()


def versions() -> dict:
    return dict(python=sys.version.split()[0], torch=torch.__version__,
                cuda=torch.version.cuda, nvcc=nvcc_version(),
                device=torch.cuda.get_device_name() if torch.cuda.is_available() else None,
                device_count=torch.cuda.device_count(), torch_threads=torch.get_num_threads())


def emit(tag: str, value) -> None:
    """One context line on stdout, before the result's line."""
    print(f"context {tag}: {json.dumps(value, default=str)}", flush=True)
