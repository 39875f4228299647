"""Asset-root resolution (counterpart of tpuray/io/filesystem.py).

  resolve("models/clock.obj")

checks, in order:
  1. absolute paths and paths that exist relative to the working directory,
     returned as they are;
  2. the roots in $TPURAY_ASSET_ROOT (os.pathsep-separated);
  3. roots registered with add_root() (the most recently added first);
  4. the built-in fallback root, this repository's assets/ directory.

The order is the JAX package's; only the built-in fallback differs (the JAX
package falls back to a checkout of the original renderer's assets).
Raises FileNotFoundError listing every path tried.
"""
from __future__ import annotations

import os
from pathlib import Path

_ENV_VAR = "TPURAY_ASSET_ROOT"

_DEFAULT_ROOTS = [str(Path(__file__).resolve().parents[2] / "assets")]

_extra_roots: list[str] = []


def add_root(root: str | os.PathLike) -> None:
    """Register an asset root, searched after $TPURAY_ASSET_ROOT and before
    the built-in root; the most recently added wins."""
    r = str(root)
    if r in _extra_roots:
        _extra_roots.remove(r)
    _extra_roots.insert(0, r)


def roots() -> list[str]:
    """The search order (first match wins)."""
    out = []
    env = os.environ.get(_ENV_VAR)
    if env:
        out.extend(env.split(os.pathsep))
    out.extend(_extra_roots)
    out.extend(_DEFAULT_ROOTS)
    return out


def resolve(rel_path: str | os.PathLike) -> str:
    """Resolve an asset path against the configured roots (module doc)."""
    p = Path(rel_path)
    if p.is_absolute() or p.exists():
        return str(p)
    tried = []
    for root in roots():
        cand = Path(root) / p
        if cand.exists():
            return str(cand)
        tried.append(str(cand))
    raise FileNotFoundError(
        f"asset {str(rel_path)!r} not found; tried: {', '.join(tried)} "
        f"(set ${_ENV_VAR} or tpuray_torch.io.filesystem.add_root())")
