"""The reference train step: the MSE of a 1-spp render against a target,
its gradients to every material and light leaf by autograd, and Adam
written out (torch.optim.Adam's defaults: b1 0.9, b2 0.999, eps 1e-8
added outside the square root, bias-corrected, no weight decay).

The render is tpuray_torch/train/optimize.py:render_flat's: row-major
primary rays keyed px = x, py = H - 1 - y. `store` rounds the rendered
image (the check's control passes a lower precision); `rows` picks the
pixels the loss averages (the check's half-batch fault passes half).
"""
from __future__ import annotations

from typing import Callable

import torch

from portbench.reference.camera import pixel_directions
from portbench.reference.config import RenderConfig
from portbench.reference.frame import identity
from portbench.reference.shade import RefScene, trace_paths

Tensor = torch.Tensor
B1, B2, EPS = 0.9, 0.999, 1e-8


def render_flat(scene: RefScene, cam: dict, cfg: RenderConfig, frame: int) -> Tensor:
    return render_paths(scene, cam, cfg, frame).color.reshape(cfg.height, cfg.width, 3)


def render_paths(scene: RefScene, cam: dict, cfg: RenderConfig, frame: int):
    """trace_paths' outputs for the row-major primaries."""
    h, w = cfg.height, cfg.width
    dev = cam["eye"].device
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    xx, yy = xx.reshape(-1), yy.reshape(-1)
    d = pixel_directions(cam, h, w, xx, yy)
    return trace_paths(scene, cam["eye"], d, xx, h - 1 - yy, frame, cfg)


def with_leaves(scene: RefScene, p: dict[str, Tensor]) -> RefScene:
    mats = {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith("materials.")}
    lights = {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith("lights.")}
    return scene.replace(materials=mats, lights=lights)


def run_steps(scene: RefScene, params: dict[str, Tensor], target: Tensor, cam: dict,
              cfg: RenderConfig, lr: float, steps: int, frame: int = 0,
              store: Callable = identity, rows: Tensor | None = None,
              adam: dict | None = None) -> dict:
    """`steps` Adam steps from `params` and Adam's state `adam` ({leaf:
    (exp_avg, exp_avg_sq, steps taken) or None}; None: a new optimizer)
    -> {"loss": [per step], "grad": {leaf: the first step's gradient, or
    None}, "params": {leaf: the values after the last step}}."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    adam = adam or {}
    m, v2, t = {}, {}, {}
    for k, v in p.items():
        st = adam.get(k)
        m[k] = st[0].detach().clone() if st else torch.zeros_like(v)
        v2[k] = st[1].detach().clone() if st else torch.zeros_like(v)
        t[k] = st[2] if st else 0
    losses, first = [], None
    for _ in range(steps):
        img = store(render_flat(with_leaves(scene, p), cam, cfg, frame))
        err = (img - target) ** 2
        loss = torch.mean(err if rows is None else err.reshape(-1, 3)[rows])
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: (g.detach().clone() if g is not None else None)
                     for k, g in zip(p, grads)}
        with torch.no_grad():
            for (k, leaf), g in zip(p.items(), grads):
                if g is None:
                    continue
                t[k] += 1
                m[k].mul_(B1).add_(g, alpha=1 - B1)
                v2[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                c1 = 1 - B1 ** t[k]
                c2 = 1 - B2 ** t[k]
                denom = (v2[k].sqrt() / (c2 ** 0.5)).add_(EPS)
                leaf.addcdiv_(m[k], denom, value=-lr / c1)
    return dict(loss=losses, grad=first, params={k: v.detach() for k, v in p.items()})
