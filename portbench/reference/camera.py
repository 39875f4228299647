"""The orbit camera the benchmark drives, and the primary ray directions.

The float64 orbit math of tpuray_torch/scene/camera.py (glm's lookAt and
perspective), cast to float32 last, and Camera.pixel_directions' float32
arithmetic. The harness hands the same four arrays to the program (as its
Camera) and to the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fov_y_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    t = math.tan(math.radians(fov_y_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


def orbit_camera(yaw_deg: float, pitch_deg: float, radius: float, width: int,
                 height: int, fov_y_deg: float = 90.0, near: float = 0.01,
                 far: float = 1000.0) -> dict[str, np.ndarray]:
    """{"eye" (3,), "cam_to_world" (3, 3), "view_proj" (4, 4),
    "tan_half_fov" ()} float32, looking at the origin."""
    cy, sy = math.cos(math.radians(yaw_deg)), math.sin(math.radians(yaw_deg))
    cp, sp = math.cos(math.radians(pitch_deg)), math.sin(math.radians(pitch_deg))
    eye = np.array([-sy * cp, sp, cy * cp]) * radius
    view = look_at(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]))
    proj = perspective(fov_y_deg, width / height, near, far)
    return dict(eye=eye.astype(np.float32),
                cam_to_world=np.linalg.inv(view)[:3, :3].astype(np.float32),
                view_proj=(proj @ view).astype(np.float32),
                tan_half_fov=np.float32(math.tan(math.radians(fov_y_deg) / 2.0)))


def on(cam: dict[str, np.ndarray], device) -> dict[str, Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in cam.items()}


def pixel_directions(cam: dict[str, Tensor], height: int, width: int, xx: Tensor,
                     yy: Tensor) -> Tensor:
    """(..., 3) normalized primary directions of pixels (xx, yy), row 0
    the top image row."""
    th = cam["tan_half_fov"]
    xs = (2.0 * (xx.to(torch.float32) + 0.5) / width - 1.0) * th
    ys = -((2.0 * (yy.to(torch.float32) + 0.5) / height - 1.0) * th)
    c = cam["cam_to_world"]
    d = torch.stack([c[i, 0] * xs + c[i, 1] * ys + c[i, 2] * -1.0 for i in range(3)], dim=-1)
    return d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
