"""Orbit camera controller (host-side) producing torch Camera snapshots.

Counterpart of tpuray/scene/camera.py: the same float64 numpy math, cast
to float32 last.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpuray_torch.scene.types import Camera


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed view matrix (world -> camera), glm::lookAt convention."""
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
    """Right-handed perspective projection, depth in [-1, 1] (glm default)."""
    t = math.tan(math.radians(fov_y_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class OrbitCamera:
    """Host-side mutable orbit-camera state; `.snapshot()` emits a Camera."""

    pitch_deg: float = 10.0
    yaw_deg: float = 0.0
    radius: float = 2.0
    pan: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    fov_y_deg: float = 90.0
    width: int = 800
    height: int = 800
    near: float = 0.01
    far: float = 1000.0

    @property
    def eye(self) -> np.ndarray:
        cy, sy = math.cos(math.radians(self.yaw_deg)), math.sin(math.radians(self.yaw_deg))
        cp, sp = math.cos(math.radians(self.pitch_deg)), math.sin(math.radians(self.pitch_deg))
        e = np.array([-sy * cp, sp, cy * cp]) * self.radius
        return e + self.pan

    def view_matrix(self) -> np.ndarray:
        return look_at(self.eye, np.asarray(self.pan, dtype=np.float64), np.array([0.0, 1.0, 0.0]))

    def proj_matrix(self) -> np.ndarray:
        return perspective(self.fov_y_deg, self.width / self.height, self.near, self.far)

    def snapshot(self, device="cpu") -> Camera:
        view = self.view_matrix()
        proj = self.proj_matrix()
        cam_to_world = np.linalg.inv(view)[:3, :3]

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return Camera(
            eye=f32(self.eye),
            cam_to_world=f32(cam_to_world),
            view_proj=f32(proj @ view),
            tan_half_fov=f32(math.tan(math.radians(self.fov_y_deg) / 2.0)),
        )

    # --- interaction (mouse drag / scroll / pan) ---
    def rotate(self, dx_deg: float, dy_deg: float) -> None:
        self.yaw_deg += dx_deg
        self.pitch_deg = float(np.clip(self.pitch_deg + dy_deg, -89.0, 89.0))

    def dolly(self, d: float) -> None:
        self.radius = max(0.05, self.radius - d)

    def pan_by(self, forward: float, right: float) -> None:
        view_dir = np.asarray(self.pan, dtype=np.float64) - self.eye
        view_dir /= np.linalg.norm(view_dir)
        r = np.cross(view_dir, np.array([0.0, 1.0, 0.0]))
        r /= np.linalg.norm(r)
        self.pan = np.asarray(self.pan) + forward * view_dir + right * r
