"""Analytic synthetic scenes (counterpart of
acmmp_spherical_tpu/utils/synthetic.py, pinhole cameras, numpy only).

The interior of a textured cube room: closed-form ray exits give exact
ground-truth depth and a smooth 3D texture gives exact photo-consistency.
Rendering is numpy on the camera's float32 parameters, so images and depths
equal the reference package's renders bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from acmmp_spherical_torch.core.camera import Camera, PINHOLE, make_camera


@dataclasses.dataclass(frozen=True)
class CubeRoom:
    """Interior of the cube ``[-half, half]^3`` with a procedural texture."""

    half: float = 4.0
    # texture: sum of A*sin(w . X + phi); rows (A, wx, wy, wz, phi)
    waves: tuple = (
        (55.0, 1.3, 0.7, 0.2, 0.0),
        (35.0, 0.4, 2.3, 1.1, 1.2),
        (25.0, 3.1, 1.7, 2.9, 2.1),
        (15.0, 6.3, 4.1, 5.7, 0.7),
        (8.0, 11.7, 9.3, 12.1, 1.9),
    )
    base: float = 128.0

    def texture(self, X: np.ndarray) -> np.ndarray:
        """Intensity in ~[0, 255] at world points X (..., 3)."""
        val = np.full(X.shape[:-1], self.base)
        for A, wx, wy, wz, phi in self.waves:
            val = val + A * np.sin(X[..., 0] * wx + X[..., 1] * wy
                                   + X[..., 2] * wz + phi)
        return np.clip(val, 0.0, 255.0)

    def ray_exit(self, origin: np.ndarray, direction: np.ndarray):
        """Slab-method exit distance and inward face normal."""
        d = np.where(np.abs(direction) < 1e-12, 1e-12, direction)
        t_hi = (self.half - origin) / d
        t_lo = (-self.half - origin) / d
        t_face = np.maximum(t_hi, t_lo)
        t = np.min(t_face, axis=-1)
        axis = np.argmin(t_face, axis=-1)
        sign = np.take_along_axis(np.sign(d), axis[..., None], axis=-1)[..., 0]
        normal = np.zeros(direction.shape)
        np.put_along_axis(normal, axis[..., None], -sign[..., None], axis=-1)
        return t, normal


def _np32(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def render_view(cam: Camera, scene: CubeRoom, width: int, height: int):
    """(image, depth, normal_world) of a pinhole camera inside the scene."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    K = _np32(cam.K)
    u = (xs - K[0, 2]) / K[0, 0]
    v = (ys - K[1, 2]) / K[1, 1]
    rays_cam = np.stack([u, v, np.ones_like(u)], -1)
    R = _np32(cam.R)
    C = np.asarray(-R.T @ _np32(cam.t))
    rays_world = rays_cam @ R
    t, normal = scene.ray_exit(C[None, None, :], rays_world)
    X = C[None, None, :] + t[..., None] * rays_world
    image = scene.texture(X).astype(np.float32)
    return image, t.astype(np.float32), normal.astype(np.float32)


def make_ring_of_cameras(n: int, *, width: int = 96, height: int = 72,
                         focal: float = 80.0, radius: float = 0.35,
                         half: float = 4.0, look_jitter: float = 0.0,
                         device="cpu") -> list[Camera]:
    """Pinhole cameras on a small circle near the room centre, looking +z."""
    cams = []
    dmin, dmax = 0.3 * half, 2.5 * half
    for i in range(n):
        ang = 2.0 * np.pi * i / max(n, 1)
        C = np.array([radius * np.cos(ang), radius * np.sin(ang), -0.5 * half])
        fwd = np.array([look_jitter * np.sin(ang), -look_jitter * np.cos(ang),
                        1.0])
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd])
        t = -R @ C
        K = np.array([[focal, 0.0, width / 2], [0.0, focal, height / 2],
                      [0.0, 0.0, 1.0]])
        cams.append(make_camera(R, t, model=PINHOLE, K=K, width=width,
                                height=height, depth_min=dmin,
                                depth_max=dmax, device=device))
    return cams


def render_scene(cams: Sequence[Camera], scene: CubeRoom, width: int,
                 height: int):
    """Render all views: (images (V,H,W), depths (V,H,W), normals
    (V,H,W,3) world frame)."""
    out = [render_view(cam, scene, width, height) for cam in cams]
    return tuple(np.stack(a) for a in zip(*out))
