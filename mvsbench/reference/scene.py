"""The benchmark's synthetic scene and its ground truth, in plain torch.

A frozen copy of the CubeRoom generator of ``acmmp_spherical_torch/utils/
synthetic.py`` (the interior of a textured cube, closed-form ray exits,
the same five texture waves), computing in float64 with torch on any
device, so set-up renders on the card.  The texture is the same for every
seed: textures drawn from the seed moved the depth error by 8% from seed
to seed, so every seed gets the same scene and the seed draws the passes'
keys, the geometric seeds' perturbation and the reference's samples.

It imports nothing of the program: it is the reference's ground truth
(depth along each pixel's ray, the world normal of the surface hit) as well
as the benchmark's image generator.

Cameras follow the program's conventions (reference ``main.h``):
``X_cam = R X + t``; pinhole depth is z with the ray ``((x - cx) / fx,
(y - cy) / fy, 1)``; SPHERE (equirectangular) depth is the radial distance
with ``lon = (x - cx) / W * 2 pi``, ``lat = -(y - cy) / H * pi`` and the ray
``(cos lat sin lon, -sin lat, cos lat cos lon)``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

HALF = 4.0
BASE = 128.0
# (amplitude, wx, wy, wz, phase) of the five texture waves
# (utils/synthetic.py)
WAVES = ((55.0, 1.3, 0.7, 0.2, 0.0), (35.0, 0.4, 2.3, 1.1, 1.2),
         (25.0, 3.1, 1.7, 2.9, 2.1), (15.0, 6.3, 4.1, 5.7, 0.7),
         (8.0, 11.7, 9.3, 12.1, 1.9))


@dataclasses.dataclass(frozen=True)
class RingCamera:
    """One camera of the ring at the size of its image file, float64."""

    model: str            # "pinhole" or "sphere"
    R: np.ndarray         # (3, 3)
    t: np.ndarray         # (3,)
    width: int
    height: int
    K: np.ndarray         # (3, 3) pinhole intrinsics (identity for SPHERE)
    sphere: np.ndarray    # (3,) [f, cx, cy] (zeros for pinhole)
    depth_min: float
    depth_max: float

    def scaled(self, width: int, height: int) -> "RingCamera":
        """The camera of the image resized to (width, height): pinhole fx,
        cx scale with the width and fy, cy with the height; SPHERE cx, cy
        (reference ACMMP.cpp:630-642)."""
        sx, sy = width / self.width, height / self.height
        K = self.K.copy()
        sphere = self.sphere.copy()
        if self.model == "sphere":
            sphere[1:] *= (sx, sy)
        else:
            K[0, 0] *= sx
            K[0, 2] *= sx
            K[1, 1] *= sy
            K[1, 2] *= sy
        return dataclasses.replace(self, width=width, height=height, K=K,
                                   sphere=sphere)


def ring_cameras(n: int, *, model: str, width: int, height: int,
                 focal: float = 0.0, radius: float) -> list[RingCamera]:
    """``n`` cameras on a circle of ``radius`` near the room's centre,
    looking +z (``utils/synthetic.make_ring_of_cameras``): pinhole with
    ``focal`` and the principal point at the image centre, or SPHERE with
    params ``[1, width / 2, height / 2]``."""
    cams = []
    for i in range(n):
        ang = 2.0 * math.pi * i / n
        C = np.array([radius * math.cos(ang), radius * math.sin(ang),
                      -0.5 * HALF])
        fwd = np.array([0.0, 0.0, 1.0])
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd])
        K = np.eye(3)
        sphere = np.zeros(3)
        if model == "sphere":
            sphere = np.array([1.0, width / 2, height / 2])
        else:
            K = np.array([[focal, 0.0, width / 2], [0.0, focal, height / 2],
                          [0.0, 0.0, 1.0]])
        cams.append(RingCamera(model, R, -R @ C, width, height, K, sphere,
                               0.3 * HALF, 2.5 * HALF))
    return cams


def pixel_rays(cam: RingCamera, device) -> torch.Tensor:
    """Camera-frame rays (H, W, 3), float64, with ``X_cam = depth * ray``."""
    ys = torch.arange(cam.height, dtype=torch.float64, device=device)[:, None]
    xs = torch.arange(cam.width, dtype=torch.float64, device=device)[None, :]
    if cam.model == "sphere":
        _, cx, cy = cam.sphere
        lon = (xs - cx) / cam.width * (2.0 * math.pi)
        lat = -(ys - cy) / cam.height * math.pi
        lon, lat = torch.broadcast_tensors(lon, lat)
        cl = torch.cos(lat)
        return torch.stack([cl * torch.sin(lon), -torch.sin(lat),
                            cl * torch.cos(lon)], -1)
    u = (xs - cam.K[0, 2]) / cam.K[0, 0]
    v = (ys - cam.K[1, 2]) / cam.K[1, 1]
    u, v = torch.broadcast_tensors(u, v)
    return torch.stack([u, v, torch.ones_like(u)], -1)


def ray_exit(origin: torch.Tensor, d: torch.Tensor):
    """Slab-method exit distance of rays ``origin + t d`` from the cube and
    the inward normal of the face they exit through."""
    d = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t_face = torch.maximum((HALF - origin) / d, (-HALF - origin) / d)
    t, axis = torch.min(t_face, dim=-1)
    sign = torch.gather(torch.sign(d), -1, axis[..., None])
    normal = torch.zeros_like(d).scatter_(-1, axis[..., None], -sign)
    return t, normal


def texture(X: torch.Tensor) -> torch.Tensor:
    """Intensity in [0, 255] at world points X (..., 3)."""
    val = torch.full(X.shape[:-1], BASE, dtype=X.dtype, device=X.device)
    for A, wx, wy, wz, phi in WAVES:
        val = val + A * torch.sin(X[..., 0] * wx + X[..., 1] * wy
                                  + X[..., 2] * wz + phi)
    return torch.clamp(val, 0.0, 255.0)


def render(cam: RingCamera, device="cpu", *, image: bool = False):
    """(image or None, depth, world normal) of a camera, float64: the
    image only when asked; depth in the camera's convention (z, or radial
    for SPHERE)."""
    R = torch.as_tensor(cam.R, dtype=torch.float64, device=device)
    C = -R.T @ torch.as_tensor(cam.t, dtype=torch.float64, device=device)
    rays = pixel_rays(cam, device) @ R
    t, normal = ray_exit(C, rays)
    return (texture(C + t[..., None] * rays) if image else None), t, normal
