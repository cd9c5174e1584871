"""Projective geometry (counterpart of acmmp_spherical_tpu/core/geometry.py).

Shape-polymorphic functions on float32 tensors.  Plane hypotheses are
``(n, w)`` with ``n . X_cam + w = 0`` in the reference-camera frame; pinhole
depth is z, SPHERE depth the radial distance.  The SPHERE pixel mapping
(reference ACMMP.cu:127-133, 624-629): ``lon = (x - cx) / W * 2 pi``,
``lat = -(y - cy) / H * pi``, ray ``(cos lat sin lon, -sin lat, cos lat cos
lon)``.  The 3-term contractions are written out term by term in the
reference's order, so they run in full f32 on any device.
"""

from __future__ import annotations

import torch

import math

from acmmp_spherical_torch.core.camera import Camera, SPHERE, camera_center

PI = math.pi
INVALID_DEPTH = 1.0e6
_PARALLEL_EPS = 1.0e-6


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _mat3_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3), leading axes broadcast."""
    return torch.stack([v[..., 0] * m[..., i, 0] + v[..., 1] * m[..., i, 1]
                        + v[..., 2] * m[..., i, 2] for i in range(3)], -1)


def _mat3t_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3)^T @ (..., 3) -> (..., 3), leading axes broadcast."""
    return torch.stack([v[..., 0] * m[..., 0, i] + v[..., 1] * m[..., 1, i]
                        + v[..., 2] * m[..., 2, i] for i in range(3)], -1)


def equirect_ray(lon: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """Unit ray ``(cos lat sin lon, -sin lat, cos lat cos lon)``."""
    cl = torch.cos(lat)
    return torch.stack([cl * torch.sin(lon), -torch.sin(lat),
                        cl * torch.cos(lon)], -1)


def pixel_ray(cam: Camera, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Camera-frame ray with ``X_cam = depth * r``: pinhole
    ``((x-cx)/fx, (y-cy)/fy, 1)``, SPHERE the unit lon/lat ray."""
    if cam.model == SPHERE:
        lon = (x - cam.params[..., 1]) / cam.width * (2.0 * PI)
        lat = -(y - cam.params[..., 2]) / cam.height * PI
        return equirect_ray(lon, lat)
    u = (x - cam.K[..., 0, 2]) / cam.K[..., 0, 0]
    v = (y - cam.K[..., 1, 2]) / cam.K[..., 1, 1]
    return torch.stack([u, v, torch.ones_like(u)], -1)


def view_direction(cam: Camera, x, y) -> torch.Tensor:
    """Unit viewing direction (reference GetViewDirection, ACMMP.cu:161-165)."""
    r = pixel_ray(cam, x, y)
    return r / torch.sqrt((r * r).sum(-1, keepdim=True))


def depth_from_plane(cam: Camera, x, y, normal, w) -> torch.Tensor:
    """Ray-plane depth ``-w / (n . r)``; INVALID_DEPTH for near-parallel rays
    (reference ACMMP.cu:187-193)."""
    denom = _dot3(normal, pixel_ray(cam, x, y))
    return torch.where(denom.abs() < _PARALLEL_EPS,
                       torch.full_like(denom, INVALID_DEPTH), -w / denom)


def dist_to_origin(cam: Camera, x, y, depth, normal) -> torch.Tensor:
    """Plane offset ``w = -(n . X_cam)`` (reference ACMMP.cu:168-173)."""
    return -depth * _dot3(normal, pixel_ray(cam, x, y))


def unproject_world(cam: Camera, x, y, depth) -> torch.Tensor:
    """Pixel + depth -> world point ``R^T (depth * ray) + C`` (reference
    Get3DPointonWorld_cu, ACMMP.cu:584-599)."""
    X_cam = pixel_ray(cam, x, y) * depth[..., None]
    return _mat3t_vec(cam.R, X_cam) + camera_center(cam)


def project(cam: Camera, X: torch.Tensor):
    """World point -> (x, y, depth).  Pinhole (reference ACMMP.cu:632-643):
    depth z, |z| floored at 1e-6 in the division.  SPHERE (ACMMP.cu:616-630):
    depth ``||X_cam||``, the equirect mapping, longitude in
    ``(-W/2 + cx, W/2 + cx]`` (callers wrap), a point at the centre at the
    principal point.  ``cam`` may be view-batched with its tensors shaped to
    broadcast against ``X`` (``camera.expand_views``)."""
    Xc = _mat3_vec(cam.R, X) + cam.t
    if cam.model == SPHERE:
        depth = torch.sqrt(_dot3(Xc, Xc))
        safe = torch.clamp(depth, min=_PARALLEL_EPS)
        lat = -torch.arcsin(torch.clamp(Xc[..., 1] / safe, -1.0, 1.0))
        lon = torch.arctan2(Xc[..., 0], Xc[..., 2])
        cx, cy = cam.params[..., 1], cam.params[..., 2]
        centre = depth < _PARALLEL_EPS
        x = torch.where(centre, cx, lon / (2.0 * PI) * cam.width + cx)
        y = torch.where(centre, cy, -lat / PI * cam.height + cy)
        return x, y, depth
    depth = Xc[..., 2]
    z = torch.where(depth.abs() < _PARALLEL_EPS,
                    torch.full_like(depth, _PARALLEL_EPS), depth)
    K = cam.K
    x = (K[..., 0, 0] * Xc[..., 0] + K[..., 0, 1] * Xc[..., 1]
         + K[..., 0, 2] * Xc[..., 2]) / z
    y = (K[..., 1, 0] * Xc[..., 0] + K[..., 1, 1] * Xc[..., 1]
         + K[..., 1, 2] * Xc[..., 2]) / z
    return x, y, depth


def disparity(cam: Camera, x, y, depth) -> torch.Tensor:
    """Range to the camera of a pixel at ``depth`` (reference GetDisparity,
    ACMMP.cpp:536-546): ``||K^-1 p * z||`` for pinhole, the depth itself
    for SPHERE (already radial)."""
    if cam.model == SPHERE:
        return depth
    X = pixel_ray(cam, x, y) * depth[..., None]
    return torch.sqrt(_dot3(X, X))


def normal_cam_to_world(cam: Camera, n: torch.Tensor) -> torch.Tensor:
    """Reference TransformNormal (ACMMP.cu:378-386)."""
    return _mat3t_vec(cam.R, n)


def normal_world_to_cam(cam: Camera, n: torch.Tensor) -> torch.Tensor:
    """Reference TransformNormal2RefCam (ACMMP.cu:388-396)."""
    return _mat3_vec(cam.R, n)


def normalize(v: torch.Tensor, eps: float = 1.0e-20) -> torch.Tensor:
    """rsqrt-normalise along the last axis (reference ACMMP.cu:110-117)."""
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))
