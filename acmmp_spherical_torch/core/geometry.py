"""Projective geometry (counterpart of acmmp_spherical_tpu/core/geometry.py).

Shape-polymorphic functions on float32 tensors.  Plane hypotheses are
``(n, w)`` with ``n . X_cam + w = 0`` in the reference-camera frame; pinhole
depth is z.  The 3-term contractions are written out term by term in the
reference's order, so they run in full f32 on any device.
"""

from __future__ import annotations

import torch

from acmmp_spherical_torch.core.camera import Camera, SPHERE

INVALID_DEPTH = 1.0e6
_PARALLEL_EPS = 1.0e-6


def _pinhole_only(cam: Camera) -> None:
    if cam.model == SPHERE:
        raise NotImplementedError(
            "SPHERE geometry arrives with the sphere slice (ROADMAP slice 4)")


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _mat3_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(3, 3) @ (..., 3) -> (..., 3)."""
    return torch.stack([v[..., 0] * m[i, 0] + v[..., 1] * m[i, 1]
                        + v[..., 2] * m[i, 2] for i in range(3)], -1)


def _mat3t_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(3, 3)^T @ (..., 3) -> (..., 3)."""
    return torch.stack([v[..., 0] * m[0, i] + v[..., 1] * m[1, i]
                        + v[..., 2] * m[2, i] for i in range(3)], -1)


def pixel_ray(cam: Camera, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Camera-frame ray ``((x-cx)/fx, (y-cy)/fy, 1)``: ``X_cam = depth * r``."""
    _pinhole_only(cam)
    u = (x - cam.K[0, 2]) / cam.K[0, 0]
    v = (y - cam.K[1, 2]) / cam.K[1, 1]
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


def normal_cam_to_world(cam: Camera, n: torch.Tensor) -> torch.Tensor:
    """Reference TransformNormal (ACMMP.cu:378-386)."""
    return _mat3t_vec(cam.R, n)


def normal_world_to_cam(cam: Camera, n: torch.Tensor) -> torch.Tensor:
    """Reference TransformNormal2RefCam (ACMMP.cu:388-396)."""
    return _mat3_vec(cam.R, n)


def normalize(v: torch.Tensor, eps: float = 1.0e-20) -> torch.Tensor:
    """rsqrt-normalise along the last axis (reference ACMMP.cu:110-117)."""
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))
