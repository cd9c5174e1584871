"""Camera models (counterpart of acmmp_spherical_tpu/core/camera.py).

A :class:`Camera` holds float32 tensors; a batch of cameras is the same
dataclass with a leading view axis on every tensor.  Conventions are the
reference's: ``X_cam = R @ X + t``, pinhole depth is z.  Only the PINHOLE
model is ported so far; SPHERE comes with the sphere slice (ROADMAP slice 4).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

PINHOLE = "pinhole"
SPHERE = "sphere"


@dataclasses.dataclass(frozen=True)
class Camera:
    """``K`` (..., 3, 3) intrinsics; ``params`` (..., 4) sphere params (zeros
    for pinhole); ``wh`` (..., 2) float [width, height]; ``depth_range``
    (..., 2) [depth_min, depth_max]."""

    R: torch.Tensor
    t: torch.Tensor
    K: torch.Tensor
    params: torch.Tensor
    wh: torch.Tensor
    depth_range: torch.Tensor
    model: str = PINHOLE

    @property
    def width(self) -> torch.Tensor:
        return self.wh[..., 0]

    @property
    def height(self) -> torch.Tensor:
        return self.wh[..., 1]


Cameras = Camera


def make_camera(R, t, *, model: str = PINHOLE, K=None, sphere_params=None,
                width: int = 0, height: int = 0, depth_min: float = 0.0,
                depth_max: float = 1.0, device="cpu") -> Camera:
    if model != PINHOLE:
        raise NotImplementedError(
            "SPHERE cameras arrive with the sphere slice (ROADMAP slice 4)")
    if K is None:
        raise ValueError("a pinhole camera needs K")
    f32 = lambda a, shape: torch.as_tensor(
        np.asarray(a, np.float32).reshape(shape), device=device)
    return Camera(
        R=f32(R, (3, 3)), t=f32(t, (3,)), K=f32(K, (3, 3)),
        params=torch.zeros(4, dtype=torch.float32, device=device),
        wh=f32([width, height], (2,)),
        depth_range=f32([depth_min, depth_max], (2,)),
        model=model)


def stack_cameras(cams: Sequence[Camera]) -> Cameras:
    """Stack single cameras into a view-batched Camera (leading view axis)."""
    models = {c.model for c in cams}
    if len(models) != 1:
        raise ValueError(f"cannot batch mixed camera models: {models}")
    return Camera(**{f.name: torch.stack([getattr(c, f.name) for c in cams])
                     for f in dataclasses.fields(Camera) if f.name != "model"},
                  model=cams[0].model)


def camera_index(cams: Cameras, i: int) -> Camera:
    return dataclasses.replace(
        cams, **{f.name: getattr(cams, f.name)[i]
                 for f in dataclasses.fields(cams) if f.name != "model"})


def camera_center(cam: Camera) -> torch.Tensor:
    """World-space centre ``C = -R^T t`` (reference ACMMP.cu:590-594)."""
    R, t = cam.R, cam.t
    return -(R[..., 0, :] * t[..., 0:1] + R[..., 1, :] * t[..., 1:2]
             + R[..., 2, :] * t[..., 2:3])
