"""Camera models (counterpart of acmmp_spherical_tpu/core/camera.py).

A :class:`Camera` holds float32 tensors; a batch of cameras is the same
dataclass with a leading view axis on every tensor.  Conventions are the
reference's: ``X_cam = R @ X + t``.  Pinhole depth is z; SPHERE
(equirectangular, COLMAP custom model id 11) depth is the radial distance
``||X_cam||``, with the sphere params ``[f, cx, cy]``.
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
                depth_max: float = 1.0, device="cuda") -> Camera:
    """A camera on ``device``: pinhole with ``K``, or SPHERE with
    ``sphere_params`` ``[f, cx, cy]`` (its ``K`` is the identity)."""
    params = np.zeros(4, np.float32)
    if model == SPHERE:
        if sphere_params is None or len(sphere_params) < 3:
            raise ValueError("a SPHERE camera needs sphere_params [f, cx, cy]")
        params[:3] = np.asarray(sphere_params[:3], np.float32)
        K = np.eye(3)
    elif model != PINHOLE:
        raise ValueError(f"unknown camera model {model!r}")
    elif K is None:
        raise ValueError("a pinhole camera needs K")
    f32 = lambda a, shape: torch.as_tensor(
        np.asarray(a, np.float32).reshape(shape), device=device)
    return Camera(
        R=f32(R, (3, 3)), t=f32(t, (3,)), K=f32(K, (3, 3)),
        params=f32(params, (4,)), wh=f32([width, height], (2,)),
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


def expand_views(cams: Cameras, ndim: int) -> Cameras:
    """A view-batched camera with ``ndim`` unit axes after the view axis, so
    its tensors broadcast against (..., ``ndim`` spatial axes) fields:
    ``project(expand_views(cams, 2), X)`` maps (H, W, 3) points to (S, H, W)
    coordinates."""
    unit = (1,) * ndim
    return dataclasses.replace(cams, **{
        f.name: getattr(cams, f.name).reshape(
            getattr(cams, f.name).shape[:1] + unit
            + getattr(cams, f.name).shape[1:])
        for f in dataclasses.fields(cams) if f.name != "model"})


def camera_center(cam: Camera) -> torch.Tensor:
    """World-space centre ``C = -R^T t`` (reference ACMMP.cu:590-594)."""
    R, t = cam.R, cam.t
    return -(R[..., 0, :] * t[..., 0:1] + R[..., 1, :] * t[..., 1:2]
             + R[..., 2, :] * t[..., 2:3])


def scale_camera(cam: Camera, scale_x: float, scale_y: float,
                 new_width: int, new_height: int) -> Camera:
    """Rescale the intrinsics with the image (reference ACMMP.cpp:630-642):
    pinhole fx, cx *= sx; fy, cy *= sy; SPHERE cx *= sx; cy *= sy."""
    if cam.model == SPHERE:
        s = torch.tensor([1.0, scale_x, scale_y, 1.0], dtype=cam.params.dtype,
                         device=cam.params.device)
        K, params = cam.K, cam.params * s
    else:
        s = torch.tensor([[scale_x, 1.0, scale_x], [1.0, scale_y, scale_y],
                          [1.0, 1.0, 1.0]], dtype=cam.K.dtype,
                         device=cam.K.device)
        K, params = cam.K * s, cam.params
    return dataclasses.replace(
        cam, K=K, params=params,
        wh=torch.tensor([new_width, new_height], dtype=cam.wh.dtype,
                        device=cam.wh.device))
