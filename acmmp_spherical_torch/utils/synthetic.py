"""Analytic synthetic scenes (counterpart of
acmmp_spherical_tpu/utils/synthetic.py, pinhole and SPHERE cameras, numpy
only), and their on-disk scene folders.

The interior of a textured cube room: closed-form ray exits give exact
ground-truth depth and a smooth 3D texture gives exact photo-consistency.
Rendering is numpy on the camera's float32 parameters, so images and depths
equal the reference package's renders bit for bit.  ``OccludedRoom`` adds
an occluding box (true depth steps); ``render_scene_hostile`` adds specular
shading, per-view exposure, noise and JPEG artefacts.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from acmmp_spherical_torch.core.camera import (
    Camera, PINHOLE, SPHERE, make_camera,
)
from acmmp_spherical_torch.io.scene import (
    ScenePaths, write_camera_file, write_image, write_pair_file,
)


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


@dataclasses.dataclass(frozen=True)
class OccludedRoom(CubeRoom):
    """CubeRoom with an axis-aligned box inside it: its silhouette makes
    true depth discontinuities (fore/background steps of several units),
    the hard case for windowed and slab sampling.  The texture is the same
    world-space field, so photo-consistency stays exact."""

    box_center: tuple = (0.8, -0.4, 0.6)
    box_half: tuple = (1.0, 1.2, 0.8)

    def ray_exit(self, origin: np.ndarray, direction: np.ndarray):
        t_room, n_room = CubeRoom.ray_exit(self, origin, direction)
        d = np.where(np.abs(direction) < 1e-12, 1e-12, direction)
        c = np.asarray(self.box_center)
        h = np.asarray(self.box_half)
        t0 = (c - h - origin) / d
        t1 = (c + h - origin) / d
        t_near = np.minimum(t0, t1)
        t_far = np.maximum(t0, t1)
        t_enter = np.max(t_near, axis=-1)
        t_exit = np.min(t_far, axis=-1)
        hit = (t_enter < t_exit) & (t_enter > 1e-6) & (t_enter < t_room)
        axis = np.argmax(t_near, axis=-1)
        sign = np.take_along_axis(np.sign(d), axis[..., None], axis=-1)[..., 0]
        n_box = np.zeros(direction.shape)
        np.put_along_axis(n_box, axis[..., None], -sign[..., None], axis=-1)
        t = np.where(hit, t_enter, t_room)
        normal = np.where(hit[..., None], n_box, n_room)
        return t, normal


def _np32(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _pixel_ray_np(cam: Camera, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """numpy ``geometry.pixel_ray`` on the camera's float32 parameters."""
    if cam.model == SPHERE:
        params = _np32(cam.params)
        W, H = _np32(cam.wh)
        lon = (xs - params[1]) / W * (2.0 * np.pi)
        lat = -(ys - params[2]) / H * np.pi
        cl = np.cos(lat)
        return np.stack([cl * np.sin(lon), -np.sin(lat), cl * np.cos(lon)], -1)
    K = _np32(cam.K)
    u = (xs - K[0, 2]) / K[0, 0]
    v = (ys - K[1, 2]) / K[1, 1]
    return np.stack([u, v, np.ones_like(u)], -1)


def render_view(cam: Camera, scene: CubeRoom, width: int, height: int):
    """(image, depth, normal_world) of a camera inside the scene; depth is
    the camera's convention (z for pinhole, radial for SPHERE)."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    rays_cam = _pixel_ray_np(cam, xs, ys)
    R = _np32(cam.R)
    C = np.asarray(-R.T @ _np32(cam.t))
    rays_world = rays_cam @ R
    t, normal = scene.ray_exit(C[None, None, :], rays_world)
    X = C[None, None, :] + t[..., None] * rays_world
    image = scene.texture(X).astype(np.float32)
    return image, t.astype(np.float32), normal.astype(np.float32)


def make_ring_of_cameras(n: int, *, model: str = PINHOLE, width: int = 96,
                         height: int = 72, focal: float = 80.0,
                         radius: float = 0.35, half: float = 4.0,
                         look_jitter: float = 0.0,
                         device="cuda") -> list[Camera]:
    """Cameras on a small circle near the room centre, looking +z: pinhole
    (``focal``), or SPHERE with params ``[1, width / 2, height / 2]``."""
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
        intr = (dict(sphere_params=[1.0, width / 2, height / 2])
                if model == SPHERE else
                dict(K=np.array([[focal, 0.0, width / 2],
                                 [0.0, focal, height / 2], [0.0, 0.0, 1.0]])))
        cams.append(make_camera(R, t, model=model, width=width,
                                height=height, depth_min=dmin,
                                depth_max=dmax, device=device, **intr))
    return cams


def render_scene(cams: Sequence[Camera], scene: CubeRoom, width: int,
                 height: int):
    """Render all views: (images (V,H,W), depths (V,H,W), normals
    (V,H,W,3) world frame)."""
    out = [render_view(cam, scene, width, height) for cam in cams]
    return tuple(np.stack(a) for a in zip(*out))


def render_scene_hostile(cams: Sequence[Camera], scene: CubeRoom, width: int,
                         height: int, *, seed: int = 0,
                         specular_ks: float = 30.0,
                         specular_power: float = 8.0,
                         gain_range: tuple = (0.85, 1.15),
                         bias_range: tuple = (-10.0, 10.0),
                         noise_sigma: float = 2.0, jpeg_quality: int = 75):
    """``render_scene`` with what real captures add: a view-dependent
    specular lobe (Blinn-Phong toward a fixed world light), a gain and bias
    per view, Gaussian sensor noise and a JPEG round trip at
    ``jpeg_quality``.  Depths and normals stay the exact ground truth.  The
    random draws come from ``np.random.default_rng(seed)`` in the reference
    package's order, so the images equal its renders bit for bit."""
    import cv2

    rng = np.random.default_rng(seed)
    light = np.array([0.3, -0.8, 0.52])
    light = light / np.linalg.norm(light)
    images, depths, normals = [], [], []
    for cam in cams:
        img, dep, nrm = render_view(cam, scene, width, height)
        ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
        rays_world = _pixel_ray_np(cam, xs, ys) @ _np32(cam.R)
        rays_world = rays_world / np.linalg.norm(rays_world, axis=-1,
                                                 keepdims=True)
        halfv = light[None, None] - rays_world        # toward the viewer
        halfv = halfv / np.maximum(
            np.linalg.norm(halfv, axis=-1, keepdims=True), 1e-9)
        spec = np.maximum(np.sum(halfv * nrm, axis=-1), 0.0) ** specular_power
        img = img + specular_ks * spec.astype(np.float32)
        img = rng.uniform(*gain_range) * img + rng.uniform(*bias_range)
        img = img + rng.normal(0.0, noise_sigma, img.shape).astype(np.float32)
        img = np.clip(img, 0.0, 255.0)
        ok, buf = cv2.imencode(".jpg", img.astype(np.uint8),
                               [cv2.IMWRITE_JPEG_QUALITY, int(jpeg_quality)])
        if not ok:
            raise RuntimeError("JPEG encoding failed")
        img = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        images.append(img)
        depths.append(dep)
        normals.append(nrm)
    return np.stack(images), np.stack(depths), np.stack(normals)


def write_synthetic_scene_to_disk(root, cams: Sequence[Camera], images):
    """Write a rendered scene in the on-disk layout (images/ as JPEG at
    quality 98, cams/, and a pair.txt in which every view takes every
    other), as the JAX package's writer does.  Returns its ScenePaths."""
    sp = ScenePaths(root)
    sp.images_dir.mkdir(parents=True, exist_ok=True)
    sp.cams_dir.mkdir(parents=True, exist_ok=True)
    n = len(cams)
    for i, cam in enumerate(cams):
        write_image(sp.image_file(i),
                    np.clip(images[i], 0, 255).astype(np.uint8),
                    jpeg_quality=98)
        dmin, dmax = _np32(cam.depth_range)
        intr = (dict(sphere_params=_np32(cam.params)[:3])
                if cam.model == SPHERE else dict(K=_np32(cam.K)))
        write_camera_file(sp.camera_file(i), cam.model, _np32(cam.R),
                          _np32(cam.t), depth_min=float(dmin),
                          depth_max=float(dmax),
                          depth_interval=float((dmax - dmin) / 191),
                          num_planes=192, **intr)
    write_pair_file(sp.pair_file, [[(j, 100.0) for j in range(n) if j != i]
                                   for i in range(n)])
    return sp


def write_synthetic_colmap(root, cams: Sequence[Camera], images, depths, *,
                           binary: bool = False, n_points: int = 400,
                           seed: int = 0) -> None:
    """Write a rendered scene as a COLMAP sparse model with real tracks
    (``root/sparse`` in the text or binary format, ``root/images`` as PNG):
    ``n_points`` surface points unprojected from random pixels of each view
    at their ground-truth depths, observed by every view they project into;
    points seen by fewer than 2 views are left out and their observations
    carry point id -1, as COLMAP writes them.  One shared camera: PINHOLE
    (``fx fy cx cy``) or the custom SPHERE model id 11 (``f cx cy``)."""
    import struct
    from pathlib import Path

    import torch

    from acmmp_spherical_torch.core import geometry as G
    from acmmp_spherical_torch.pipeline.colmap import (
        CAMERA_MODEL_IDS, rotmat2qvec,
    )

    root = Path(root)
    n_views = len(cams)
    H, W = images[0].shape
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    pts = []
    for v, cam in enumerate(cams):
        xs = rng.uniform(2, W - 3, n_points // n_views).astype(np.float32)
        ys = rng.uniform(2, H - 3, n_points // n_views).astype(np.float32)
        d = depths[v][ys.astype(int), xs.astype(int)]
        pts.append(_np32(G.unproject_world(cam, t(xs), t(ys), t(d))))
    pts = np.concatenate(pts)
    tracks = {i: [] for i in range(len(pts))}
    obs = {v: [] for v in range(n_views)}
    for v, cam in enumerate(cams):
        px, py, pd = (_np32(a) for a in G.project(cam, t(pts)))
        vis = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (pd > 0)
        for p in np.nonzero(vis)[0]:
            obs[v].append((float(px[p]), float(py[p]), int(p) + 1))
            tracks[p].append((v + 1, len(obs[v]) - 1))
    kept = {p + 1 for p, tr in tracks.items() if len(tr) >= 2}

    sparse = root / "sparse"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    c0 = cams[0]
    if c0.model == SPHERE:
        model, params = "SPHERE", [float(v) for v in _np32(c0.params)[:3]]
    else:
        K = _np32(c0.K)
        model, params = "PINHOLE", [float(K[0, 0]), float(K[1, 1]),
                                    float(K[0, 2]), float(K[1, 2])]
    poses = [(rotmat2qvec(_np32(c.R).astype(np.float64)),
              _np32(c.t).astype(np.float64)) for c in cams]
    for v in range(n_views):
        write_image(root / "images" / f"view{v}.png",
                    np.clip(images[v], 0, 255).astype(np.uint8))
    pid = lambda p: p if p in kept else -1
    if binary:
        with open(sparse / "cameras.bin", "wb") as f:
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<iiQQ", 1, CAMERA_MODEL_IDS[model], W, H))
            f.write(struct.pack("<" + "d" * len(params), *params))
        with open(sparse / "images.bin", "wb") as f:
            f.write(struct.pack("<Q", n_views))
            for v, (q, tv) in enumerate(poses):
                f.write(struct.pack("<idddddddi", v + 1, *q, *tv, 1))
                f.write(f"view{v}.png".encode() + b"\x00")
                f.write(struct.pack("<Q", len(obs[v])))
                for x, y, p in obs[v]:
                    f.write(struct.pack("<ddq", x, y, pid(p)))
        with open(sparse / "points3D.bin", "wb") as f:
            f.write(struct.pack("<Q", len(kept)))
            for p, X in enumerate(pts):
                if p + 1 not in kept:
                    continue
                f.write(struct.pack("<QdddBBBd", p + 1, *map(float, X),
                                    128, 128, 128, 0.5))
                f.write(struct.pack("<Q", len(tracks[p])))
                for im, i2d in tracks[p]:
                    f.write(struct.pack("<ii", im, i2d))
        return
    (sparse / "cameras.txt").write_text(
        "# cameras\n" + f"1 {model} {W} {H} " + " ".join(map(str, params))
        + "\n")
    lines = ["# images"]
    for v, (q, tv) in enumerate(poses):
        lines.append(f"{v + 1} {' '.join(map(str, q))} "
                     f"{' '.join(map(str, tv))} 1 view{v}.png")
        lines.append(" ".join(f"{x} {y} {pid(p)}" for x, y, p in obs[v]))
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    lines = ["# points"]
    for p, X in enumerate(pts):
        if p + 1 in kept:
            tr = " ".join(f"{im} {i2d}" for im, i2d in tracks[p])
            lines.append(f"{p + 1} {X[0]} {X[1]} {X[2]} 128 128 128 0.5 {tr}")
    (sparse / "points3D.txt").write_text("\n".join(lines) + "\n")
