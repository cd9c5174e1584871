"""Planar-prior construction, on the host (counterpart of
acmmp_spherical_tpu/pipeline/prior.py; reference ACMMP.cpp:904-1011,
main.cpp:113-197):

1. support points: the minimum-cost pixel of every 5x5 cell with cost < 0.1;
2. Delaunay triangulation of the support points (scipy);
3. per-triangle plane fit: the SVD null space of the homogeneous 3-point
   system on the ref-camera-frame points, sign-normalised
   (GetPriorPlaneParams);
4. exact triangle rasterisation into a label mask (``cv2.fillPoly``);
5. pixels whose prior-plane depth falls outside the working range are
   unmasked (main.cpp:168-181).

numpy on the host, like the reference's host code; both camera models.
``build_planar_prior`` opens the spans ``support`` (step 1),
``triangulate`` (step 2) and ``raster`` (steps 3-5; ``utils/log.span``).
"""

from __future__ import annotations

import numpy as np

from acmmp_spherical_torch.config import PriorConfig
from acmmp_spherical_torch.core.camera import Camera, SPHERE
from acmmp_spherical_torch.io import native
from acmmp_spherical_torch.utils.log import span


def get_support_points(cost: np.ndarray, cfg: PriorConfig) -> np.ndarray:
    """(N, 2) int32 (x, y) minimum-cost support points (ACMMP.cpp:904-930)."""
    cost = np.ascontiguousarray(cost, np.float32)
    if native.available():
        return native.support_points(cost, cfg.cell_size,
                                     cfg.support_cost_threshold)
    H, W = cost.shape
    cs = cfg.cell_size
    pts = []
    for row in range(0, H, cs):
        for col in range(0, W, cs):
            block = cost[row:row + cs, col:col + cs]
            r, c = np.unravel_index(np.argmin(block), block.shape)
            if block[r, c] < cfg.support_cost_threshold:
                pts.append((col + c, row + r))
    return np.asarray(pts, np.int32).reshape(-1, 2)


def triangulate(points: np.ndarray) -> np.ndarray:
    """(T, 3, 2) triangle vertices by Delaunay (ACMMP.cpp:932-954)."""
    if len(points) < 3:
        return np.zeros((0, 3, 2), np.int32)
    from scipy.spatial import Delaunay, QhullError

    try:
        tri = Delaunay(points.astype(np.float64))
    except QhullError:
        return np.zeros((0, 3, 2), np.int32)
    return points[tri.simplices]


def _pixel_ray(cam: Camera, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """numpy ``geometry.pixel_ray`` (both camera models)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    f32 = lambda t: t.detach().cpu().numpy().astype(np.float32)
    if cam.model == SPHERE:
        W, H = (float(v) for v in f32(cam.wh))
        p = f32(cam.params)
        lon = (x - p[1]) / W * (2.0 * np.pi)
        lat = -(y - p[2]) / H * np.pi
        cl = np.cos(lat)
        return np.stack([cl * np.sin(lon), -np.sin(lat), cl * np.cos(lon)],
                        axis=-1)
    K = f32(cam.K)
    u = (x - K[0, 2]) / K[0, 0]
    v = (y - K[1, 2]) / K[1, 1]
    return np.stack([u, v, np.ones_like(u)], axis=-1)


def fit_planes(cam: Camera, depth: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Planes (T, 4) = (nx, ny, nz, w) through each triangle's 3 ref-camera
    points (GetPriorPlaneParams, ACMMP.cpp:956-989), by batched SVD."""
    if len(tris) == 0:
        return np.zeros((0, 4), np.float32)
    xs = tris[..., 0].astype(np.float32)               # (T, 3)
    ys = tris[..., 1].astype(np.float32)
    ds = depth[tris[..., 1], tris[..., 0]].astype(np.float32)
    X = _pixel_ray(cam, xs, ys) * ds[..., None]       # (T, 3, 3)
    A = np.concatenate([X, np.ones((*X.shape[:2], 1), np.float32)], axis=-1)
    _, _, vt = np.linalg.svd(A)                        # (T, 4, 4)
    n4 = vt[:, -1]
    norm = np.linalg.norm(n4[:, :3], axis=-1)
    norm = np.where(n4[:, 3] < 0, -norm, norm)
    out = np.where(norm[:, None] != 0,
                   n4 / np.where(norm == 0, 1, norm)[:, None],
                   np.array([0, 0, -1, 0], np.float32))
    return out.astype(np.float32)


def build_planar_prior(cam: Camera, depth: np.ndarray, cost: np.ndarray,
                       depth_min: float, depth_max: float, cfg: PriorConfig):
    """Returns (prior_normal (H, W, 3), prior_w (H, W), mask (H, W) bool,
    triangles (T, 3, 2)); the triangles are for the diagnostic overlay."""
    import cv2

    depth = np.asarray(depth)
    H, W = depth.shape
    with span("support"):
        points = get_support_points(np.asarray(cost), cfg)
    with span("triangulate"):
        tris = triangulate(points)
    with span("raster"):
        if len(tris):
            inb = ((tris[..., 0] >= 0) & (tris[..., 0] < W)
                   & (tris[..., 1] >= 0) & (tris[..., 1] < H)).all(axis=1)
            tris = tris[inb]
        planes = fit_planes(cam, depth, tris)

        mask_idx = np.zeros((H, W), np.int32)
        for t, tri in enumerate(tris):
            cv2.fillPoly(mask_idx, [tri.astype(np.int32)], t + 1)

        prior_normal = np.zeros((H, W, 3), np.float32)
        prior_normal[..., 2] = -1.0
        prior_w = np.zeros((H, W), np.float32)
        mask = mask_idx > 0
        if len(planes):
            lab = mask_idx[mask] - 1
            prior_normal[mask] = planes[lab, :3]
            prior_w[mask] = planes[lab, 3]
            # the prior depth -w / (n . r) must lie in the working range
            ys, xs = np.nonzero(mask)
            n = prior_normal[ys, xs]
            w = prior_w[ys, xs]
            r = _pixel_ray(cam, xs.astype(np.float32), ys.astype(np.float32))
            denom = np.sum(n * r, axis=-1)
            with np.errstate(divide="ignore", invalid="ignore"):
                d = np.where(np.abs(denom) < 1e-6, -1.0, -w / denom)
            ok = (d >= depth_min) & (d <= depth_max)
            mask[ys[~ok], xs[~ok]] = False
    return prior_normal, prior_w, mask, np.asarray(tris).reshape(-1, 3, 2)


def draw_triangulation(image_gray: np.ndarray, triangles: np.ndarray
                       ) -> np.ndarray:
    """RGB overlay of the triangles on the image, like the reference's
    triangulation.png (main.cpp:122-137)."""
    import cv2

    img = np.clip(image_gray, 0, 255).astype(np.uint8)
    rgb = np.stack([img] * 3, axis=-1)
    for tri in triangles:
        for a, b in ((0, 1), (0, 2), (1, 2)):
            cv2.line(rgb, tuple(int(v) for v in tri[a]),
                     tuple(int(v) for v in tri[b]), (255, 0, 0))
    return rgb
