"""Multi-view depth-map fusion into a point cloud (counterpart of
acmmp_spherical_tpu/ops/fusion.py), plain torch on the tensors' device.

The semantics of the fusion path the reference runs (``SimpleFusionKernel``
/ ``RunFusionCuda``, ACMMP.cu:1664-1814): per reference pixel, project the 3D
point into every source view, count the sources that agree (reprojection
< 1 px, relative depth < 1%, normal angle < 0.149 rad), and emit the
averaged point, normal and colour where at least ``min_consistent`` views
(the reference view included) agree.  Pixels are independent; each view
yields an (H*W) buffer with validity flags, compacted on the host.  As in
the JAX package, colours are sampled at the exact pixel and the output is
true RGB.
"""

from __future__ import annotations

import numpy as np
import torch

from acmmp_spherical_torch.config import FusionParams
from acmmp_spherical_torch.core import geometry as G
from acmmp_spherical_torch.core.camera import Cameras, camera_index
from acmmp_spherical_torch.ops.sampling import grid_coords


def _angle_between(n1, n2):
    """Angle between unit vectors, NaN-safe (reference GetAngle,
    ACMMP.cpp:352-361)."""
    return torch.arccos(torch.clamp((n1 * n2).sum(-1), -1.0, 1.0))


def _reference_frame(depths, normals, colors, cams, ref_idx):
    V, Hp, Wp = depths.shape
    ref_cam = camera_index(cams, ref_idx)
    xs, ys = grid_coords(Hp, Wp, depths.device)
    in_ref = (xs < ref_cam.width) & (ys < ref_cam.height)
    ref_depth = depths[ref_idx]
    has_depth = (ref_depth > 0.0) & in_ref
    X = G.unproject_world(ref_cam, xs, ys, ref_depth)
    return ref_cam, xs, ys, has_depth, X


def _source_lookup(depths, normals, cams, src_i, X):
    """Project X into source ``src_i`` (-1: none) and read its depth and
    normal at the rounded pixel; returns (ok, Xs, src_n, pd, xi, yi, si)."""
    V, Hp, Wp = depths.shape
    cam = camera_index(cams, max(src_i, 0))
    px, py, pd = G.project(cam, X)
    # round half up to the integer pixel (ACMMP.cu:1723-1724)
    xi = torch.floor(px + 0.5).to(torch.int64)
    yi = torch.floor(py + 0.5).to(torch.int64)
    ok = ((xi >= 0) & (xi < cam.width.to(torch.int64))
          & (yi >= 0) & (yi < cam.height.to(torch.int64)) & (src_i >= 0))
    xi = torch.clamp(xi, 0, Wp - 1)
    yi = torch.clamp(yi, 0, Hp - 1)
    si = max(src_i, 0)
    src_d = depths[si][yi, xi]
    ok = ok & (src_d > 0.0)
    # unproject the integer source pixel (ACMMP.cu:1735)
    Xs = G.unproject_world(cam, xi.float(), yi.float(), src_d)
    return ok, Xs, normals[si][yi, xi], pd, src_d, xi, yi, si


def fuse_reference_view(depths, normals, colors, cams: Cameras, ref_idx: int,
                        src_indices, params: FusionParams):
    """Fuse one reference view.  ``depths`` (V, Hp, Wp), ``normals`` and
    ``colors`` (V, Hp, Wp, 3) of every view (padded), ``cams`` view-batched,
    ``src_indices`` (K,) indices into the view axis, -1 for none.  Returns
    (points, normals, colors, valid), all (Hp*Wp, ...), ``valid`` marking
    the emitted points."""
    ref_cam, xs, ys, has_depth, X = _reference_frame(depths, normals, colors,
                                                     cams, ref_idx)
    ref_normal = normals[ref_idx]
    zero = torch.zeros((), device=depths.device)
    n_con = torch.zeros_like(xs)
    sum_X = torch.zeros_like(X)
    sum_n = torch.zeros_like(X)
    sum_c = torch.zeros_like(X)
    for src_i in [int(i) for i in src_indices]:
        ok, Xs, src_n, pd, src_d, xi, yi, si = _source_lookup(
            depths, normals, cams, src_i, X)
        bx, by, _ = G.project(ref_cam, Xs)
        reproj = torch.sqrt((xs - bx) ** 2 + (ys - by) ** 2)
        rel_dd = (pd - src_d).abs() / torch.clamp(src_d, min=1e-20)
        consistent = (ok & (reproj < params.max_reproj_error)
                      & (rel_dd < params.max_rel_depth_diff)
                      & (_angle_between(ref_normal, src_n)
                         < params.max_normal_angle))
        cm = consistent[..., None]
        n_con = n_con + consistent.float()
        sum_X = sum_X + torch.where(cm, Xs, zero)
        sum_n = sum_n + torch.where(cm, src_n, zero)
        sum_c = sum_c + torch.where(cm, colors[si][yi, xi], zero)
    count = 1.0 + n_con                  # the reference view counts itself
    pt = (X + sum_X) / count[..., None]
    nm = G.normalize((ref_normal + sum_n) / count[..., None])
    cl = (colors[ref_idx] + sum_c) / count[..., None]
    valid = has_depth & (count >= params.min_consistent)
    return (pt.reshape(-1, 3), nm.reshape(-1, 3), cl.reshape(-1, 3),
            valid.reshape(-1))


def fuse_reference_view_dynamic(depths, normals, colors, cams: Cameras,
                                ref_idx: int, src_indices,
                                params: FusionParams):
    """The reference's CPU fusion variant (``RunFusion``, main.cpp:240-390),
    an alternative mode: reprojection < 2 px, normal angle < 0.174533 rad,
    relative depth against the reference depth; accepted when ``n >= 1``
    sources agree and ``sum(exp(-(err + 200 rel_dd + 10 angle)))`` exceeds
    ``0.3 n``; emits the reference point (no averaging)."""
    ref_cam, xs, ys, has_depth, X = _reference_frame(depths, normals, colors,
                                                     cams, ref_idx)
    ref_depth = depths[ref_idx]
    ref_normal = normals[ref_idx]
    num = torch.zeros_like(xs)
    dyn = torch.zeros_like(xs)
    for src_i in [int(i) for i in src_indices]:
        ok, Xs, src_n, pd, _, _, _, _ = _source_lookup(depths, normals, cams,
                                                       src_i, X)
        bx, by, _ = G.project(ref_cam, Xs)
        reproj = torch.sqrt((xs - bx) ** 2 + (ys - by) ** 2)
        rel_dd = (pd - ref_depth).abs() / torch.clamp(ref_depth, min=1e-20)
        angle = _angle_between(ref_normal, src_n)
        consistent = ok & (reproj < 2.0) & (rel_dd < 0.01) & (angle < 0.174533)
        num = num + consistent.float()
        dyn = dyn + torch.where(
            consistent, torch.exp(-(reproj + 200.0 * rel_dd + 10.0 * angle)),
            torch.zeros_like(reproj))
    valid = has_depth & (num >= 1) & (dyn > 0.3 * num)
    return (X.reshape(-1, 3), ref_normal.reshape(-1, 3),
            colors[ref_idx].reshape(-1, 3), valid.reshape(-1))


def fuse_all_views(depths, normals, colors, cams: Cameras,
                   problems_src_indices: np.ndarray, params: FusionParams):
    """Fuse every view in turn (reference ACMMP.cu:2023-2084) and compact
    the valid points on the host.  ``problems_src_indices`` (V, K) int,
    -1 padded.  Returns numpy (N, 3) points, normals, colours."""
    all_p, all_n, all_c = [], [], []
    for i in range(depths.shape[0]):
        p, n, c, v = fuse_reference_view(depths, normals, colors, cams, i,
                                         problems_src_indices[i], params)
        all_p.append(p[v].cpu().numpy())
        all_n.append(n[v].cpu().numpy())
        all_c.append(c[v].cpu().numpy())
    cat = lambda a: np.concatenate(a) if a else np.zeros((0, 3), np.float32)
    return cat(all_p), cat(all_n), cat(all_c)
