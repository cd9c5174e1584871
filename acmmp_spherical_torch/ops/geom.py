"""Geometric-consistency cost on the exact path: forward-backward
reprojection error (counterpart of acmmp_spherical_tpu/ops/geom.py).

Reference ComputeGeomConsistencyCost (ACMMP.cu:646-671): project the
reference hypothesis into each source view, look up the source depth at the
C-truncated pixel, unproject it at the *float* projected coordinates,
project back into the reference view and clamp the pixel error at
``geom_max_cost``; a missing or non-positive source depth costs the maximum.
"""

from __future__ import annotations

import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.core import geometry as G
from acmmp_spherical_torch.core.camera import Camera, Cameras, expand_views
from acmmp_spherical_torch.ops.sampling import sample_nearest_trunc


def geom_consistency_cost(src_depths: torch.Tensor, src_cams: Cameras,
                          ref_cam: Camera, normal: torch.Tensor,
                          w: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                          params: PatchMatchParams) -> torch.Tensor:
    """(S, H, W) costs in [0, geom_max_cost] of the plane field (normal
    (H, W, 3), w (H, W)) at pixels (xs, ys) against the padded source depth
    stack (S, Hp, Wp)."""
    max_cost = params.geom_max_cost
    cams = expand_views(src_cams, xs.dim())
    depth = G.depth_from_plane(ref_cam, xs, ys, normal, w)
    px, py, _ = G.project(cams, G.unproject_world(ref_cam, xs, ys, depth))
    src_d, ok = sample_nearest_trunc(src_depths, px, py, cams.width,
                                     cams.height)
    bx, by, _ = G.project(ref_cam, G.unproject_world(cams, px, py, src_d))
    err = torch.sqrt((xs - bx) ** 2 + (ys - by) ** 2)
    return torch.where(ok & (src_d > 0.0), torch.clamp(err, max=max_cost),
                       max_cost)
