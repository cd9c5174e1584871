"""Bilateral-weighted NCC on the exact path and the initial multi-view cost
aggregation (counterpart of acmmp_spherical_tpu/ops/ncc.py, pinhole).

``ref_tap_context`` precomputes everything that depends only on the
reference image (the 36 tap intensities, their bilateral weights, the centre
intensity) once per pass; ``multiview_ncc`` evaluates one plane field
against every source view by projecting each tap and sampling the source
bilinearly (reference ComputeBilateralNCC / ComputeMultiViewCostVector,
ACMMP.cu:398-563).  Plain torch: the reference's version is XLA code, not a
Pallas kernel.  It runs the exact init of every windowed or exact pass.
SPHERE views sample with the longitude wrap and the latitude clamp
(ACMMP.cu:465-474), every tap and centre valid, and weigh taps by the
angular distance ``(dlon cos(lat), dlat)`` with a radian sigma
(ACMMP.cu:436-442, 479-486).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.core import geometry as G
from acmmp_spherical_torch.core.camera import (
    Camera, Cameras, SPHERE, expand_views,
)
from acmmp_spherical_torch.ops.sampling import grid_coords, sample_bilinear


def tap_offsets(params: PatchMatchParams, device) -> torch.Tensor:
    """(T, 2) float32 (dx, dy) patch offsets, dy-major: radius
    ``patch_size // 2`` at stride ``radius_increment`` (ACMMP.cu:450-451),
    11x11 at stride 2 -> 36 taps."""
    r = params.patch_size // 2
    offs = [(i, j) for i in range(-r, r + 1, params.radius_increment)
            for j in range(-r, r + 1, params.radius_increment)]
    return torch.tensor(offs, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class RefTapContext:
    """Per-pass reference-side NCC quantities on one evaluation grid."""

    offsets: torch.Tensor    # (T, 2) float (dx, dy)
    ref_taps: torch.Tensor   # (T, H, W) reference intensity at each tap
    weights: torch.Tensor    # (T, H, W) bilateral weight of each tap
    center: torch.Tensor     # (H, W) reference intensity at the centre
    xs: torch.Tensor         # (H, W) pixel x
    ys: torch.Tensor         # (H, W) pixel y


def ref_tap_context(ref_img: torch.Tensor, ref_cam: Camera,
                    params: PatchMatchParams, *, x0: int = 0,
                    x1: Optional[int] = None) -> RefTapContext:
    """Tap intensities and bilateral weights of the reference view on the
    grid of its columns ``[x0, x1)`` (default: every column; a width tile
    of the tile-parallel pass samples the whole image at its own pixels).
    The weight keeps the reference's *linear* distances in the exponent
    (ComputeBilateralWeight, ACMMP.cu:398-403)."""
    H, W = ref_img.shape
    dev = ref_img.device
    xs, ys = grid_coords(H, (W if x1 is None else x1) - x0, dev, x0)
    offsets = tap_offsets(params, dev)
    wd, ht = ref_cam.width, ref_cam.height
    sphere = ref_cam.model == SPHERE
    center, _ = sample_bilinear(ref_img, xs, ys, wd, ht, wrap_x=sphere)
    if sphere:
        lat_c = -(ys - ref_cam.params[2]) / ht * G.PI
        scale_x = (2.0 * G.PI / wd) * torch.cos(lat_c)
        scale_y = G.PI / ht
        sigma = params.sigma_spatial * (G.PI / ht)
        two_ss = 2.0 * sigma * sigma
    else:
        two_ss = 2.0 * params.sigma_spatial * params.sigma_spatial
    two_sc = 2.0 * params.sigma_color * params.sigma_color
    taps, weights = [], []
    for dx, dy in offsets.tolist():
        pix, _ = sample_bilinear(ref_img, xs + dx, ys + dy, wd, ht,
                                 wrap_x=sphere)
        if sphere:
            ax, ay = dx * scale_x, dy * scale_y
            sdist = torch.sqrt(ax * ax + ay * ay)
        else:
            sdist = torch.sqrt(torch.tensor(dx * dx + dy * dy,
                                            dtype=torch.float32, device=dev))
        cdist = (pix - center).abs()
        weights.append(torch.exp(-sdist / two_ss - cdist / two_sc))
        taps.append(pix)
    return RefTapContext(offsets, torch.stack(taps), torch.stack(weights),
                         center, xs, ys)


def multiview_ncc(src_images: torch.Tensor, src_cams: Cameras,
                  ref_cam: Camera, normal: torch.Tensor, w: torch.Tensor,
                  ctx: RefTapContext,
                  params: PatchMatchParams) -> torch.Tensor:
    """Bilateral-NCC cost (S, H, W) of one plane field (normal (H, W, 3),
    w (H, W) on ``ctx``'s grid) against every source view of the padded
    stack (S, Hp, Wp).  Taps outside a pinhole source image drop out; a
    centre outside it, a degenerate patch or a flat one cost ``cost_max``
    (ACMMP.cu:418-433, 497-515)."""
    cost_max = params.cost_max
    xs, ys = ctx.xs, ctx.ys
    cams = expand_views(src_cams, xs.dim())
    wd, ht = cams.width, cams.height
    wrap = src_cams.model == SPHERE

    depth_c = G.depth_from_plane(ref_cam, xs, ys, normal, w)
    px, py, _ = G.project(cams, G.unproject_world(ref_cam, xs, ys, depth_c))
    valid_c = (torch.ones_like(px, dtype=torch.bool) if wrap else
               (px >= 0.0) & (px < wd) & (py >= 0.0) & (py < ht))

    zeros = torch.zeros_like(px)
    s_bw = s_r = s_rr = s_s = s_ss = s_rs = zeros
    for t, (dx, dy) in enumerate(ctx.offsets.tolist()):
        ref_pix = ctx.ref_taps[t]
        d = G.depth_from_plane(ref_cam, xs + dx, ys + dy, normal, w)
        Xt = G.unproject_world(ref_cam, xs + dx, ys + dy, d)
        px, py, _ = G.project(cams, Xt)
        src_pix, ok = sample_bilinear(src_images, px, py, wd, ht,
                                      wrap_x=wrap)
        wv = torch.where(ok, ctx.weights[t], 0.0)
        s_bw = s_bw + wv
        s_r = s_r + wv * ref_pix
        s_rr = s_rr + wv * (ref_pix * ref_pix)
        s_s = s_s + wv * src_pix
        s_ss = s_ss + wv * src_pix * src_pix
        s_rs = s_rs + wv * ref_pix * src_pix

    inv_bw = 1.0 / torch.clamp(s_bw, min=1e-12)
    m_ref = s_r * inv_bw
    m_src = s_s * inv_bw
    var_ref = s_rr * inv_bw - m_ref * m_ref
    var_src = s_ss * inv_bw - m_src * m_src
    covar = s_rs * inv_bw - m_ref * m_src
    ncc = 1.0 - covar * torch.rsqrt(torch.clamp(var_ref * var_src, min=1e-30))
    cost = torch.clamp(ncc, 0.0, cost_max)
    degenerate = (s_bw < 1e-6) | (var_ref < 1e-5) | (var_src < 1e-5)
    return torch.where(degenerate | ~valid_c, cost_max, cost)


def topk_cost_and_selection(cost_vector, src_valid, params: PatchMatchParams):
    """Mean of the best ``min(#valid views, top_k)`` costs and the views at
    or below the k-th best (reference ACMMP.cu:519-556).
    Returns (cost (H, W), selected (S, H, W) bool)."""
    cost_max = params.cost_max
    cv = torch.where(src_valid[:, None, None], cost_vector,
                     torch.full_like(cost_vector, cost_max))
    num_valid = (cv < cost_max).sum(0)
    k = torch.clamp(num_valid, max=params.top_k)
    sorted_cv = torch.sort(cv, 0).values
    csum = torch.cumsum(sorted_cv, 0)
    k_idx = torch.clamp(k - 1, 0, cv.shape[0] - 1)
    topk_sum = torch.gather(csum, 0, k_idx[None])[0]
    cost = torch.where(k > 0, topk_sum / torch.clamp(k, min=1),
                       torch.full_like(topk_sum, cost_max))
    threshold = torch.gather(sorted_cv, 0, k_idx[None])[0]
    selected = ((cv <= threshold[None]) & (k > 0)[None]
                & src_valid[:, None, None])
    return cost, selected
