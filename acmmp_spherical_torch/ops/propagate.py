"""Checkerboard PatchMatch: initialisation, propagation half-steps and
refinement (counterpart of acmmp_spherical_tpu/ops/propagate.py).

Ported: the unseeded photometric pass and the seeded geometric-consistency
pass on the rectified kernel path (``rect_ncc``, with ``rect_init`` in
photometric passes, ``rect_prescreen`` off) for pinhole problems with even
frame sizes.  Every other branch raises NotImplementedError naming the
ROADMAP slice that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.core import geometry as G
from acmmp_spherical_torch.core.camera import Camera, Cameras, PINHOLE
from acmmp_spherical_torch.core.plane import PlaneState
from acmmp_spherical_torch.ops import rng as R
from acmmp_spherical_torch.ops.candidates import (
    Candidates, NEAR_REGION_INDICES, gather_candidates,
)
from acmmp_spherical_torch.ops.kernels.ncc_rect import rect_batched_ncc
from acmmp_spherical_torch.ops.ncc import topk_cost_and_selection
from acmmp_spherical_torch.ops.sampling import (
    checkerboard_coords, checkerboard_pack, checkerboard_unpack, grid_coords,
)
from acmmp_spherical_torch.ops.view_select import (
    joint_view_selection, view_selection_priors,
)


@dataclasses.dataclass(frozen=True)
class PatchMatchInputs:
    """Device-resident inputs of one problem (one reference view + sources)."""

    ref_image: torch.Tensor        # (H, W) float32 grayscale 0..255
    src_images: torch.Tensor       # (S, Hp, Wp) padded source stack
    ref_cam: Camera
    src_cams: Cameras              # batched (S)
    src_valid: torch.Tensor        # (S,) bool
    depth_range: torch.Tensor      # (2,) working (dmin, dmax)
    src_depths: Optional[torch.Tensor] = None  # (S, Hp, Wp) geometric passes
    rect: Optional[object] = None  # ops/rectify.RectContext once prepared


def _check_slice(inputs: PatchMatchInputs, params: PatchMatchParams) -> None:
    if params.geom_consistency and (
            inputs.src_depths is None
            or (inputs.rect is not None and inputs.rect.rect_sdisp is None)):
        raise NotImplementedError(
            "geometric passes without warped source disparities (the exact "
            "path): ROADMAP slice 5")
    if params.planar_prior or params.hierarchy:
        raise NotImplementedError(
            "planar-prior and hierarchy passes: ROADMAP slice 3")
    if inputs.ref_cam.model != PINHOLE or inputs.src_cams.model != PINHOLE:
        raise NotImplementedError("SPHERE cameras: ROADMAP slice 4")
    if not params.rect_ncc:
        raise NotImplementedError(
            "the exact and windowed cost paths: ROADMAP slice 5")
    if not (params.rect_init or params.geom_consistency):
        raise NotImplementedError(
            "the exact-path init evaluation: ROADMAP slice 5")
    if params.rect_prescreen:
        raise NotImplementedError(
            "rect_prescreen is not ported (off by default, measured slower)")


def prepare_inputs(inputs: PatchMatchInputs,
                   params: PatchMatchParams) -> PatchMatchInputs:
    """Attach the rectified working set (``build_rect_context``)."""
    from acmmp_spherical_torch.ops.rectify import (
        build_rect_context, host_rectifiable, rect_shape,
    )

    _check_slice(inputs, params)
    if inputs.rect is not None:
        return inputs
    H, W = inputs.ref_image.shape
    if not host_rectifiable(inputs.ref_cam, inputs.src_cams, rect_shape(H, W)):
        raise NotImplementedError(
            "problems failing host_rectifiable (windowed fallback): "
            "ROADMAP slice 5")
    rect = build_rect_context(
        inputs.ref_image, inputs.src_images, inputs.ref_cam, inputs.src_cams,
        (inputs.depth_range[0], inputs.depth_range[1]),
        comp_hw=params.rect_comp_hw, live_n=params.rect_live_n,
        warp_hw=params.rect_warp_hw, inv_attrib=params.rect_inv_attrib,
        src_depths=inputs.src_depths if params.geom_consistency else None)
    return dataclasses.replace(inputs, rect=rect)


def _depth_range(inputs: PatchMatchInputs):
    return inputs.depth_range[0], inputs.depth_range[1]


def _aggregate(cost_vec, geom_vec, weights, weight_norm, geom_weight):
    """Weighted multi-view aggregation of the photometric and, in geometric
    passes, ``geom_weight`` x the geometric costs (ACMMP.cu:1210-1228 /
    884-899)."""
    total = cost_vec if geom_vec is None else cost_vec + geom_weight * geom_vec
    return (weights * total).sum(0) / torch.clamp(weight_norm, min=1e-20)


def _batched_cost_vectors(inputs, params, normals, ws, parity=None):
    """Rect-kernel cost vectors (C, S, H, Wg) and, in geometric passes, the
    geometric ones (else None); padded views at cost_max / geom_max_cost."""
    pad = inputs.src_valid[None, :, None, None]
    if not params.geom_consistency:
        cv = rect_batched_ncc(inputs.rect, normals, ws, params, parity=parity)
        return torch.where(pad, cv, torch.full_like(cv, params.cost_max)), None
    cv, gv = rect_batched_ncc(inputs.rect, normals, ws, params, parity=parity,
                              with_geom=True)
    return (torch.where(pad, cv, torch.full_like(cv, params.cost_max)),
            torch.where(pad, gv, torch.full_like(gv, params.geom_max_cost)))


def initialize_state(inputs: PatchMatchInputs, params: PatchMatchParams,
                     key, *, seed_normal_world=None,
                     seed_depth=None) -> PlaneState:
    """The initial plane field with its kernel-evaluated cost (window
    ``rect_init_win``): random planes (reference RandomInitialization mode
    a), or in geometric passes the seed fields (world normals (H, W, 3),
    depths (H, W)) rebased into ref-cam planes (ACMMP.cu:780-793)."""
    _check_slice(inputs, params)
    H, W = inputs.ref_image.shape
    cam = inputs.ref_cam
    xs, ys = grid_coords(H, W, inputs.ref_image.device)
    if params.geom_consistency:
        if seed_normal_world is None or seed_depth is None:
            raise ValueError("a geometric pass needs seed fields")
        normal = G.normalize(G.normal_world_to_cam(cam, seed_normal_world))
        w = G.dist_to_origin(cam, xs, ys, seed_depth, normal)
    else:
        dmin, dmax = _depth_range(inputs)
        normal, w = R.random_plane_hypothesis(key, cam, xs, ys, dmin, dmax)
    p0 = dataclasses.replace(params, rect_win_w=params.rect_init_win)
    cost_vec = _batched_cost_vectors(inputs, p0, normal[None], w[None])[0][0]
    cost, selected = topk_cost_and_selection(cost_vec, inputs.src_valid,
                                             params)
    return PlaneState(normal=normal, w=w, cost=cost, selected=selected,
                      pre_cost=cost)


def _refinement_candidates(inputs, params, key, xs, ys, normal, depth,
                           dmin, dmax):
    """The 5 refinement candidates (ACMMP.cu:871-874): (rand_d, cur_n),
    (cur_d, rand_n), (rand_d, rand_n), (cur_d, pert_n), (pert_d, cur_n).
    Random depths are tile-slab sampled so the kernel's window covers them.
    Returns (normals (5, ..., 3), w (5, ...), depth_at (5, ...))."""
    cam = inputs.ref_cam
    dev = depth.device
    perturbation = params.refine_perturbation
    k_rd, k_rn, k_pn, k_pd = R.split(key, 4)

    H_, W_ = depth.shape
    slab = 1.0 / 16.0
    th, tw = -(-H_ // 8), -(-W_ // 128)
    k_slab, k_in = R.split(k_rd)
    u0 = R.uniform(k_slab, (th, tw), dev, 0.0, 1.0 - slab)
    u0 = u0.repeat_interleave(8, 0).repeat_interleave(128, 1)[:H_, :W_]
    u = u0 + R.uniform(k_in, (H_, W_), dev) * slab
    depth_rand = R.sample_depth_inv(u, dmin, dmax)
    normal_rand = R.random_normal_toward_viewer(k_rn, cam, xs, ys)

    lo = torch.maximum((1.0 - perturbation) * depth, dmin)
    hi = torch.minimum((1.0 + perturbation) * depth, dmax)
    healed = ~(hi > lo)
    lo = torch.where(healed, dmin, lo)
    hi = torch.where(healed, dmax, hi)
    depth_pert = R.sample_depth_inv(R.uniform(k_pd, (H_, W_), dev), lo, hi)
    normal_pert = R.perturbed_normal(k_pn, cam, xs, ys, normal,
                                     perturbation * torch.pi)

    cand_depths = torch.stack([depth_rand, depth, depth_rand, depth, depth_pert])
    cand_normals = torch.stack([normal, normal_rand, normal_rand, normal_pert,
                                normal])
    cand_w = G.dist_to_origin(cam, xs, ys, cand_depths, cand_normals)
    cand_depth_at = G.depth_from_plane(cam, xs, ys, cand_normals, cand_w)
    return cand_normals, cand_w, cand_depth_at


def _refinement(inputs, params, key, xs, ys, normal, w, depth, cost, sel,
                dmin, dmax, parity):
    """Ratchet through the 5 refinement candidates in order
    (PlaneHypothesisRefinement, ACMMP.cu:797-936), anchored at the
    post-acceptance running hypothesis."""
    cand_normals, cand_w, cand_depth_at = _refinement_candidates(
        inputs, params, key, xs, ys, normal, depth, dmin, dmax)
    cv5, gv5 = _batched_cost_vectors(inputs, params, cand_normals, cand_w,
                                     parity)
    can_refine = sel.weight_norm > 0.0     # reference early-out (ACMMP.cu:813)
    for i in range(5):
        c_i = _aggregate(cv5[i], None if gv5 is None else gv5[i], sel.weights,
                         sel.weight_norm, params.geom_weight_refine)
        d_i = cand_depth_at[i]
        accept = (can_refine & (d_i >= dmin) & (d_i <= dmax)
                  & (d_i < G.INVALID_DEPTH) & (c_i < cost))
        normal = torch.where(accept[..., None], cand_normals[i], normal)
        w = torch.where(accept, cand_w[i], w)
        depth = torch.where(accept, d_i, depth)
        cost = torch.where(accept, c_i, cost)
    return normal, w, depth, cost


def _halfstep_core(inputs, params, key, iteration, xs, ys, cur_normal, cur_w,
                   cur_cost, cur_selected, cands: Candidates, priors, parity):
    """Propagation + refinement update of one colour's packed half-grid.
    Returns the updated (normal, w, cost, selected)."""
    cam = inputs.ref_cam
    k_votes, k_refine = R.split(key)
    dmin, dmax = _depth_range(inputs)

    # the 8 candidates and the current plane in one C=9 evaluation
    all_n = torch.cat([cands.normal, cur_normal[None]], 0)
    all_w = torch.cat([cands.w, cur_w[None]], 0)
    cv_all, gv_all = _batched_cost_vectors(inputs, params, all_n, all_w,
                                           parity)
    cost_arrays = cv_all[:8]
    geom = [None] * 9 if gv_all is None else gv_all

    # view selection sees the photometric costs only
    sel = joint_view_selection(cost_arrays, cands.valid, priors,
                               inputs.src_valid, params, k_votes, iteration)
    final_costs = torch.stack([
        _aggregate(cost_arrays[k], geom[k], sel.weights, sel.weight_norm,
                   params.geom_weight_prop) for k in range(8)])
    final_costs = torch.where(cands.valid, final_costs,
                              torch.full_like(final_costs, float("inf")))
    no_votes = sel.weight_norm <= 0.0

    min_idx = torch.argmin(final_costs, 0)
    take = lambda a: torch.gather(a, 0, min_idx[None])[0]
    best_cost = take(final_costs)
    best_n = torch.gather(cands.normal, 0,
                          min_idx[None, ..., None].expand(1, *cur_normal.shape))[0]
    best_w = take(cands.w)
    best_valid = take(cands.valid.to(torch.int32)) > 0
    best_depth = G.depth_from_plane(cam, xs, ys, best_n, best_w)
    in_range = (best_depth >= dmin) & (best_depth <= dmax)

    cost_now0 = _aggregate(cv_all[8], geom[8], sel.weights, sel.weight_norm,
                           params.geom_weight_prop)
    cost_now0 = torch.where(no_votes, cur_cost, cost_now0)
    depth_now0 = G.depth_from_plane(cam, xs, ys, cur_normal, cur_w)

    accept = best_valid & in_range & (best_cost < cost_now0) & ~no_votes
    normal_loc = torch.where(accept[..., None], best_n, cur_normal)
    w_loc = torch.where(accept, best_w, cur_w)
    depth_loc = torch.where(accept, best_depth, depth_now0)
    cost_loc = torch.where(accept, best_cost, cost_now0)
    sel_loc = torch.where(accept[None], sel.temp_selected, cur_selected)

    normal_f, w_f, _, cost_f = _refinement(
        inputs, params, k_refine, xs, ys, normal_loc, w_loc, depth_loc,
        cost_loc, sel, dmin, dmax, parity)
    return normal_f, w_f, cost_f, sel_loc


def checkerboard_halfstep(state: PlaneState, inputs: PatchMatchInputs,
                          params: PatchMatchParams, key, iteration: int,
                          parity: int) -> PlaneState:
    """Update every pixel with ``(x + y) % 2 == parity`` (reference
    Black/RedPixelUpdate, ACMMP.cu:1327-1349) on the packed half-grid."""
    H, W = state.cost.shape
    cands = gather_candidates(state.normal, state.w, state.cost)
    near_valid = cands.valid[list(NEAR_REGION_INDICES)]
    priors = view_selection_priors(state.selected, near_valid, params)

    P = lambda a: checkerboard_pack(a, parity)
    Pc = lambda a: checkerboard_pack(a.movedim(-1, 0), parity).movedim(0, -1)
    xs_p, ys_p = checkerboard_coords(H, W, parity, state.cost.device)
    cands_p = Candidates(normal=Pc(cands.normal), w=P(cands.w),
                         valid=P(cands.valid))
    normal_f, w_f, cost_f, sel_f = _halfstep_core(
        inputs, params, key, iteration, xs_p, ys_p, Pc(state.normal),
        P(state.w), P(state.cost), P(state.selected), cands_p, P(priors),
        parity)
    normal = checkerboard_unpack(normal_f.movedim(-1, 0),
                                 state.normal.movedim(-1, 0), parity)
    return PlaneState(
        normal=normal.movedim(0, -1).contiguous(),
        w=checkerboard_unpack(w_f, state.w, parity),
        cost=checkerboard_unpack(cost_f, state.cost, parity),
        selected=checkerboard_unpack(sel_f, state.selected, parity),
        pre_cost=state.pre_cost)


def extract_depth_and_normal(state: PlaneState, cam: Camera):
    """(depth (H, W), world normal (H, W, 3)) of the plane field
    (reference GetDepthandNormal, ACMMP.cu:1351-1364)."""
    H, W = state.w.shape
    xs, ys = grid_coords(H, W, state.w.device)
    depth = G.depth_from_plane(cam, xs, ys, state.normal, state.w)
    return depth, G.normal_cam_to_world(cam, state.normal)
