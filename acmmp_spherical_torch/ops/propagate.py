"""Checkerboard PatchMatch: initialisation, propagation half-steps and
refinement (counterpart of acmmp_spherical_tpu/ops/propagate.py).

Ported for pinhole problems: the unseeded photometric pass and the seeded
geometric-consistency pass on each of the three cost paths -- the rectified
kernel path (``rect_ncc``; ``rect_prescreen`` off), the windowed kernel path
(``fast_ncc``) and the exact path (neither) -- on even frames through the
packed half-grid and on odd frames through the full-grid fallback with a
parity-masked commit.  Planar-prior, hierarchy and SPHERE passes raise
NotImplementedError naming the ROADMAP slice that brings them.
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
from acmmp_spherical_torch.ops.geom import geom_consistency_cost
from acmmp_spherical_torch.ops.kernels.ncc_rect import rect_batched_ncc
from acmmp_spherical_torch.ops.kernels.ncc_window import (
    TILE_H, TILE_W, windowed_multiview_ncc,
)
from acmmp_spherical_torch.ops.ncc import (
    RefTapContext, multiview_ncc, ref_tap_context, topk_cost_and_selection,
)
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
    if params.planar_prior or params.hierarchy:
        raise NotImplementedError(
            "planar-prior and hierarchy passes: ROADMAP slice 3")
    if inputs.ref_cam.model != PINHOLE or inputs.src_cams.model != PINHOLE:
        raise NotImplementedError("SPHERE cameras: ROADMAP slice 4")
    if params.rect_prescreen:
        raise NotImplementedError(
            "rect_prescreen is not ported (off by default, measured slower)")


def prepare_inputs(inputs: PatchMatchInputs,
                   params: PatchMatchParams) -> PatchMatchInputs:
    """Attach the rectified working set (``build_rect_context``) when
    ``params.rect_ncc``; the windowed and exact paths need nothing more."""
    from acmmp_spherical_torch.ops.rectify import (
        build_rect_context, host_rectifiable, rect_shape,
    )

    _check_slice(inputs, params)
    if not params.rect_ncc or inputs.rect is not None:
        return inputs
    H, W = inputs.ref_image.shape
    if not host_rectifiable(inputs.ref_cam, inputs.src_cams, rect_shape(H, W)):
        raise ValueError(
            "the problem fails host_rectifiable: run it with rect_ncc=False "
            "(the windowed or exact path), as the pass runner does")
    rect = build_rect_context(
        inputs.ref_image, inputs.src_images, inputs.ref_cam, inputs.src_cams,
        (inputs.depth_range[0], inputs.depth_range[1]),
        comp_hw=params.rect_comp_hw, live_n=params.rect_live_n,
        warp_hw=params.rect_warp_hw, inv_attrib=params.rect_inv_attrib,
        src_depths=inputs.src_depths if params.geom_consistency else None)
    return dataclasses.replace(inputs, rect=rect)


def _depth_range(inputs: PatchMatchInputs):
    return inputs.depth_range[0], inputs.depth_range[1]


def _use_rect(inputs: PatchMatchInputs, params: PatchMatchParams) -> bool:
    """The rectified kernel path; geometric passes also need the warped
    source disparities in the context."""
    if not (params.rect_ncc and inputs.rect is not None):
        return False
    return not params.geom_consistency or inputs.rect.rect_sdisp is not None


def needs_tap_context(inputs, params) -> bool:
    """Whether any cost of the pass leaves the rectified path (and so needs
    the reference tap context): the init of an unseeded pass without
    ``rect_init``, or everything when the rectified path is off."""
    return not (_use_rect(inputs, params)
                and (params.rect_init or params.geom_consistency))


def _aggregate(cost_vec, geom_vec, weights, weight_norm, geom_weight):
    """Weighted multi-view aggregation of the photometric and, in geometric
    passes, ``geom_weight`` x the geometric costs (ACMMP.cu:1210-1228 /
    884-899)."""
    total = cost_vec if geom_vec is None else cost_vec + geom_weight * geom_vec
    return (weights * total).sum(0) / torch.clamp(weight_norm, min=1e-20)


def _masked(inputs, cv, fill):
    return torch.where(inputs.src_valid[:, None, None], cv,
                       torch.full_like(cv, fill))


def _fast_cost_vectors(inputs, ctx: RefTapContext, normals, ws, params, *,
                       with_geom: bool = False):
    """One windowed evaluation of C fields (normals (C, H, W, 3), ws
    (C, H, W)) on a grid edge-padded to multiples of the 8x128 tile,
    cropped back: (C, S, H, W) costs, with ``with_geom`` (cv, gv)."""
    H, W = ws.shape[1:]
    ph, pw = (-H) % TILE_H, (-W) % TILE_W
    if ph or pw:
        pad = lambda a: torch.nn.functional.pad(
            a.reshape(1, -1, H, W), (0, pw, 0, ph), mode="replicate"
        ).reshape(*a.shape[:-2], H + ph, W + pw)
        ctx = RefTapContext(ctx.offsets, pad(ctx.ref_taps), pad(ctx.weights),
                            pad(ctx.center), pad(ctx.xs), pad(ctx.ys))
        normals = pad(normals.movedim(-1, 1)).movedim(1, -1)
        ws = pad(ws)
    out = windowed_multiview_ncc(
        inputs.src_images, inputs.src_cams, inputs.ref_cam, normals, ws, ctx,
        params, inputs.src_depths if with_geom else None)
    crop = lambda a: a[..., :H, :W]
    return (crop(out[0]), crop(out[1])) if with_geom else crop(out)


def _batched_cost_vectors(inputs, ctx, params, normals, ws, *, parity=None):
    """Cost vectors (C, S, H, Wg) of C candidate fields and, in geometric
    passes, the geometric ones (else None); padded views at cost_max /
    geom_max_cost.  The kernel paths evaluate the batch in one kernel call
    -- the rectified one (``parity`` picks the half-grid's map) or the
    windowed one (``fast_ncc``); the exact path evaluates one field after
    the other."""
    pad = inputs.src_valid[None, :, None, None]
    mask = lambda a, fill: torch.where(pad, a, torch.full_like(a, fill))
    if _use_rect(inputs, params):
        if not params.geom_consistency:
            cv = rect_batched_ncc(inputs.rect, normals, ws, params,
                                  parity=parity)
            return mask(cv, params.cost_max), None
        cv, gv = rect_batched_ncc(inputs.rect, normals, ws, params,
                                  parity=parity, with_geom=True)
        return mask(cv, params.cost_max), mask(gv, params.geom_max_cost)
    geom_on = params.geom_consistency and inputs.src_depths is not None
    if params.fast_ncc:
        out = _fast_cost_vectors(inputs, ctx, normals, ws, params,
                                 with_geom=geom_on)
        cv, gv = out if geom_on else (out, None)
    else:
        cv = torch.stack([multiview_ncc(
            inputs.src_images, inputs.src_cams, inputs.ref_cam, normals[i],
            ws[i], ctx, params) for i in range(ws.shape[0])])
        gv = None if not geom_on else torch.stack([geom_consistency_cost(
            inputs.src_depths, inputs.src_cams, inputs.ref_cam, normals[i],
            ws[i], ctx.xs, ctx.ys, params) for i in range(ws.shape[0])])
    return (mask(cv, params.cost_max),
            None if gv is None else mask(gv, params.geom_max_cost))


def initialize_state(inputs: PatchMatchInputs, params: PatchMatchParams,
                     key, *, seed_normal_world=None, seed_depth=None,
                     ctx: Optional[RefTapContext] = None) -> PlaneState:
    """The initial plane field and its cost: random planes (reference
    RandomInitialization mode a), or in geometric passes the seed fields
    (world normals (H, W, 3), depths (H, W)) rebased into ref-cam planes
    (ACMMP.cu:780-793).  The cost comes from the rectified kernel (window
    ``rect_init_win``) when it covers the field -- ``rect_init``, or a seeded
    field -- and from the exact path otherwise (``ctx`` is built when not
    given)."""
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
    if not needs_tap_context(inputs, params):
        p0 = dataclasses.replace(params, rect_win_w=params.rect_init_win)
        cost_vec = _batched_cost_vectors(inputs, None, p0, normal[None],
                                         w[None])[0][0]
    else:
        if ctx is None:
            ctx = ref_tap_context(inputs.ref_image, cam, params)
        cost_vec = _masked(inputs, multiview_ncc(
            inputs.src_images, inputs.src_cams, cam, normal, w, ctx, params),
            params.cost_max)
    cost, selected = topk_cost_and_selection(cost_vec, inputs.src_valid,
                                             params)
    return PlaneState(normal=normal, w=w, cost=cost, selected=selected,
                      pre_cost=cost)


def _refinement_candidates(inputs, params, key, xs, ys, normal, depth,
                           dmin, dmax):
    """The 5 refinement candidates (ACMMP.cu:871-874): (rand_d, cur_n),
    (cur_d, rand_n), (rand_d, rand_n), (cur_d, pert_n), (pert_d, cur_n).
    On the kernel paths the random depths are tile-slab sampled so the
    kernels' windows cover them; on the exact path they are i.i.d.
    Returns (normals (5, ..., 3), w (5, ...), depth_at (5, ...))."""
    cam = inputs.ref_cam
    dev = depth.device
    perturbation = params.refine_perturbation
    k_rd, k_rn, k_pn, k_pd = R.split(key, 4)

    H_, W_ = depth.shape
    if params.fast_ncc or _use_rect(inputs, params):
        slab = 1.0 / 16.0
        th, tw = -(-H_ // 8), -(-W_ // 128)
        k_slab, k_in = R.split(k_rd)
        u0 = R.uniform(k_slab, (th, tw), dev, 0.0, 1.0 - slab)
        u0 = u0.repeat_interleave(8, 0).repeat_interleave(128, 1)[:H_, :W_]
        u = u0 + R.uniform(k_in, (H_, W_), dev) * slab
    else:
        u = R.uniform(k_rd, (H_, W_), dev)
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

    cand_depths = torch.stack([depth_rand, depth, depth_rand, depth,
                               depth_pert])
    cand_normals = torch.stack([normal, normal_rand, normal_rand, normal_pert,
                                normal])
    cand_w = G.dist_to_origin(cam, xs, ys, cand_depths, cand_normals)
    cand_depth_at = G.depth_from_plane(cam, xs, ys, cand_normals, cand_w)
    return cand_normals, cand_w, cand_depth_at


def _refinement(inputs, ctx, params, key, xs, ys, normal, w, depth, cost,
                sel, dmin, dmax, parity):
    """Ratchet through the 5 refinement candidates in order
    (PlaneHypothesisRefinement, ACMMP.cu:797-936), anchored at the
    post-acceptance running hypothesis."""
    cand_normals, cand_w, cand_depth_at = _refinement_candidates(
        inputs, params, key, xs, ys, normal, depth, dmin, dmax)
    cv5, gv5 = _batched_cost_vectors(inputs, ctx, params, cand_normals,
                                     cand_w, parity=parity)
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


def _halfstep_core(inputs, ctx, params, key, iteration, xs, ys, cur_normal,
                   cur_w, cur_cost, cur_selected, cands: Candidates, priors,
                   parity):
    """Propagation + refinement update of every position of one grid (the
    packed half-grid, or the full grid of the odd-frame fallback).
    Returns the updated (normal, w, cost, selected)."""
    cam = inputs.ref_cam
    k_votes, k_refine = R.split(key)
    dmin, dmax = _depth_range(inputs)

    # the 8 candidates and the current plane in one C=9 evaluation
    all_n = torch.cat([cands.normal, cur_normal[None]], 0)
    all_w = torch.cat([cands.w, cur_w[None]], 0)
    cv_all, gv_all = _batched_cost_vectors(inputs, ctx, params, all_n, all_w,
                                           parity=parity)
    cost_arrays = cv_all[:8]
    geom = [None] * 8 if gv_all is None else gv_all[:8]
    now_vecs = (cv_all[8], None if gv_all is None else gv_all[8])

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
    best_n = torch.gather(
        cands.normal, 0,
        min_idx[None, ..., None].expand(1, *cur_normal.shape))[0]
    best_w = take(cands.w)
    best_valid = take(cands.valid.to(torch.int32)) > 0
    best_depth = G.depth_from_plane(cam, xs, ys, best_n, best_w)
    in_range = (best_depth >= dmin) & (best_depth <= dmax)

    cost_now0 = _aggregate(now_vecs[0], now_vecs[1], sel.weights,
                           sel.weight_norm, params.geom_weight_prop)
    cost_now0 = torch.where(no_votes, cur_cost, cost_now0)
    depth_now0 = G.depth_from_plane(cam, xs, ys, cur_normal, cur_w)

    accept = best_valid & in_range & (best_cost < cost_now0) & ~no_votes
    normal_loc = torch.where(accept[..., None], best_n, cur_normal)
    w_loc = torch.where(accept, best_w, cur_w)
    depth_loc = torch.where(accept, best_depth, depth_now0)
    cost_loc = torch.where(accept, best_cost, cost_now0)
    sel_loc = torch.where(accept[None], sel.temp_selected, cur_selected)

    normal_f, w_f, _, cost_f = _refinement(
        inputs, ctx, params, k_refine, xs, ys, normal_loc, w_loc, depth_loc,
        cost_loc, sel, dmin, dmax, parity)
    return normal_f, w_f, cost_f, sel_loc


def checkerboard_halfstep(state: PlaneState, inputs: PatchMatchInputs,
                          params: PatchMatchParams, key, iteration: int,
                          parity: int, *,
                          ctx: Optional[RefTapContext] = None) -> PlaneState:
    """Update every pixel with ``(x + y) % 2 == parity`` (reference
    Black/RedPixelUpdate, ACMMP.cu:1327-1349).  Even frames evaluate the
    packed half-grid (the rectified path on that colour's map); odd frames,
    or a rectified context without parity maps, evaluate the full grid and
    commit through a parity mask.  ``ctx`` (full grid) is built when the
    costs leave the rectified path and it is not given."""
    H, W = state.cost.shape
    dev = state.cost.device
    use_rect = _use_rect(inputs, params)
    if ctx is None and not use_rect:
        ctx = ref_tap_context(inputs.ref_image, inputs.ref_cam, params)
    cands = gather_candidates(state.normal, state.w, state.cost)
    near_valid = cands.valid[list(NEAR_REGION_INDICES)]
    priors = view_selection_priors(state.selected, near_valid, params)

    packed_ok = H % 2 == 0 and W % 2 == 0 and (
        not use_rect or len(inputs.rect.maps) == 3)
    if not packed_ok:
        xs, ys = grid_coords(H, W, dev)
        normal_f, w_f, cost_f, sel_f = _halfstep_core(
            inputs, ctx, params, key, iteration, xs, ys, state.normal,
            state.w, state.cost, state.selected, cands, priors, None)
        par = ((xs.to(torch.int64) + ys.to(torch.int64)) % 2) == parity
        return PlaneState(
            normal=torch.where(par[..., None], normal_f, state.normal),
            w=torch.where(par, w_f, state.w),
            cost=torch.where(par, cost_f, state.cost),
            selected=torch.where(par[None], sel_f, state.selected),
            pre_cost=state.pre_cost)

    P = lambda a: checkerboard_pack(a, parity)
    Pc = lambda a: checkerboard_pack(a.movedim(-1, 0), parity).movedim(0, -1)
    xs_p, ys_p = checkerboard_coords(H, W, parity, dev)
    ctx_p = None if ctx is None else RefTapContext(
        ctx.offsets, P(ctx.ref_taps), P(ctx.weights), P(ctx.center), xs_p,
        ys_p)
    cands_p = Candidates(normal=Pc(cands.normal), w=P(cands.w),
                         valid=P(cands.valid))
    normal_f, w_f, cost_f, sel_f = _halfstep_core(
        inputs, ctx_p, params, key, iteration, xs_p, ys_p, Pc(state.normal),
        P(state.w), P(state.cost), P(state.selected), cands_p, P(priors),
        parity if use_rect else None)
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
