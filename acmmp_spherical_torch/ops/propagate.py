"""Checkerboard PatchMatch: initialisation, propagation half-steps and
refinement (counterpart of acmmp_spherical_tpu/ops/propagate.py).

The photometric, hierarchy, planar-prior and geometric-consistency passes
on each cost path -- the rectified kernel path (``rect_ncc``;
``rect_prescreen`` off), the windowed kernel path (``fast_ncc``, pinhole
only) and the exact path (neither) -- on even frames through the packed
half-grid and on odd frames through the full-grid fallback with a
parity-masked commit.  SPHERE problems take the pole-rotated rectified path
(``ops/sphere_rect``) or the exact path, and wrap x around the longitude
seam in the candidate, view-selection and filter stencils; a problem that
mixes SPHERE and PINHOLE cameras stays on the exact path.

The reference's documented intended-semantics fixes carry over (see its
module docstring): the running hypothesis starts at the centre pixel,
prior-mode acceptance updates it coherently, invalid candidates cost +inf,
and the prior init is the reachable branch with the world->cam rebase.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.core import geometry as G
from acmmp_spherical_torch.core.camera import (
    Camera, Cameras, PINHOLE, SPHERE,
)
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
from acmmp_spherical_torch.ops.sphere_rect import (
    build_sphere_rect_context, sphere_batched_ncc, sphere_rectifiable,
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
    prior_normal: Optional[torch.Tensor] = None  # (H, W, 3) planar prior
    prior_w: Optional[torch.Tensor] = None       # (H, W)
    prior_mask: Optional[torch.Tensor] = None    # (H, W) bool
    rect: Optional[object] = None  # ops/rectify.RectContext once prepared


def _check_params(params: PatchMatchParams) -> None:
    if params.rect_prescreen:
        raise NotImplementedError(
            "rect_prescreen is not ported (off by default, measured slower)")


def _model(inputs: PatchMatchInputs):
    """The problem's camera model, or None when it mixes models."""
    m = inputs.ref_cam.model
    return m if inputs.src_cams.model == m else None


def prepare_inputs(inputs: PatchMatchInputs,
                   params: PatchMatchParams) -> PatchMatchInputs:
    """Attach the rectified working set when ``params.rect_ncc``
    (``build_rect_context`` for pinhole problems,
    ``build_sphere_rect_context`` for SPHERE ones); the windowed and exact
    paths, and mixed-model problems, need nothing more."""
    from acmmp_spherical_torch.ops.rectify import (
        build_rect_context, host_rectifiable, rect_shape,
    )

    _check_params(params)
    if not params.rect_ncc or inputs.rect is not None or _model(inputs) is None:
        return inputs
    src_depths = inputs.src_depths if params.geom_consistency else None
    if _model(inputs) == SPHERE:
        if not sphere_rectifiable(inputs.ref_cam, inputs.src_cams):
            raise ValueError(
                "the problem fails sphere_rectifiable: run it with "
                "rect_ncc=False (the exact path), as the pass runner does")
        return dataclasses.replace(inputs, rect=build_sphere_rect_context(
            inputs.ref_image, inputs.src_images, inputs.ref_cam,
            inputs.src_cams, _depth_range(inputs), src_depths=src_depths,
            live_n=params.sphere_live_n))
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
        src_depths=src_depths)
    return dataclasses.replace(inputs, rect=rect)


def _depth_range(inputs: PatchMatchInputs):
    return inputs.depth_range[0], inputs.depth_range[1]


def _use_rect(inputs: PatchMatchInputs, params: PatchMatchParams) -> bool:
    """The rectified kernel path (pinhole or pole-rotated SPHERE);
    geometric passes also need the warped source disparities in the
    context."""
    if not (params.rect_ncc and inputs.rect is not None
            and _model(inputs) is not None):
        return False
    return not params.geom_consistency or inputs.rect.rect_sdisp is not None


def _use_fast(inputs: PatchMatchInputs, params: PatchMatchParams) -> bool:
    """The windowed kernel path: pinhole problems with ``fast_ncc``."""
    return params.fast_ncc and _model(inputs) == PINHOLE


def _seeded(params: PatchMatchParams) -> bool:
    """Passes whose init field is a previous pass's (geometric, hierarchy)
    or a perturbed prior: tile-smooth, so the rectified kernel evaluates it
    under the ordinary window guarantees."""
    return params.geom_consistency or params.hierarchy or params.planar_prior


def needs_tap_context(inputs, params) -> bool:
    """Whether any cost of the pass leaves the rectified path (and so needs
    the reference tap context): the init of an unseeded pass without
    ``rect_init``, or everything when the rectified path is off."""
    return not (_use_rect(inputs, params)
                and (params.rect_init or _seeded(params)))


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


def _batched_cost_vectors(inputs, ctx, params, normals, ws, *, exact_idx=(),
                          parity=None):
    """Cost vectors (C, S, H, Wg) of C candidate fields and, in geometric
    passes, the geometric ones (else None); padded views at cost_max /
    geom_max_cost.  The kernel paths evaluate the batch in one kernel call
    -- the rectified one (``parity`` picks the half-grid's map) or the
    windowed one (``fast_ncc``); the exact path evaluates one field after
    the other.  Off the rectified path, the fields in ``exact_idx`` take
    the exact path whatever ``fast_ncc`` says (the reference's refinement
    asks for it only there, never on the rectified path)."""
    pad = inputs.src_valid[None, :, None, None]
    mask = lambda a, fill: torch.where(pad, a, torch.full_like(a, fill))
    if _use_rect(inputs, params):
        batched = (sphere_batched_ncc if _model(inputs) == SPHERE
                   else rect_batched_ncc)
        out = batched(inputs.rect, normals, ws, params, parity=parity,
                      with_geom=params.geom_consistency)
        cv, gv = out if params.geom_consistency else (out, None)
        return (mask(cv, params.cost_max),
                None if gv is None else mask(gv, params.geom_max_cost))
    geom_on = params.geom_consistency and inputs.src_depths is not None
    C = ws.shape[0]
    cvs, gvs = [None] * C, [None] * C
    fast = ([i for i in range(C) if i not in exact_idx]
            if _use_fast(inputs, params) else [])
    if fast:
        sub = (lambda a: a) if len(fast) == C else (lambda a: a[fast])
        out = _fast_cost_vectors(inputs, ctx, sub(normals), sub(ws), params,
                                 with_geom=geom_on)
        cv, gv = out if geom_on else (out, None)
        for j, i in enumerate(fast):
            cvs[i] = cv[j]
            gvs[i] = None if gv is None else gv[j]
    for i in range(C):
        if cvs[i] is None:
            cvs[i] = multiview_ncc(inputs.src_images, inputs.src_cams,
                                   inputs.ref_cam, normals[i], ws[i], ctx,
                                   params)
            if geom_on:
                gvs[i] = geom_consistency_cost(
                    inputs.src_depths, inputs.src_cams, inputs.ref_cam,
                    normals[i], ws[i], ctx.xs, ctx.ys, params)
    return (mask(torch.stack(cvs), params.cost_max),
            mask(torch.stack(gvs), params.geom_max_cost) if geom_on else None)


def _prior_weight(depth, normal, prior_depth, prior_normal, params, dmin,
                  dmax):
    """Planar-prior plausibility (ACMMP.cu:1249-1276, 917-919)."""
    depth_sigma = (dmax - dmin) / params.prior_depth_sigma_div
    two_ds2 = 2.0 * depth_sigma * depth_sigma
    angle_sigma = params.prior_angle_sigma
    two_as2 = 2.0 * angle_sigma * angle_sigma
    dd = depth - prior_depth
    cos_a = torch.clamp((normal * prior_normal).sum(-1), -1.0, 1.0)
    da = torch.arccos(cos_a)
    return (params.prior_gamma
            + torch.exp(-dd * dd / two_ds2) * torch.exp(-da * da / two_as2))


def _restricted(cost, prior_wt, params):
    return torch.exp(-cost * cost / params.prior_beta) * prior_wt


def initialize_state(inputs: PatchMatchInputs, params: PatchMatchParams,
                     key, *, prev_state: Optional[PlaneState] = None,
                     seed_normal_world=None, seed_depth=None,
                     ctx: Optional[RefTapContext] = None) -> PlaneState:
    """The initial plane field and its cost (reference RandomInitialization):
    random planes (mode a); in a planar-prior pass (``prev_state`` and the
    prior fields of ``inputs``) the prior plane perturbed by up to 3 x
    ``prior_init_perturbation`` where the prior is masked and the previous
    cost is poor, else the previous plane (mode b, ACMMP.cu:686-710); in
    geometric and hierarchy passes the seed fields (world normals
    (H, W, 3), depths (H, W)) rebased into ref-cam planes (ACMMP.cu:780-793).
    The cost comes from the rectified kernel (window ``rect_init_win``) when
    it covers the field -- ``rect_init``, or a seeded field -- and from the
    exact path otherwise (``ctx`` is built when not given)."""
    _check_params(params)
    H, W = inputs.ref_image.shape
    cam = inputs.ref_cam
    dev = inputs.ref_image.device
    xs, ys = grid_coords(H, W, dev)
    if params.planar_prior:
        if prev_state is None or inputs.prior_mask is None:
            raise ValueError(
                "a planar-prior pass needs prev_state and prior fields")
        k1, k2, _ = R.split(key, 3)
        pert = params.prior_init_perturbation
        w_prior = inputs.prior_w
        w_lo = (1.0 - 3.0 * pert) * w_prior
        w_hi = (1.0 + 3.0 * pert) * w_prior
        u = R.uniform(k1, tuple(w_prior.shape), dev)
        w_pert = w_lo + u * (w_hi - w_lo)
        n_pert = R.perturbed_normal(k2, cam, xs, ys, inputs.prior_normal,
                                    3.0 * pert * torch.pi)
        use_prior = inputs.prior_mask & (prev_state.cost >= 0.1)
        normal = torch.where(use_prior[..., None], n_pert, prev_state.normal)
        w = torch.where(use_prior, w_pert, prev_state.w)
    elif params.geom_consistency or params.hierarchy:
        if seed_normal_world is None or seed_depth is None:
            raise ValueError("a geometric or hierarchy pass needs seed fields")
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


def _slab_uniform(k, shape, dev):
    """Tile-slab uniforms: every (8, 128) tile draws from one slab of width
    1/16 (chosen uniformly), so a random-depth field is tile-smooth and the
    kernels' windows cover it; the per-pixel marginal stays uniform."""
    H_, W_ = shape
    slab = 1.0 / 16.0
    th, tw = -(-H_ // 8), -(-W_ // 128)
    k_slab, k_in = R.split(k)
    u0 = R.uniform(k_slab, (th, tw), dev, 0.0, 1.0 - slab)
    u0 = u0.repeat_interleave(8, 0).repeat_interleave(128, 1)[:H_, :W_]
    return u0 + R.uniform(k_in, (H_, W_), dev) * slab


def _refinement_candidates(inputs, params, key, xs, ys, normal, depth,
                           prior_normal, prior_mask, prior_depth, dmin, dmax):
    """The 5 refinement candidates (ACMMP.cu:871-874): (rand_d, cur_n),
    (cur_d, rand_n), (rand_d, rand_n), (cur_d, pert_n), (pert_d, cur_n).
    On the kernel paths the free random depths are tile-slab sampled so the
    kernels' windows cover them; on the exact path they are i.i.d.  In a
    planar-prior pass masked pixels draw around the prior instead (+-3
    sigma_d in depth, prior_angle_sigma in angle; ACMMP.cu:830-836).
    Returns (normals (5, ..., 3), w (5, ...), depth_at (5, ...))."""
    cam = inputs.ref_cam
    dev = depth.device
    perturbation = params.refine_perturbation
    k_rd, k_rn, k_pn, k_pd = R.split(key, 4)

    shape = tuple(depth.shape)
    rand_fast = _use_fast(inputs, params) or _use_rect(inputs, params)
    if params.planar_prior:
        depth_sigma = (dmax - dmin) / params.prior_depth_sigma_div
        lo_p = torch.maximum(prior_depth - 3.0 * depth_sigma, dmin)
        hi_p = torch.minimum(prior_depth + 3.0 * depth_sigma, dmax)
        u = R.uniform(k_rd, shape, dev)
        d_rand_prior = R.sample_depth_inv(u, lo_p, hi_p)
        u_free = _slab_uniform(k_rd, shape, dev) if rand_fast else u
        d_rand_free = R.sample_depth_inv(u_free, dmin, dmax)
        depth_rand = torch.where(prior_mask, d_rand_prior, d_rand_free)
        n_rand_prior = R.perturbed_normal(k_rn, cam, xs, ys, prior_normal,
                                          params.prior_angle_sigma)
        n_rand_free = R.random_normal_toward_viewer(k_rn, cam, xs, ys)
        normal_rand = torch.where(prior_mask[..., None], n_rand_prior,
                                  n_rand_free)
    else:
        u = (_slab_uniform(k_rd, shape, dev) if rand_fast
             else R.uniform(k_rd, shape, dev))
        depth_rand = R.sample_depth_inv(u, dmin, dmax)
        normal_rand = R.random_normal_toward_viewer(k_rn, cam, xs, ys)

    lo = torch.maximum((1.0 - perturbation) * depth, dmin)
    hi = torch.minimum((1.0 + perturbation) * depth, dmax)
    healed = ~(hi > lo)
    lo = torch.where(healed, dmin, lo)
    hi = torch.where(healed, dmax, hi)
    depth_pert = R.sample_depth_inv(R.uniform(k_pd, shape, dev), lo, hi)
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
                restricted, sel, prior, dmin, dmax, parity):
    """Ratchet through the 5 refinement candidates in order
    (PlaneHypothesisRefinement, ACMMP.cu:797-936), anchored at the
    post-acceptance running hypothesis.  In a planar-prior pass masked
    pixels ratchet on the restricted (prior-weighted) score ``restricted``.
    ``prior`` is (prior_normal, prior_mask, prior_depth) or Nones."""
    prior_normal, prior_mask, prior_depth = prior
    cand_normals, cand_w, cand_depth_at = _refinement_candidates(
        inputs, params, key, xs, ys, normal, depth, prior_normal, prior_mask,
        prior_depth, dmin, dmax)
    # candidates 0 and 2 carry the random depth: tile-slab sampled they may
    # use the kernels; i.i.d. (the windowed path of a prior pass) they take
    # the exact path (the reference's rand_ok, ops/propagate.py:615-621)
    rand_ok = (_use_rect(inputs, params)
               or (not params.planar_prior and _use_fast(inputs, params)))
    cv5, gv5 = _batched_cost_vectors(
        inputs, ctx, params, cand_normals, cand_w,
        exact_idx=() if rand_ok else (0, 2), parity=parity)
    can_refine = sel.weight_norm > 0.0     # reference early-out (ACMMP.cu:813)
    for i in range(5):
        c_i = _aggregate(cv5[i], None if gv5 is None else gv5[i], sel.weights,
                         sel.weight_norm, params.geom_weight_refine)
        d_i = cand_depth_at[i]
        valid = (can_refine & (d_i >= dmin) & (d_i <= dmax)
                 & (d_i < G.INVALID_DEPTH))
        if params.planar_prior:
            pw = _prior_weight(d_i, cand_normals[i], prior_depth, prior_normal,
                               params, dmin, dmax)
            r_i = _restricted(c_i, pw, params)
            accept_p = valid & prior_mask & (r_i > restricted)
            accept = accept_p | (valid & ~prior_mask & (c_i < cost))
            restricted = torch.where(accept_p, r_i, restricted)
        else:
            accept = valid & (c_i < cost)
        normal = torch.where(accept[..., None], cand_normals[i], normal)
        w = torch.where(accept, cand_w[i], w)
        depth = torch.where(accept, d_i, depth)
        cost = torch.where(accept, c_i, cost)
    return normal, w, depth, cost


def _halfstep_core(inputs, ctx, params, key, iteration, xs, ys, cur_normal,
                   cur_w, cur_cost, cur_pre_cost, cur_selected,
                   cands: Candidates, priors, prior_normal, prior_w,
                   prior_mask, parity):
    """Propagation + refinement update of every position of one grid (the
    packed half-grid, or the full grid of the odd-frame fallback), with the
    planar-prior acceptance (``prior_*`` on that grid, in a planar-prior
    pass) and the hierarchy commit guard.  Returns the updated (normal, w,
    cost, selected)."""
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

    if params.planar_prior:
        prior_depth = G.depth_from_plane(cam, xs, ys, prior_normal, prior_w)
        pw_cand = _prior_weight(
            G.depth_from_plane(cam, xs, ys, cands.normal, cands.w),
            cands.normal, prior_depth, prior_normal, params, dmin, dmax)
        restricted_cands = torch.where(
            cands.valid, _restricted(final_costs, pw_cand, params),
            torch.zeros_like(final_costs))
        max_idx = torch.argmax(restricted_cands, 0)
        r_take = lambda a: torch.gather(a, 0, max_idx[None])[0]
        rbest = r_take(restricted_cands)
        rbest_n = torch.gather(
            cands.normal, 0,
            max_idx[None, ..., None].expand(1, *cur_normal.shape))[0]
        rbest_w = r_take(cands.w)
        rbest_cost = r_take(final_costs)
        rbest_valid = r_take(cands.valid.to(torch.int32)) > 0
        rbest_depth = G.depth_from_plane(cam, xs, ys, rbest_n, rbest_w)
        r_in_range = (rbest_depth >= dmin) & (rbest_depth <= dmax)
        restricted_now = _restricted(
            cost_now0, _prior_weight(depth_now0, cur_normal, prior_depth,
                                     prior_normal, params, dmin, dmax),
            params)
        accept_p = (prior_mask & rbest_valid & r_in_range
                    & (rbest > restricted_now) & ~no_votes)
        accept_s = (~prior_mask & best_valid & in_range
                    & (best_cost < cost_now0) & ~no_votes)
        pick = lambda p, s, cur: torch.where(accept_p, p,
                                             torch.where(accept_s, s, cur))
        normal_loc = torch.where(
            accept_p[..., None], rbest_n,
            torch.where(accept_s[..., None], best_n, cur_normal))
        w_loc = pick(rbest_w, best_w, cur_w)
        depth_loc = pick(rbest_depth, best_depth, depth_now0)
        cost_loc = pick(rbest_cost, best_cost, cost_now0)
        # the restricted ratchet starts at 0 and is set only on prior
        # acceptance, which alone updates the selected views (ACMMP.cu:1246,
        # 1285-1286)
        restricted_loc = torch.where(accept_p, rbest,
                                     torch.zeros_like(rbest))
        sel_loc = torch.where(accept_p[None], sel.temp_selected, cur_selected)
    else:
        prior_depth = None
        accept = best_valid & in_range & (best_cost < cost_now0) & ~no_votes
        normal_loc = torch.where(accept[..., None], best_n, cur_normal)
        w_loc = torch.where(accept, best_w, cur_w)
        depth_loc = torch.where(accept, best_depth, depth_now0)
        cost_loc = torch.where(accept, best_cost, cost_now0)
        restricted_loc = None
        sel_loc = torch.where(accept[None], sel.temp_selected, cur_selected)

    normal_f, w_f, _, cost_f = _refinement(
        inputs, ctx, params, k_refine, xs, ys, normal_loc, w_loc, depth_loc,
        cost_loc, restricted_loc, sel, (prior_normal, prior_mask, prior_depth),
        dmin, dmax, parity)

    if params.hierarchy:
        # commit only a clear improvement on the seeded plane's own initial
        # cost; the rest keep the re-evaluated current cost (ACMMP.cu:1244,
        # 1315-1324)
        commit = cost_f < cur_pre_cost - params.hierarchy_commit_margin
        normal_f = torch.where(commit[..., None], normal_f, cur_normal)
        w_f = torch.where(commit, w_f, cur_w)
        cost_f = torch.where(commit, cost_f, cost_now0)
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
    wrap = inputs.ref_cam.model == SPHERE
    cands = gather_candidates(state.normal, state.w, state.cost, wrap_x=wrap)
    near_valid = cands.valid[list(NEAR_REGION_INDICES)]
    priors = view_selection_priors(state.selected, near_valid, params,
                                   wrap_x=wrap)
    prior = ((inputs.prior_normal, inputs.prior_w, inputs.prior_mask)
             if params.planar_prior else (None, None, None))

    packed_ok = H % 2 == 0 and W % 2 == 0 and (
        not use_rect or len(inputs.rect.maps) == 3)
    if not packed_ok:
        xs, ys = grid_coords(H, W, dev)
        normal_f, w_f, cost_f, sel_f = _halfstep_core(
            inputs, ctx, params, key, iteration, xs, ys, state.normal,
            state.w, state.cost, state.pre_cost, state.selected, cands,
            priors, *prior, None)
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
    pn, pw, pm = prior
    normal_f, w_f, cost_f, sel_f = _halfstep_core(
        inputs, ctx_p, params, key, iteration, xs_p, ys_p, Pc(state.normal),
        P(state.w), P(state.cost), P(state.pre_cost), P(state.selected),
        cands_p, P(priors), None if pn is None else Pc(pn),
        None if pw is None else P(pw), None if pm is None else P(pm),
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
