"""One full PatchMatch pass over a single problem (counterpart of
acmmp_spherical_tpu/pipeline/patchmatch.py, fused form).

Random or seeded init, ``max_iterations`` x (black, red) half-steps,
depth/normal extraction and the black/red median filter (reference
ACMMP::RunPatchMatch, ACMMP.cu:1506-1556).  The key schedule is the
reference's exactly: ``split(key)`` into (init, iterations), then
``split(fold_in(k_iters, i))`` per iteration, so a pass from the same key
draws the same numbers (a geometric or hierarchy pass splits off the init
key and draws nothing from it; a planar-prior pass draws its perturbed
prior from it).
"""

from __future__ import annotations

import dataclasses

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.core.camera import SPHERE
from acmmp_spherical_torch.ops import rng as R
from acmmp_spherical_torch.ops.filter import checkerboard_median_filter
from acmmp_spherical_torch.ops.ncc import ref_tap_context
from acmmp_spherical_torch.ops.propagate import (
    PatchMatchInputs, needs_tap_context, checkerboard_halfstep,
    extract_depth_and_normal, initialize_state, prepare_inputs,
)


def run_patchmatch(inputs: PatchMatchInputs, params: PatchMatchParams, key,
                   *, prev_state=None, seed_normal_world=None,
                   seed_depth=None):
    """Run one complete pass.  ``key`` is an ``ops.rng`` key (or an int
    seed).  A geometric pass (``params.with_geom``, ``inputs.src_depths``)
    or a hierarchy pass (``params.with_hierarchy()``) starts from the seed
    fields: world normals (H, W, 3) and depths (H, W) of the previous pass
    (for a hierarchy pass, upsampled from the coarser scale).  A
    planar-prior pass (``params.with_planar_prior()``, the prior fields of
    ``inputs``) starts from ``prev_state``, the state the previous pass
    returned.  With ``fast_ncc`` and ``exact_first_iteration`` a fresh
    random pass runs its first iteration on the exact path.  Inputs that
    already carry their rectified context (``prepare_inputs``) keep it.
    Returns (depth (H, W), normal_world (H, W, 3), cost (H, W), state)."""
    if isinstance(key, int):
        key = R.key(key)
    inputs = prepare_inputs(inputs, params)
    ctx = None
    if needs_tap_context(inputs, params):
        ctx = ref_tap_context(inputs.ref_image, inputs.ref_cam, params)
    k_init, k_iters = R.split(key)
    state = initialize_state(inputs, params, k_init, prev_state=prev_state,
                             seed_normal_world=seed_normal_world,
                             seed_depth=seed_depth, ctx=ctx)
    first_iter = 0
    fresh_random = not (params.geom_consistency or params.hierarchy
                        or params.planar_prior)
    if (params.fast_ncc and params.exact_first_iteration and fresh_random
            and params.max_iterations > 0):
        # the first iteration after a random init sees scattered fields:
        # the exact path, then the windowed kernel
        params0 = dataclasses.replace(params, fast_ncc=False)
        k0, k1 = R.split(R.fold_in(k_iters, 0))
        for parity, k in ((0, k0), (1, k1)):
            state = checkerboard_halfstep(state, inputs, params0, k, 0,
                                          parity, ctx=ctx)
        first_iter = 1
    for i in range(first_iter, params.max_iterations):
        k0, k1 = R.split(R.fold_in(k_iters, i))
        state = checkerboard_halfstep(state, inputs, params, k0, i, 0, ctx=ctx)
        state = checkerboard_halfstep(state, inputs, params, k1, i, 1, ctx=ctx)
    depth, normal_world = extract_depth_and_normal(state, inputs.ref_cam)
    depth = checkerboard_median_filter(
        depth, state.cost, min_cost=params.filter_min_cost,
        wrap_x=inputs.ref_cam.model == SPHERE)
    return depth, normal_world, state.cost, state
