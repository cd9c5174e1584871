"""One full PatchMatch pass over a single problem (counterpart of
acmmp_spherical_tpu/pipeline/patchmatch.py, fused form).

Random or seeded init, ``max_iterations`` x (black, red) half-steps,
depth/normal extraction and the black/red median filter (reference
ACMMP::RunPatchMatch, ACMMP.cu:1506-1556).  The key schedule is the
reference's exactly: ``split(key)`` into (init, iterations), then
``split(fold_in(k_iters, i))`` per iteration, so a pass from the same key
draws the same numbers (a geometric or hierarchy pass splits off the init
key and draws nothing from it; a planar-prior pass draws its perturbed
prior from it).  With ``shard_state`` (``parallel/tile.make_state_sharder``)
the init, the half-steps and the extraction run on width tiles over the
slots of a mesh, and the median filter on the joined frame.
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
from acmmp_spherical_torch.utils.log import span


def run_patchmatch(inputs: PatchMatchInputs, params: PatchMatchParams, key,
                   *, prev_state=None, seed_normal_world=None,
                   seed_depth=None, shard_state=None):
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
    ``shard_state``: the tile-parallel hook (``parallel/tile.py``;
    ``shard_state(inputs, params)`` gives the pass's tiled ``initialize``,
    ``halfstep`` and ``extract``), exact path only; its outputs are on the
    mesh's lead slot.  The stages are the spans ``context``, ``init``,
    ``halfstep`` (each half-step) and ``extract`` (``utils/log.span``).
    Returns (depth (H, W), normal_world (H, W, 3), cost (H, W), state)."""
    if isinstance(key, int):
        key = R.key(key)
    with span("context"):
        inputs = prepare_inputs(inputs, params)
        if shard_state is not None:
            tiled = shard_state(inputs, params)
            init, halfstep, extract = (tiled.initialize, tiled.halfstep,
                                       tiled.extract)
        else:
            ctx = None
            if needs_tap_context(inputs, params):
                ctx = ref_tap_context(inputs.ref_image, inputs.ref_cam,
                                      params)
            init = lambda k, **kw: initialize_state(inputs, params, k,
                                                    ctx=ctx, **kw)
            halfstep = lambda st, p, k, it, parity: checkerboard_halfstep(
                st, inputs, p, k, it, parity, ctx=ctx)
            extract = lambda st: extract_depth_and_normal(st, inputs.ref_cam)

    def step(state, p, k, it, parity):
        with span("halfstep"):
            return halfstep(state, p, k, it, parity)

    k_init, k_iters = R.split(key)
    with span("init"):
        state = init(k_init, prev_state=prev_state,
                     seed_normal_world=seed_normal_world,
                     seed_depth=seed_depth)
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
            state = step(state, params0, k, 0, parity)
        first_iter = 1
    for i in range(first_iter, params.max_iterations):
        k0, k1 = R.split(R.fold_in(k_iters, i))
        state = step(state, params, k0, i, 0)
        state = step(state, params, k1, i, 1)
    with span("extract"):
        depth, normal_world = extract(state)
        depth = checkerboard_median_filter(
            depth, state.cost, min_cost=params.filter_min_cost,
            wrap_x=inputs.ref_cam.model == SPHERE)
    return depth, normal_world, state.cost, state
