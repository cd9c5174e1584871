"""One full PatchMatch pass over a single problem (counterpart of
acmmp_spherical_tpu/pipeline/patchmatch.py, fused form).

Random init, ``max_iterations`` x (black, red) half-steps, depth/normal
extraction and the black/red median filter (reference ACMMP::RunPatchMatch,
ACMMP.cu:1506-1556).  The key schedule is the reference's exactly:
``split(key)`` into (init, iterations), then ``split(fold_in(k_iters, i))``
per iteration, so a pass from the same key draws the same numbers.
"""

from __future__ import annotations

from acmmp_spherical_tpu.config import PatchMatchParams
from acmmp_spherical_torch.ops import rng as R
from acmmp_spherical_torch.ops.filter import checkerboard_median_filter
from acmmp_spherical_torch.ops.propagate import (
    PatchMatchInputs, checkerboard_halfstep, extract_depth_and_normal,
    initialize_state, prepare_inputs,
)


def run_patchmatch(inputs: PatchMatchInputs, params: PatchMatchParams, key):
    """Run one complete pass.  ``key`` is an ``ops.rng`` key (or an int
    seed).  Returns (depth (H, W), normal_world (H, W, 3), cost (H, W),
    state)."""
    if isinstance(key, int):
        key = R.key(key)
    inputs = prepare_inputs(inputs, params)
    k_init, k_iters = R.split(key)
    state = initialize_state(inputs, params, k_init)
    for i in range(params.max_iterations):
        k0, k1 = R.split(R.fold_in(k_iters, i))
        state = checkerboard_halfstep(state, inputs, params, k0, i, 0)
        state = checkerboard_halfstep(state, inputs, params, k1, i, 1)
    depth, normal_world = extract_depth_and_normal(state, inputs.ref_cam)
    depth = checkerboard_median_filter(depth, state.cost,
                                       min_cost=params.filter_min_cost)
    return depth, normal_world, state.cost, state
