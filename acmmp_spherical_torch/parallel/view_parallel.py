"""View-parallel step: problems over the slots of a mesh (counterpart of
acmmp_spherical_tpu/parallel/view_parallel.py).

Within a pass, problems are independent: data parallelism over the slots.
Between the photometric and the geometric pass, each problem needs the
depth maps of its source views, which other slots computed: every slot's
depths are gathered onto every slot's device (the JAX package reshards them
to replicated, an all-gather), and each problem picks its sources by
``src_view_global``.  The JAX package's quirks are kept: no rectified
context (its step never prepares one), no median filter, and the geometric
pass runs one iteration whose two half-steps draw from the same key.
"""

from __future__ import annotations

import dataclasses

import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.core.camera import Cameras, camera_index
from acmmp_spherical_torch.ops import rng as R
from acmmp_spherical_torch.ops.ncc import ref_tap_context
from acmmp_spherical_torch.ops.propagate import (
    PatchMatchInputs, checkerboard_halfstep, extract_depth_and_normal,
    initialize_state,
)
from acmmp_spherical_torch.parallel.mesh import ViewMesh, run_slots


@dataclasses.dataclass(frozen=True)
class ProblemBatch:
    """B problems of one shape.  ``images`` (B, V, H, W): view 0 of each
    problem is its reference; ``cams``: cameras with leaves (B, V, ...);
    ``src_valid`` (B, V-1); ``src_view_global`` (B, V-1) int: the index of
    each source view in the global problem list (the depth exchange), -1
    for padding."""

    images: torch.Tensor
    cams: Cameras
    src_valid: torch.Tensor
    src_view_global: torch.Tensor


def _problem_inputs(batch: ProblemBatch, b: int, params: PatchMatchParams,
                    src_depths=None) -> PatchMatchInputs:
    cams = camera_index(batch.cams, b)
    ref = camera_index(cams, 0)
    src = dataclasses.replace(cams, **{
        f.name: getattr(cams, f.name)[1:]
        for f in dataclasses.fields(cams) if f.name != "model"})
    return PatchMatchInputs(
        ref_image=batch.images[b, 0], src_images=batch.images[b, 1:],
        ref_cam=ref, src_cams=src, src_valid=batch.src_valid[b],
        depth_range=torch.tensor([params.depth_min, params.depth_max],
                                 dtype=torch.float32,
                                 device=batch.images.device),
        src_depths=src_depths)


def _photometric_pass(inputs, params, key, n_iterations):
    ctx = ref_tap_context(inputs.ref_image, inputs.ref_cam, params)
    state = initialize_state(inputs, params, key, ctx=ctx)
    for i in range(n_iterations):
        k0, k1 = R.split(R.fold_in(key, i + 1))
        state = checkerboard_halfstep(state, inputs, params, k0, i, 0,
                                      ctx=ctx)
        state = checkerboard_halfstep(state, inputs, params, k1, i, 1,
                                      ctx=ctx)
    depth, normal = extract_depth_and_normal(state, inputs.ref_cam)
    return depth, normal, state.cost


def _geom_pass(inputs, params, key, seed_normal, seed_depth):
    ctx = ref_tap_context(inputs.ref_image, inputs.ref_cam, params)
    state = initialize_state(inputs, params, key,
                             seed_normal_world=seed_normal,
                             seed_depth=seed_depth, ctx=ctx)
    state = checkerboard_halfstep(state, inputs, params, key, 0, 0, ctx=ctx)
    state = checkerboard_halfstep(state, inputs, params, key, 0, 1, ctx=ctx)
    depth, normal = extract_depth_and_normal(state, inputs.ref_cam)
    return depth, normal, state.cost


def multichip_step(mesh: ViewMesh, params: PatchMatchParams,
                   n_iterations: int = 1):
    """The step photometric -> depth exchange -> geometric over ``mesh``:
    ``step(shards, key)`` takes ``shard_batch_over_views(mesh, batch)``
    and a key, and returns per slot (depth (b, H, W), world normal
    (b, H, W, 3), cost (b, H, W)) of its problems, on its device.  Problem
    ``i`` of the batch draws from ``fold_in(key, i)``."""
    geom_params = params.with_geom(False)

    def step(shards, key):
        starts = [0]
        for s in shards[:-1]:
            starts.append(starts[-1] + s.images.shape[0])

        def photometric(slot, shard):
            outs = [_photometric_pass(
                _problem_inputs(shard, b, params), params,
                R.fold_in(key, starts[slot] + b), n_iterations)
                for b in range(shard.images.shape[0])]
            return tuple(torch.stack(o) for o in zip(*outs))

        phot = run_slots(mesh, photometric, shards)

        def geometric(slot, shard):
            dev = mesh.devices[slot]
            # the exchange: every slot's depths on this slot's device
            all_depths = torch.cat([d.to(dev) for d, _, _ in phot])
            depth, normal, _ = phot[slot]
            outs = []
            for b in range(shard.images.shape[0]):
                ids = shard.src_view_global[b].to(torch.int64)
                src_depths = torch.where(
                    (ids >= 0)[:, None, None],
                    all_depths[torch.clamp(ids, min=0)],
                    torch.zeros((), device=dev))
                outs.append(_geom_pass(
                    _problem_inputs(shard, b, geom_params, src_depths),
                    geom_params, R.fold_in(key, starts[slot] + b), normal[b],
                    depth[b]))
            return tuple(torch.stack(o) for o in zip(*outs))

        return run_slots(mesh, geometric, shards)

    return step
