"""The port's planar-prior half-step against the reference.

On the golden problem (96x64x3src, both bf16 packs off), on the exact, the
windowed (``fast_ncc``) and the rectified (rect + warp transport, inverse
attribution) paths; the reference runs its Pallas kernels in interpret mode.
The prior is built by the reference's ``build_planar_prior`` from the
ground-truth depth and a patterned cost; the previous state is a random
init.

* the prior init: the same draws -- plane offsets equal, normals within
  1e-6 (the perturbed normals' rotation and rsqrt, ROADMAP Queue 3 item 1);
* one planar-prior half-step of each package from the same state, inputs
  and key: accept masks equal on >= 99.5% of pixels, as
  test_torch_pass.py, with more than 1% of the pixels accepting;
* the windowed prior half-step's refinement evaluates its random-depth
  candidates 0 and 2 on the exact path (the reference's ``exact_idx``):
  their costs equal the reference's ``multiview_ncc`` of the same fields
  within 1e-4 on >= 99.5% of pixels (the exact path's f32 gap, ROADMAP
  Queue 3 item 6).

The rectified path's cases are in test_torch_prior_rect_pass.py, the
hierarchy half-steps in test_torch_hier_pass.py, the golden prior and
hierarchy passes in test_torch_prior_golden.py (each file stays near three
minutes on a CPU).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.bench import GOLDEN_KEY  # noqa: E402
from acmmp_spherical_torch.ops import propagate as TP  # noqa: E402
from acmmp_spherical_torch.ops import rng as TR  # noqa: E402

from torch_port_util import (  # noqa: E402
    golden_scene, jax_cam_dict, jax_inputs, np_tree, port_params, rect_params,
)

PATHS = ("exact", "window", "rect")


@pytest.fixture(scope="module")
def scene():
    return golden_scene()


def _jax_params(path, cams):
    from acmmp_spherical_tpu.config import PatchMatchParams

    if path == "rect":
        return rect_params(cams)
    return PatchMatchParams(fast_ncc=path == "window")


def hierarchy_seed(depths, normals):
    """A hierarchy seed: the ground-truth depth x (1 + 0.2 sin i) (i the
    flat pixel index) and normals.  Seeds within 1% or 5% leave the commit
    guard (cost better by 0.1) under 1% of the pixels to commit."""
    H, W = depths.shape[1:]
    i = np.arange(H * W, dtype=np.float64).reshape(H, W)
    return ((depths[0] * (1.0 + 0.2 * np.sin(i))).astype(np.float32),
            normals[0].astype(np.float32))


def _prior_fields(cams, depths):
    """The reference's planar prior from the ground-truth depth and a cost
    that is low (support points) except on a diagonal band pattern."""
    from acmmp_spherical_tpu.config import PriorConfig
    from acmmp_spherical_tpu.pipeline.prior import build_planar_prior

    H, W = depths.shape[1:]
    ys, xs = np.mgrid[0:H, 0:W]
    cost = np.where((xs // 12 + ys // 12) % 4 == 0, 0.5, 0.05)
    dmin, dmax = np.asarray(cams[0].depth_range)
    n, w, mask, _ = build_planar_prior(cams[0], depths[0],
                                       cost.astype(np.float32), dmin, dmax,
                                       PriorConfig())
    return n, w, mask


def _build_identical_state(scene, path, mode):
    """(reference inputs, tap context, params, init state, the port's
    inputs, the reference's previous state) of a planar-prior (``mode``
    "prior") or hierarchy pass; the reference's state is what both
    packages' half-steps start from."""
    from acmmp_spherical_tpu.ops import propagate as JP
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context

    cams, _, images, depths, normals = scene
    params = _jax_params(path, cams)
    jin = JP.prepare_inputs(jax_inputs(cams, images), params)
    ctx = ref_tap_context(jin.ref_image, jin.ref_cam, params)
    k_init, _ = jax.random.split(jax.random.key(GOLDEN_KEY))
    d = dict(ref_image=images[0], src_images=images[1:],
             ref_cam=jax_cam_dict(cams[0]), src_cams=jax_cam_dict(jin.src_cams),
             src_valid=np.asarray(jin.src_valid),
             depth_range=np.asarray(jin.depth_range))
    if path == "rect":
        rect = np_tree(jin.rect)
        rect["maps"] = [{k: m[k] for k in ("fwd_idx", "fwd_valid",
                                           "bwd_cidx", "bwd_x", "bwd_y",
                                           "bwd_valid")}
                        for m in rect["maps"]]
        d["rect"] = rect
    tin = interop.patchmatch_inputs(d, device="cpu")
    prev = None
    if mode == "prior":
        prev = JP.initialize_state(jin, params, k_init, ctx=ctx)
        n, w, mask = _prior_fields(cams, depths)
        jin = jin._replace(prior_normal=jnp.asarray(n),
                           prior_w=jnp.asarray(w),
                           prior_mask=jnp.asarray(mask))
        tin = dataclasses.replace(tin, prior_normal=torch.from_numpy(n),
                                  prior_w=torch.from_numpy(w),
                                  prior_mask=torch.from_numpy(mask))
        params = params.with_planar_prior()
        state = JP.initialize_state(jin, params, jax.random.fold_in(k_init, 1),
                                    prev_state=prev, ctx=ctx)
    else:
        seed_d, seed_n = hierarchy_seed(depths, normals)
        params = params.with_hierarchy()
        state = JP.initialize_state(jin, params, k_init, ctx=ctx,
                                    seed_normal_world=jnp.asarray(seed_n),
                                    seed_depth=jnp.asarray(seed_d))
    return jin, ctx, params, state, tin, prev


_STATES: dict = {}


def identical_state(scene, path, mode):
    """``_build_identical_state``, built once per (path, mode) and test
    process (the reference's rectified context and init take about half a
    minute in interpret mode)."""
    if (path, mode) not in _STATES:
        _STATES[path, mode] = _build_identical_state(scene, path, mode)
    return _STATES[path, mode]


def port_ctx(ctx, path):
    return None if path == "rect" else interop.ref_tap_context(
        np_tree(ctx), "cpu")


def check_prior_init_draws(scene, path):
    jin, ctx, params, state, tin, prev = identical_state(scene, path,
                                                         "prior")
    k_init, _ = TR.split(TR.key(GOLDEN_KEY))
    ts = TP.initialize_state(
        tin, port_params(params), TR.fold_in(k_init, 1),
        prev_state=interop.plane_state(np_tree(prev), device="cpu"),
        ctx=port_ctx(ctx, path))
    use_prior = np.asarray(jin.prior_mask) & (np.asarray(prev.cost) >= 0.1)
    assert use_prior.mean() > 0.5
    np.testing.assert_array_equal(ts.w.numpy(), np.asarray(state.w))
    np.testing.assert_allclose(ts.normal.numpy(), np.asarray(state.normal),
                               rtol=0, atol=1e-6)


def halfstep_agreement(scene, path, mode):
    """(accept-mask agreement, the reference's accepted fraction) of one
    half-step of each package from the reference's init state."""
    from acmmp_spherical_tpu.ops import propagate as JP

    jin, ctx, params, state, tin, _ = identical_state(scene, path, mode)
    _, k_iters = jax.random.split(jax.random.key(GOLDEN_KEY))
    k0, _ = jax.random.split(jax.random.fold_in(k_iters, 0))
    out = JP.checkerboard_halfstep(state, jin, ctx, params, k0, 0, 0)
    tstate = interop.plane_state(np_tree(state), device="cpu")
    tk0, _ = TR.split(TR.fold_in(TR.split(TR.key(GOLDEN_KEY))[1], 0))
    tout = TP.checkerboard_halfstep(tstate, tin, port_params(params), tk0,
                                    0, 0, ctx=port_ctx(ctx, path))
    j_acc = np.asarray(out.w) != np.asarray(state.w)
    t_acc = tout.w.numpy() != tstate.w.numpy()
    return (j_acc == t_acc).mean(), j_acc.mean()


def check_halfstep(scene, path, mode):
    agree, accepted = halfstep_agreement(scene, path, mode)
    assert agree >= 0.995, agree
    assert accepted > 0.01, accepted


@pytest.mark.parametrize("path", ["exact", "window"])
def test_prior_init_draws_match_reference(scene, path):
    check_prior_init_draws(scene, path)


@pytest.mark.parametrize("path", ["exact", "window"])
def test_prior_halfstep_from_identical_state(scene, path):
    check_halfstep(scene, path, "prior")


def test_windowed_prior_refinement_takes_the_exact_path(scene, monkeypatch):
    """Candidates 0 and 2 of the windowed prior half-step's refinement (the
    one 5-field evaluation) carry i.i.d. prior-guided depths: the reference
    evaluates them with ``multiview_ncc``, and so must the port."""
    from acmmp_spherical_tpu.ops.ncc import multiview_ncc

    jin, ctx, params, state, tin, _ = identical_state(scene, "window",
                                                       "prior")
    calls = []
    batched = TP._batched_cost_vectors

    def record(inputs, c, p, normals, ws, **kw):
        out = batched(inputs, c, p, normals, ws, **kw)
        if ws.shape[0] == 5:
            calls.append((normals, ws, out[0]))
        return out

    monkeypatch.setattr(TP, "_batched_cost_vectors", record)
    tk0, _ = TR.split(TR.fold_in(TR.split(TR.key(GOLDEN_KEY))[1], 0))
    TP.checkerboard_halfstep(interop.plane_state(np_tree(state), "cpu"), tin,
                             port_params(params), tk0, 0, 0,
                             ctx=port_ctx(ctx, "window"))
    assert len(calls) == 1
    normals, ws, cv = calls[0]
    from acmmp_spherical_tpu.ops.sampling import (
        checkerboard_coords, checkerboard_pack,
    )
    xs, ys = checkerboard_coords(*jin.ref_image.shape, 0)
    ctx_p = ctx._replace(ref_taps=checkerboard_pack(ctx.ref_taps, 0),
                         weights=checkerboard_pack(ctx.weights, 0),
                         center=checkerboard_pack(ctx.center, 0), xs=xs,
                         ys=ys)
    for i in (0, 2):
        ref = np.asarray(multiview_ncc(
            jin.src_images, jin.src_cams, jin.ref_cam,
            jnp.asarray(normals[i].numpy()), jnp.asarray(ws[i].numpy()),
            ctx_p, params))
        close = np.abs(cv[i].numpy() - ref) <= 1e-4
        assert close.mean() >= 0.995, (i, close.mean())
