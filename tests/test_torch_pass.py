"""The rectified photometric pass of the port against the reference.

(a) the port's full pass (rect + warp transport, both bf16 packs off) on the
    golden problem against the reference's committed statistics
    (tests/fixtures/golden_pass_stats_warp.json) at drift_gate's 2e-2 --
    the fixture was made with the packs on, which explains part of the gap;
(b) one half-step of each package from the same state, inputs and key
    (handed over through ``interop``): costs within 1e-4 and the accept
    mask identical on >= 99.5% of pixels;
(c) a one-iteration pass of each package from the same key
    (rect_inv_attrib on): region statistics within the CPU fixture's 2e-3;
    the plane field's depth within 1e-3 relative on >= 98% of pixels (99.2%
    measured) and the median-filtered depth on >= 97% (97.5% measured: the
    21-tap filter spreads each differing pixel to its neighbours' medians).
    Marked slow: the reference pass compiles for about three minutes on a
    CPU.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.core.camera import stack_cameras as tstack  # noqa: E402
from acmmp_spherical_torch.ops import propagate as TP  # noqa: E402
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch  # noqa: E402

from test_regression_fixture import (  # noqa: E402
    FIXTURE_WARP, _stats, check_against_fixture,
)
from torch_port_util import (  # noqa: E402
    H, N_VIEWS, golden_scene, jax_cam_dict, np_tree, port_params, rect_params,
)

KEY = 2333


@pytest.fixture(scope="module")
def scene():
    return golden_scene()


def _port_inputs(tcams, images):
    imgs = torch.from_numpy(images)
    return TP.PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=tcams[0],
        src_cams=tstack(tcams[1:]),
        src_valid=torch.ones(N_VIEWS - 1, dtype=torch.bool),
        depth_range=tcams[0].depth_range)


def _jax_inputs(cams, images):
    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs

    imgs = jnp.asarray(images)
    return PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=cams[0],
        src_cams=stack_cameras(cams[1:]), src_valid=jnp.ones(N_VIEWS - 1, bool),
        depth_range=jnp.asarray(np.asarray(cams[0].depth_range), jnp.float32))


def test_full_pass_matches_reference_fixture(scene):
    cams, tcams, images, depths, _ = scene
    params = port_params(rect_params(cams, inv_attrib=False))
    d, n, c, state = run_patchmatch(_port_inputs(tcams, images), params, KEY)
    assert d.shape == (H, images.shape[2]) and bool(torch.isfinite(d).all())
    check_against_fixture(_stats(d.numpy(), n.numpy(), c.numpy()),
                          json.loads(FIXTURE_WARP.read_text()),
                          rtol=2e-2, atol=2e-2)
    rel = np.abs(d.numpy() - depths[0]) / depths[0]
    assert np.median(rel[8:-8, 8:-8]) < 0.01


def test_halfstep_from_identical_state(scene):
    from acmmp_spherical_tpu.ops import propagate as JP
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context

    cams, tcams, images, _, _ = scene
    params = rect_params(cams)
    jin = JP.prepare_inputs(_jax_inputs(cams, images), params)
    ctx = ref_tap_context(jin.ref_image, jin.ref_cam, params)
    k_init, k_iters = jax.random.split(jax.random.key(KEY))
    state = JP.initialize_state(jin, params, k_init, ctx=ctx)
    k0, _ = jax.random.split(jax.random.fold_in(k_iters, 0))
    out = JP.checkerboard_halfstep(state, jin, ctx, params, k0, 0, 0)

    rect = np_tree(jin.rect)
    rect["maps"] = [{k: m[k] for k in ("fwd_idx", "fwd_valid", "bwd_cidx",
                                       "bwd_x", "bwd_y", "bwd_valid")}
                    for m in rect["maps"]]
    tin = interop.patchmatch_inputs(dict(
        ref_image=images[0], src_images=images[1:],
        ref_cam=jax_cam_dict(cams[0]),
        src_cams=jax_cam_dict(jin.src_cams), src_valid=np.asarray(jin.src_valid),
        depth_range=np.asarray(jin.depth_range), rect=rect), device="cpu")
    tstate = interop.plane_state(np_tree(state), device="cpu")
    from acmmp_spherical_torch.ops import rng as TR

    tk0, _ = TR.split(TR.fold_in(TR.split(TR.key(KEY))[1], 0))
    tout = TP.checkerboard_halfstep(tstate, tin, port_params(params), tk0,
                                    0, 0)

    jw, tw = np.asarray(out.w), tout.w.numpy()
    j_acc = jw != np.asarray(state.w)
    t_acc = tw != tstate.w.numpy()
    assert (j_acc == t_acc).mean() >= 0.995, (j_acc == t_acc).mean()
    assert j_acc.mean() > 0.1
    dc = np.abs(np.asarray(out.cost) - tout.cost.numpy())
    assert np.mean(dc <= 1e-4) >= 0.995, np.mean(dc <= 1e-4)


@pytest.mark.slow
def test_one_iteration_pass_matches_reference(scene):
    from acmmp_spherical_tpu.pipeline.patchmatch import (
        run_patchmatch as jax_run,
    )

    cams, tcams, images, _, _ = scene
    params = rect_params(cams, iterations=1)
    from acmmp_spherical_tpu.ops.propagate import extract_depth_and_normal

    jd, jn, jc, js = jax_run(_jax_inputs(cams, images), params,
                             jax.random.key(KEY))
    td, tn, tc, ts = run_patchmatch(_port_inputs(tcams, images),
                                    port_params(params), KEY)
    check_against_fixture(_stats(td.numpy(), tn.numpy(), tc.numpy()),
                          _stats(np.asarray(jd), np.asarray(jn),
                                 np.asarray(jc)), rtol=2e-3, atol=2e-3)
    jraw = np.asarray(extract_depth_and_normal(js, cams[0])[0])
    traw = TP.extract_depth_and_normal(ts, tcams[0])[0].numpy()
    rel_raw = np.abs(traw - jraw) / np.abs(jraw)
    assert np.mean(rel_raw <= 1e-3) >= 0.98, np.mean(rel_raw <= 1e-3)
    rel = np.abs(td.numpy() - np.asarray(jd)) / np.asarray(jd)
    assert np.mean(rel <= 1e-3) >= 0.97, np.mean(rel <= 1e-3)


def test_unported_branches_raise(scene):
    """``rect_prescreen`` raises; a problem that mixes a SPHERE reference
    with pinhole sources gets no rectified context (it stays on the exact
    path, as in the reference; SPHERE problems are ported,
    tests/test_torch_sphere_*.py); planar-prior and hierarchy passes are
    ported (tests/test_torch_prior_pass.py)."""
    cams, tcams, images, _, _ = scene
    inputs = _port_inputs(tcams, images)
    base = port_params(rect_params(cams))
    with pytest.raises(NotImplementedError, match="not ported"):
        TP.prepare_inputs(inputs, dataclasses.replace(base,
                                                      rect_prescreen=True))
    sphere = dataclasses.replace(inputs, ref_cam=dataclasses.replace(
        inputs.ref_cam, model="sphere"))
    mixed = TP.prepare_inputs(sphere, base)
    assert mixed.rect is None and not TP._use_rect(mixed, base)
    for change in (dict(hierarchy=True), dict(planar_prior=True)):
        TP.prepare_inputs(inputs, dataclasses.replace(base, **change))


def test_unrectifiable_problem_runs_off_the_rect_path():
    """A forward-motion pair fails host_rectifiable: the rectified path
    refuses it, and the windowed and exact paths (rect_ncc off, as the pass
    runner sets it) run it without a rectified context."""
    from acmmp_spherical_tpu.core.camera import make_camera
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )

    cams = make_ring_of_cameras(2, width=96, height=64, focal=80.0)
    fwd = jax_cam_dict(cams[1])
    fwd["t"] = np.asarray(cams[0].t) + np.array([0.0, 0.0, -0.3], np.float32)
    jcams = [cams[0], make_camera(fwd["R"], fwd["t"], K=fwd["K"], width=96,
                                  height=64, depth_min=1.2, depth_max=10.0)]
    tc = [interop.camera(jax_cam_dict(c), device="cpu") for c in jcams]
    images, _, _ = render_scene(jcams, CubeRoom(), 96, 64)
    imgs = torch.from_numpy(images)
    inputs = TP.PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=tc[0],
        src_cams=tstack(tc[1:]), src_valid=torch.ones(1, dtype=torch.bool),
        depth_range=tc[0].depth_range)
    with pytest.raises(ValueError, match="host_rectifiable"):
        TP.prepare_inputs(inputs, port_params(rect_params(cams)))
    for fast in (True, False):
        params = dataclasses.replace(port_params(rect_params(cams)),
                                     rect_ncc=False, fast_ncc=fast,
                                     max_iterations=1)
        assert TP.prepare_inputs(inputs, params).rect is None
        d, _, c, _ = run_patchmatch(inputs, params, KEY)
        assert d.shape == (H, 96) and bool(torch.isfinite(d).all())
        assert bool(torch.isfinite(c).all())
