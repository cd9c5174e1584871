"""The port's geometric-consistency pass against the reference.

On the golden problem (96x64x3src, rect + warp transport, inverse
attribution, both bf16 packs off) with the geometric pass's inputs of
``bench.golden_geom_fields`` (source depths GT x (1 + 0.01 cos i), seed
depth GT x (1 + 0.01 sin i), GT world normals):
(d) the seeded ``initialize_state`` from the reference's own context: plane
    normals and offsets within 1e-6 relative (equal here; the normalisation's
    rsqrt may differ from XLA's CPU rsqrt by a few ulp, ROADMAP Queue 3
    item 1), init costs within 1e-4 on >= 99.5% of pixels (99.98%
    measured: kernel-1 rounding, Queue 3 item 3);
(e) one geometric half-step of each package from the same state, inputs
    and key: accept mask and costs (within 1e-4) agreeing on >= 99.5%
    (100% and 99.95% measured);
(f) the port's full geometric pass (key 2333) against the reference's
    statistics in tests/fixtures/golden_geom_pass_stats_rect.json at the
    CPU fixture's 2e-3 (worst 0.07x of it measured);
(g) a near-GT seeded pass on exact source depths (as
    test_rect_ncc.py::test_rect_geom_pass_quality): median relative depth
    error < 0.01.

The reference's side of (d) and (e) is stored in
tests/fixtures/ref_geom_init.npz (``build_init_reference``), on the
geometric rectified context of ref_golden_context.npz.

Regenerate both fixtures from the reference (CPU, interpret mode, about 5
minutes):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_geom_pass.py --regen
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.bench import (  # noqa: E402
    GOLDEN_KEY, golden_geom_fields,
)
from acmmp_spherical_torch.core.camera import stack_cameras as tstack  # noqa: E402
from acmmp_spherical_torch.ops import propagate as TP  # noqa: E402
from acmmp_spherical_torch.ops import rng as TR  # noqa: E402
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch  # noqa: E402

from test_regression_fixture import _stats, check_against_fixture  # noqa: E402
from torch_port_util import (  # noqa: E402
    H, N_VIEWS, check_golden_context, golden_context, golden_scene,
    input_dict, np_tree, port_params, rect_params, reference_arrays,
    regen_references, stored_port_inputs,
)

FIXTURE_GEOM = (pathlib.Path(__file__).parent / "fixtures"
                / "golden_geom_pass_stats_rect.json")


@pytest.fixture(scope="module")
def scene():
    return golden_scene()


def _params(cams):
    return rect_params(cams).with_geom(False)


def _port_inputs(tcams, images, src_depths):
    imgs = torch.from_numpy(images)
    return TP.PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=tcams[0],
        src_cams=tstack(tcams[1:]),
        src_valid=torch.ones(N_VIEWS - 1, dtype=torch.bool),
        depth_range=tcams[0].depth_range,
        src_depths=torch.from_numpy(src_depths))


def _jax_inputs(cams, images, src_depths):
    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops.propagate import PatchMatchInputs

    imgs = jnp.asarray(images)
    return PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=cams[0],
        src_cams=stack_cameras(cams[1:]), src_valid=jnp.ones(N_VIEWS - 1, bool),
        depth_range=jnp.asarray(np.asarray(cams[0].depth_range), jnp.float32),
        src_depths=jnp.asarray(src_depths))


def reference_geom_pass():
    """The reference's golden geometric pass: (depth, normal_world, cost)."""
    from acmmp_spherical_tpu.pipeline.patchmatch import run_patchmatch as jrun

    cams, _, images, depths, normals = golden_scene()
    src, seed_d, seed_n = golden_geom_fields(depths, normals)
    d, n, c, _ = jrun(_jax_inputs(cams, images, src), _params(cams),
                      jax.random.key(GOLDEN_KEY),
                      seed_normal_world=jnp.asarray(seed_n),
                      seed_depth=jnp.asarray(seed_d))
    return np.asarray(d), np.asarray(n), np.asarray(c)


def build_init_reference():
    """The reference's side of (d) and (e): its prepared inputs, seeded init
    state and one geometric half-step's ``w`` and costs, on the stored
    golden geometric rectified context."""
    from acmmp_spherical_tpu.ops import propagate as JP
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context

    cams, _, images, depths, normals = golden_scene()
    params = _params(cams)
    src, seed_d, seed_n = golden_geom_fields(depths, normals)
    jin = JP.prepare_inputs(_jax_inputs(cams, images, src), params)
    check_golden_context(rect_geom=jin.rect)
    ctx = ref_tap_context(jin.ref_image, jin.ref_cam, params)
    k_init, k_iters = jax.random.split(jax.random.key(GOLDEN_KEY))
    state = JP.initialize_state(jin, params, k_init, ctx=ctx,
                                seed_normal_world=jnp.asarray(seed_n),
                                seed_depth=jnp.asarray(seed_d))
    k0, _ = jax.random.split(jax.random.fold_in(k_iters, 0))
    out = JP.checkerboard_halfstep(state, jin, ctx, params, k0, 0, 0)
    return dict(inputs=input_dict(jin), state=np_tree(state),
                halfstep_w=np.asarray(out.w),
                halfstep_cost=np.asarray(out.cost))


REFERENCES = {"ref_geom_init": build_init_reference}


@pytest.fixture(scope="module")
def reference_init(scene):
    """The reference's params and stored side of (d) and (e), and the port's
    inputs on the same context."""
    cams, _, images, depths, normals = scene
    src, seed_d, seed_n = golden_geom_fields(depths, normals)
    ref = reference_arrays("ref_geom_init", build_init_reference)
    tin = stored_port_inputs(ref["inputs"], images,
                             golden_context()["rect_geom"], src)
    seeds = dict(seed_normal_world=torch.from_numpy(seed_n),
                 seed_depth=torch.from_numpy(seed_d))
    return _params(cams), ref, tin, seeds


def test_seeded_init_matches_reference(reference_init):
    """(d)"""
    params, ref, tin, seeds = reference_init
    state = ref["state"]
    k_init, _ = TR.split(TR.key(GOLDEN_KEY))
    ts = TP.initialize_state(tin, port_params(params), k_init, **seeds)
    for f in ("normal", "w"):
        j, t = state[f], getattr(ts, f).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6, err_msg=f)
    dc = np.abs(state["cost"] - ts.cost.numpy())
    assert np.mean(dc <= 1e-4) >= 0.995, np.mean(dc <= 1e-4)
    assert (state["selected"] == ts.selected.numpy()).mean() >= 0.995


def test_geom_halfstep_from_identical_state(reference_init):
    """(e)"""
    params, ref, tin, _ = reference_init
    tstate = interop.plane_state(ref["state"], device="cpu")
    tk0, _ = TR.split(TR.fold_in(TR.split(TR.key(GOLDEN_KEY))[1], 0))
    tout = TP.checkerboard_halfstep(tstate, tin, port_params(params), tk0, 0, 0)
    j_acc = ref["halfstep_w"] != ref["state"]["w"]
    t_acc = tout.w.numpy() != tstate.w.numpy()
    assert (j_acc == t_acc).mean() >= 0.995, (j_acc == t_acc).mean()
    assert j_acc.mean() > 0.05
    dc = np.abs(ref["halfstep_cost"] - tout.cost.numpy())
    assert np.mean(dc <= 1e-4) >= 0.995, np.mean(dc <= 1e-4)


def test_geom_pass_matches_reference_fixture(scene):
    """(f)"""
    cams, tcams, images, depths, normals = scene
    src, seed_d, seed_n = golden_geom_fields(depths, normals)
    d, n, c, _ = run_patchmatch(
        _port_inputs(tcams, images, src), port_params(_params(cams)),
        GOLDEN_KEY, seed_normal_world=torch.from_numpy(seed_n),
        seed_depth=torch.from_numpy(seed_d))
    assert d.shape == (H, images.shape[2]) and bool(torch.isfinite(d).all())
    check_against_fixture(_stats(d.numpy(), n.numpy(), c.numpy()),
                          json.loads(FIXTURE_GEOM.read_text()),
                          rtol=2e-3, atol=2e-3)


def test_geom_pass_quality_near_gt_seeds(scene):
    """(g)"""
    cams, tcams, images, depths, normals = scene
    _, seed_d, seed_n = golden_geom_fields(depths, normals)
    params = dataclasses.replace(port_params(_params(cams)),
                                 rect_inv_attrib=False)
    d, _, _, _ = run_patchmatch(
        _port_inputs(tcams, images, depths[1:].copy()), params, 5,
        seed_normal_world=torch.from_numpy(seed_n),
        seed_depth=torch.from_numpy(seed_d))
    rel = np.abs(d.numpy() - depths[0]) / depths[0]
    assert np.median(rel[8:-8, 8:-8]) < 0.01, np.median(rel[8:-8, 8:-8])


if __name__ == "__main__":
    if "--regen" in sys.argv:
        regen_references(REFERENCES)
        FIXTURE_GEOM.write_text(json.dumps(_stats(*reference_geom_pass()),
                                           indent=1))
        print(f"wrote {FIXTURE_GEOM}")
