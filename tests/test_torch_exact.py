"""The port's exact cost path against the reference (96x64x3src golden ring).

* ``sample_bilinear`` against the reference's
  ``sample_bilinear_packed(pack_bilinear(...))`` (the packed TPU table the
  port does not keep): equal values and masks, at coordinates inside, on
  the border of and outside the frame (numpy seed 0);
* ``ref_tap_context``: taps and centre equal, weights within 1e-6 relative
  (``exp`` may round differently);
* ``multiview_ncc`` on the ground-truth plane field and on random fields
  (``random_plane_hypothesis``, keys 0-1): ``cost_max`` masks agree on
  >= 99.9% of pixels; where neither is masked, costs within 1e-4 on >= 99.9%
  of pixels of the ground-truth field and >= 99.5% of the random ones.  The
  gap is f32 conditioning, not a rule: the random fields' grazing planes
  amplify last-ulp differences of the projections (XLA's einsum rounds in
  another order), and against a float64 run of the same function each
  package is off by more than 1e-4 on ~1.5% of those pixels, while the two
  agree with each other on ~99.65% (ROADMAP Queue 3);
* ``geom_consistency_cost`` on the ground-truth field against perturbed
  source depths: identical ``< geom_max_cost`` masks, within 1e-4;
* the exact golden pass (default parameters, key 2333) against
  tests/fixtures/golden_pass_stats.json at the CPU fixture's 2e-3.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.core.camera import stack_cameras as tstack  # noqa: E402
from acmmp_spherical_torch.ops import geom as TG  # noqa: E402
from acmmp_spherical_torch.ops import ncc as TN  # noqa: E402
from acmmp_spherical_torch.ops import sampling as TS  # noqa: E402
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch  # noqa: E402

from test_regression_fixture import (  # noqa: E402
    FIXTURE, _stats, check_against_fixture,
)
from torch_port_util import (  # noqa: E402
    H, W, golden_scene, np_tree, port_inputs, port_params,
)

KEY = 2333


@pytest.fixture(scope="module")
def scene():
    from acmmp_spherical_tpu.config import PatchMatchParams
    from acmmp_spherical_tpu.core import geometry as G
    from acmmp_spherical_tpu.core.camera import stack_cameras
    from acmmp_spherical_tpu.ops import rng as JR
    from acmmp_spherical_tpu.ops.ncc import ref_tap_context
    from acmmp_spherical_tpu.ops.sampling import grid_coords

    cams, tcams, images, depths, normals = golden_scene()
    params = PatchMatchParams()
    xs, ys = grid_coords(H, W)
    n = G.normal_world_to_cam(cams[0], jnp.asarray(normals[0]))
    fields = {"gt": (n, G.dist_to_origin(cams[0], xs, ys,
                                         jnp.asarray(depths[0]), n))}
    dr = cams[0].depth_range
    for k in (0, 1):
        fields[f"random{k}"] = JR.random_plane_hypothesis(
            jax.random.key(k), cams[0], xs, ys, dr[0], dr[1])
    ctx = ref_tap_context(jnp.asarray(images[0]), cams[0], params)
    return dict(cams=cams, src_cams=stack_cameras(cams[1:]), tcams=tcams,
                images=images, depths=depths, params=params, fields=fields,
                ctx=ctx, tctx=interop.ref_tap_context(np_tree(ctx), "cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_sample_bilinear_matches_packed_reference():
    from acmmp_spherical_tpu.ops.sampling import (
        pack_bilinear, sample_bilinear_packed,
    )

    rng = np.random.default_rng(0)
    hp, wp, h, w = 40, 70, 37, 64        # padded storage, logical frame
    img = rng.random((hp, wp)).astype(np.float32) * 255.0
    x = rng.uniform(-3.0, w + 3.0, (500,)).astype(np.float32)
    y = rng.uniform(-3.0, h + 3.0, (500,)).astype(np.float32)
    x[:4] = [0.0, w - 1.0, w - 0.5, w - 1e-3]      # borders, exactly
    y[4:8] = [0.0, h - 1.0, h - 0.5, h - 1e-3]
    jv, jok = sample_bilinear_packed(
        pack_bilinear(jnp.asarray(img), jnp.float32(w), jnp.float32(h),
                      wrap_x=False),
        wp, jnp.asarray(x), jnp.asarray(y), jnp.float32(w), jnp.float32(h),
        wrap_x=False)
    tv, tok = TS.sample_bilinear(_t(img), _t(x), _t(y), float(w), float(h))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_sample_nearest_trunc_matches_reference():
    from acmmp_spherical_tpu.ops.sampling import sample_nearest_trunc

    rng = np.random.default_rng(1)
    img = rng.random((40, 70)).astype(np.float32)
    x = rng.uniform(-3.0, 67.0, (500,)).astype(np.float32)
    y = rng.uniform(-3.0, 40.0, (500,)).astype(np.float32)
    jv, jok = sample_nearest_trunc(jnp.asarray(img), jnp.asarray(x),
                                   jnp.asarray(y), jnp.float32(64),
                                   jnp.float32(37))
    tv, tok = TS.sample_nearest_trunc(_t(img), _t(x), _t(y), 64.0, 37.0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_ref_tap_context_matches(scene):
    ctx = scene["ctx"]
    t = TN.ref_tap_context(torch.from_numpy(scene["images"][0]),
                           scene["tcams"][0], port_params(scene["params"]))
    for f in ("offsets", "ref_taps", "center", "xs", "ys"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(ctx, f)), err_msg=f)
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(ctx.weights),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("field", ["gt", "random0", "random1"])
def test_multiview_ncc_matches(scene, field):
    from acmmp_spherical_tpu.ops.ncc import multiview_ncc

    s = scene
    n, w = s["fields"][field]
    ref = np.asarray(multiview_ncc(jnp.asarray(s["images"][1:]),
                                   s["src_cams"], s["cams"][0], n, w,
                                   s["ctx"], s["params"]))
    out = TN.multiview_ncc(torch.from_numpy(s["images"][1:]),
                           tstack(s["tcams"][1:]), s["tcams"][0], _t(n),
                           _t(w), s["tctx"], port_params(s["params"])).numpy()
    cmax = s["params"].cost_max
    bad_j, bad_t = ref >= cmax, out >= cmax
    assert (bad_j == bad_t).mean() >= 0.999, (bad_j == bad_t).mean()
    live = ~bad_j & ~bad_t
    assert live.mean() > 0.3
    close = (np.abs(out - ref)[live] <= 1e-4).mean()
    assert close >= (0.999 if field == "gt" else 0.995), close


def test_geom_consistency_cost_matches(scene):
    from acmmp_spherical_tpu.ops.geom import geom_consistency_cost

    s = scene
    n, w = s["fields"]["gt"]
    i = np.arange(s["depths"][1:].size).reshape(s["depths"][1:].shape)
    dep = (s["depths"][1:] * (1.0 + 0.01 * np.cos(i))).astype(np.float32)
    ref = np.asarray(geom_consistency_cost(
        jnp.asarray(dep), s["src_cams"], s["cams"][0], n, w, s["ctx"].xs,
        s["ctx"].ys, s["params"]))
    out = TG.geom_consistency_cost(
        torch.from_numpy(dep), tstack(s["tcams"][1:]), s["tcams"][0], _t(n),
        _t(w), s["tctx"].xs, s["tctx"].ys, port_params(s["params"])).numpy()
    gmax = s["params"].geom_max_cost
    ok = ref < gmax
    np.testing.assert_array_equal(out < gmax, ok)
    assert ok.mean() > 0.5
    assert np.abs(out - ref)[ok].max() <= 1e-4


def test_exact_golden_pass_matches_fixture(scene):
    s = scene
    d, n, c, _ = run_patchmatch(port_inputs(s["tcams"], s["images"]),
                                port_params(s["params"]), KEY)
    assert d.shape == (H, W) and bool(torch.isfinite(d).all())
    check_against_fixture(_stats(d.numpy(), n.numpy(), c.numpy()),
                          json.loads(FIXTURE.read_text()),
                          rtol=2e-3, atol=2e-3)
    rel = np.abs(d.numpy() - s["depths"][0]) / s["depths"][0]
    assert np.median(rel[8:-8, 8:-8]) < 0.01
