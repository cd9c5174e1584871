"""Port parity of the pole-rotated spherical path (ops/sphere_rect.py).

The equirect CubeRoom ring at 128x64 with 3 source views (4 views, the
reference's ``make_ring_of_cameras(model=SPHERE)``) goes through the JAX
package (its Pallas kernel in interpret mode) and the port (the kernel's
plain version on the CPU).  Tolerances, set by the two packages'
transcendentals (XLA's CPU asin/atan2/sin/cos against torch's, an ulp or
two apart):

* host mirrors: equal;
* the context: warped frames within 1e-4 relative on >= 99.9% of their
  pixels (the rest sample a coordinate that an ulp moved across an integer
  or the seam); transport maps agreeing on >= 99.9% of their entries (the
  rounded backward map may claim a neighbouring rotated pixel);
  ``srow`` within 1e-3 px; ``rect_sdisp`` within 1e-3 px on >= 99.5%
  (its trunc-nearest depth read takes the neighbouring source pixel, or the
  other side of the seam, where an ulp moves the coordinate across an
  integer: 0.2% of the frame here); the hoisted targets within 1e-5 where
  the backward map claims a pixel;
* ``sphere_batched_ncc`` on the reference's own context (so only the
  coefficient pre-step differs): the cost_max decisions identical, costs
  within 5e-3 everywhere and 1e-4 on >= 99% (a bf16 rounding of a
  coefficient may flip), geometric costs within 1e-4;
* ``sphere_batched_ncc`` end to end on each package's own context: the
  cost_max decisions agreeing on >= 99.9%, mean |cost difference| < 1e-3
  and < 1% of the costs more than 1e-2 apart; geometric costs more than
  1e-2 apart on < 2% (a source depth read one pixel over).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_tpu.config import PatchMatchParams  # noqa: E402
from acmmp_spherical_tpu.core import geometry as JG  # noqa: E402
from acmmp_spherical_tpu.core.camera import SPHERE, stack_cameras  # noqa: E402
from acmmp_spherical_tpu.ops import sphere_rect as JSR  # noqa: E402
from acmmp_spherical_tpu.ops.sampling import (  # noqa: E402
    checkerboard_pack, grid_coords,
)
from acmmp_spherical_tpu.utils.synthetic import (  # noqa: E402
    CubeRoom, make_ring_of_cameras, render_scene,
)
from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.core.camera import (  # noqa: E402
    stack_cameras as tstack,
)
from acmmp_spherical_torch.ops import sphere_rect as TSR  # noqa: E402

from torch_port_util import jax_cam_dict, np_tree, port_params  # noqa: E402

W, H, N_VIEWS = 128, 64, 4
PARAMS = dataclasses.replace(PatchMatchParams(), rect_tap_pack=False,
                             rect_backmap_pack=False)
CASES = [(False, None), (False, 0), (True, 1)]   # (with_geom, parity)


def _tcam(c):
    return interop.camera(dict(jax_cam_dict(c), model=c.model), device="cpu")


@pytest.fixture(scope="module")
def scene():
    cams = make_ring_of_cameras(N_VIEWS, model=SPHERE, width=W, height=H)
    images, depths, normals = render_scene(cams, CubeRoom(), W, H)
    tcams = [_tcam(c) for c in cams]
    dr = np.asarray(cams[0].depth_range)
    jctx = JSR.build_sphere_rect_context(
        jnp.asarray(images[0]), jnp.asarray(images[1:]), cams[0],
        stack_cameras(cams[1:]), (dr[0], dr[1]),
        src_depths=jnp.asarray(depths[1:]))
    tctx = TSR.build_sphere_rect_context(
        torch.from_numpy(images[0]), torch.from_numpy(images[1:]), tcams[0],
        tstack(tcams[1:]), torch.from_numpy(dr.astype(np.float32)),
        src_depths=torch.from_numpy(depths[1:]))
    xs, ys = grid_coords(H, W)
    n_cam = JG.normal_world_to_cam(cams[0], jnp.asarray(normals[0]))
    w = JG.dist_to_origin(cams[0], xs, ys, jnp.asarray(depths[0]), n_cam)
    normals_c = np.stack([np.asarray(n_cam)] * 2)      # GT, wrong plane
    ws = np.stack([np.asarray(w), np.asarray(w) * 1.3])
    return dict(cams=cams, tcams=tcams, images=images, depths=depths,
                jctx=jctx, tctx=tctx, normals=normals_c, ws=ws)


def test_host_mirrors_equal(scene):
    for w_, h_, n in ((128, 64, 4), (1024, 512, 7), (96, 48, 3)):
        cams = make_ring_of_cameras(n, model=SPHERE, width=w_, height=h_)
        tcams = [_tcam(c) for c in cams]
        js, ts = stack_cameras(cams[1:]), tstack(tcams[1:])
        assert (JSR.sphere_rectifiable(cams[0], js)
                == TSR.sphere_rectifiable(tcams[0], ts))
        for cap in (78.0, 60.0):
            assert (JSR.sphere_live_tile_count(cams[0], lat_cap_deg=cap)
                    == TSR.sphere_live_tile_count(tcams[0], lat_cap_deg=cap))
        for ms in (1.0, 0.6, 0.1):
            assert (JSR.sphere_init_window(cams[0], js, min_scale=ms)
                    == TSR.sphere_init_window(tcams[0], ts, min_scale=ms))
    # a source at the reference's centre has no pole basis
    same = stack_cameras([scene["cams"][0]] * 2)
    tsame = tstack([scene["tcams"][0]] * 2)
    assert not JSR.sphere_rectifiable(scene["cams"][0], same)
    assert not TSR.sphere_rectifiable(scene["tcams"][0], tsame)
    assert TSR.sphere_init_window(scene["tcams"][0], tsame) == 0


def test_context_matches_reference(scene):
    j, t = scene["jctx"], scene["tctx"]
    for f in ("rect_ref", "rect_src"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.shape == b.shape, f
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
        assert (rel <= 1e-4).mean() >= 0.999, (f, (rel <= 1e-4).mean())
    for jm, tm in zip(j.maps, t.maps, strict=True):
        for f in ("fwd_idx", "fwd_valid", "bwd_cidx", "bwd_x", "bwd_y",
                  "bwd_valid"):
            a, b = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
            assert (a.reshape(b.shape) == b).mean() >= 0.999, f
    for f in ("tile_oy", "tile_ox"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy())
    np.testing.assert_allclose(np.asarray(j.srow), t.srow.numpy(), atol=1e-3)
    np.testing.assert_allclose(np.asarray(j.baseline), t.baseline.numpy(),
                               rtol=1e-6)
    sd = np.abs(np.asarray(j.rect_sdisp) - t.rect_sdisp.numpy())
    assert (sd <= 1e-3).mean() >= 0.995
    claimed = np.asarray(j.maps[0].bwd_valid)
    for f in ("rays_cam", "slat", "lat"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        np.testing.assert_allclose(a[claimed], b[claimed], atol=1e-5,
                                   err_msg=f)


def test_context_reuse_rebuilds_only_sdisp(scene):
    t = scene["tctx"]
    c = scene["tcams"]
    images, depths = scene["images"], scene["depths"]
    dr = torch.tensor(np.asarray(scene["cams"][0].depth_range))
    r = TSR.build_sphere_rect_context(
        torch.from_numpy(images[0]), torch.from_numpy(images[1:]), c[0],
        tstack(c[1:]), dr, src_depths=torch.from_numpy(depths[1:] * 1.01),
        reuse=t)
    assert r.rect_ref is t.rect_ref and r.maps is t.maps
    fresh = TSR.build_sphere_sdisp(c[0], tstack(c[1:]),
                                   torch.from_numpy(depths[1:] * 1.01), (H, W))
    assert torch.equal(r.rect_sdisp, fresh)
    assert not torch.equal(r.rect_sdisp, t.rect_sdisp)


def _fields(scene, parity):
    n, w = scene["normals"], scene["ws"]
    if parity is None:
        return n, w
    return (np.moveaxis(np.asarray(checkerboard_pack(
        jnp.moveaxis(jnp.asarray(n), -1, 0), parity)), 0, -1),
        np.asarray(checkerboard_pack(jnp.asarray(w), parity)))


@pytest.fixture(scope="module")
def jax_costs(scene):
    """The reference's (cost, geom) of each case, interpret mode."""
    out = {}
    for with_geom, parity in CASES:
        n, w = _fields(scene, parity)
        r = JSR.sphere_batched_ncc(scene["jctx"], jnp.asarray(n),
                                   jnp.asarray(w), PARAMS, interpret=True,
                                   with_geom=with_geom, parity=parity)
        out[with_geom, parity] = tuple(np.asarray(a) for a in (
            r if with_geom else (r,)))
    return out


def _port_costs(scene, ctx, with_geom, parity):
    n, w = _fields(scene, parity)
    r = TSR.sphere_batched_ncc(ctx, torch.from_numpy(n), torch.from_numpy(w),
                               port_params(PARAMS), with_geom=with_geom,
                               parity=parity)
    return tuple(a.numpy() for a in (r if with_geom else (r,)))


@pytest.mark.parametrize("with_geom,parity", CASES)
def test_batched_ncc_on_reference_context(scene, jax_costs, with_geom,
                                          parity):
    ctx = interop.sphere_rect_context(np_tree(scene["jctx"]), device="cpu")
    ref = jax_costs[with_geom, parity]
    got = _port_costs(scene, ctx, with_geom, parity)
    cm = PARAMS.cost_max
    assert got[0].shape == (2, N_VIEWS - 1, H, W // (1 if parity is None
                                                     else 2))
    np.testing.assert_array_equal(ref[0] >= cm, got[0] >= cm)
    d = np.abs(ref[0] - got[0])
    assert d.max() < 5e-3 and (d <= 1e-4).mean() >= 0.99, (d.max(),
                                                          (d <= 1e-4).mean())
    # the wrong plane costs clearly more than the ground truth
    assert got[0][1].mean() > 2.0 * got[0][0].mean()
    if with_geom:
        assert np.abs(ref[1] - got[1]).max() < 1e-4


@pytest.mark.parametrize("with_geom,parity", CASES)
def test_batched_ncc_end_to_end(scene, jax_costs, with_geom, parity):
    ref = jax_costs[with_geom, parity]
    got = _port_costs(scene, scene["tctx"], with_geom, parity)
    cm = PARAMS.cost_max
    assert ((ref[0] >= cm) == (got[0] >= cm)).mean() >= 0.999
    d = np.abs(ref[0] - got[0])
    assert d.mean() < 1e-3 and (d > 1e-2).mean() < 0.01, (d.mean(),
                                                         (d > 1e-2).mean())
    if with_geom:
        assert (np.abs(ref[1] - got[1]) > 1e-2).mean() < 0.02
