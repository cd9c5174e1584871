"""Port parity of the SPHERE camera model: cameras, geometry, the samplers
and stencils with ``wrap_x`` (the longitude seam), the exact NCC's sphere
branches, camera files, renders and the prior's host ray.

Random equirect cameras, pixels and planes from a numpy seed go through the
JAX functions and their torch counterparts.  Tolerances: geometry within 4
ulp of each value's magnitude (sphere rays go through sin/cos/asin/atan2,
whose XLA and torch CPU versions differ by an ulp or two), except the
projected pixel, within 5e-4 px of a 2048x1024 frame off the camera's poles
(x modulo the width), and the plane depth,
within 1e-5 relative where the ray meets the plane at more than ~3 degrees
(elsewhere ``-w / (n . r)`` amplifies the rays' ulps); the samplers, shifts,
candidates, priors and the median filter bit for bit, except the bicubic
sample (1e-5 relative, as the pinhole test); the exact NCC costs within
1e-4 where both are below cost_max; camera files, renders and scene
folders byte for byte.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_tpu.config import PatchMatchParams  # noqa: E402
from acmmp_spherical_tpu.core import camera as JC  # noqa: E402
from acmmp_spherical_tpu.core import geometry as JG  # noqa: E402
from acmmp_spherical_tpu.ops import candidates as JCd  # noqa: E402
from acmmp_spherical_tpu.ops import filter as JF  # noqa: E402
from acmmp_spherical_tpu.ops import ncc as JN  # noqa: E402
from acmmp_spherical_tpu.ops import sampling as JS  # noqa: E402
from acmmp_spherical_tpu.ops import view_select as JV  # noqa: E402
from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.core import camera as TC  # noqa: E402
from acmmp_spherical_torch.core import geometry as TG  # noqa: E402
from acmmp_spherical_torch.ops import candidates as TCd  # noqa: E402
from acmmp_spherical_torch.ops import filter as TF  # noqa: E402
from acmmp_spherical_torch.ops import ncc as TN  # noqa: E402
from acmmp_spherical_torch.ops import sampling as TS  # noqa: E402
from acmmp_spherical_torch.ops import view_select as TV  # noqa: E402

from torch_port_util import jax_cam_dict, port_params  # noqa: E402

W, H = 2048, 1024          # geometry frame
SW, SH, S = 64, 32, 3      # sampler / stencil / NCC frame
P = PatchMatchParams()


def _ulp_close(a, b, ulps=4):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)).max())
    assert np.all(np.abs(a - b) <= tol), np.max(np.abs(a - b)) / tol


def _sphere_camera(rng, width=W, height=H):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    kw = dict(model=JC.SPHERE, width=width, height=height, depth_min=0.5,
              depth_max=9.0,
              sphere_params=[1.0, width / 2 + rng.uniform(-3, 3),
                             height / 2 + rng.uniform(-3, 3)])
    t = rng.normal(size=3)
    return JC.make_camera(q, t, **kw), TC.make_camera(q, t, **kw, device="cpu")


def _to_port(jcam):
    return interop.camera(dict(jax_cam_dict(jcam), model=jcam.model),
                          device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    cams = [_sphere_camera(rng) for _ in range(3)]
    x = rng.uniform(0, W, (40, 50)).astype(np.float32)
    y = rng.uniform(0, H, (40, 50)).astype(np.float32)
    n = rng.normal(size=(40, 50, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(0.5, 9.0, (40, 50)).astype(np.float32)
    return cams, x, y, n, d


def test_sphere_camera_and_scale(data):
    cams, *_ = data
    for jc, tc in cams:
        assert tc.model == TC.SPHERE
        for k, v in jax_cam_dict(jc).items():
            np.testing.assert_array_equal(getattr(tc, k).numpy(), v, err_msg=k)
        assert _to_port(jc).model == TC.SPHERE
        js = JC.scale_camera(jc, 0.37, 0.41, 757, 420)
        ts = TC.scale_camera(tc, 0.37, 0.41, 757, 420)
        for k, v in jax_cam_dict(js).items():
            np.testing.assert_array_equal(getattr(ts, k).numpy(), v, err_msg=k)
    jb = JC.stack_cameras([c[0] for c in cams])
    tb = TC.stack_cameras([c[1] for c in cams])
    assert tb.model == TC.SPHERE
    np.testing.assert_array_equal(tb.params.numpy(), np.asarray(jb.params))


def test_sphere_geometry(data):
    cams, x, y, n, d = data
    for jc, tc in cams:
        tx, ty, tn, td = (torch.from_numpy(a) for a in (x, y, n, d))
        _ulp_close(JG.pixel_ray(jc, x, y), TG.pixel_ray(tc, tx, ty))
        _ulp_close(JG.view_direction(jc, x, y), TG.view_direction(tc, tx, ty))
        w = JG.dist_to_origin(jc, x, y, d, n)
        _ulp_close(w, TG.dist_to_origin(tc, tx, ty, td, tn))
        # -w / (n . r) amplifies the rays' ulps where n . r is small: held
        # where the ray meets the plane at more than ~3 degrees, 1e-5 rel.
        ok = np.abs((np.asarray(JG.pixel_ray(jc, x, y)) * n).sum(-1)) > 0.05
        np.testing.assert_allclose(
            np.asarray(JG.depth_from_plane(jc, x, y, n, w))[ok],
            TG.depth_from_plane(tc, tx, ty, tn, torch.tensor(
                np.asarray(w))).numpy()[ok], rtol=1e-5)
        X = JG.unproject_world(jc, x, y, d)
        _ulp_close(X, TG.unproject_world(tc, tx, ty, td))
        _ulp_close(JG.disparity(jc, x, y, d), TG.disparity(tc, tx, ty, td))
        for jo, to in cams:
            jx, jy, jd = JG.project(jo, X)
            px, py, pd = TG.project(to, torch.tensor(np.asarray(X)))
            _ulp_close(jd, pd)
            # held off the camera's poles (|lat| < ~82 deg: there atan2 and
            # asin are ill-conditioned), x modulo the width (a point on the
            # seam may land on either side of it)
            Xc = np.asarray(JG.world_to_cam(jo, X))
            far = np.abs(Xc[..., 1]) < 0.99 * np.linalg.norm(Xc, axis=-1)
            dx = np.remainder(np.asarray(jx) - px.numpy() + W / 2, W) - W / 2
            assert np.abs(dx[far]).max() < 5e-4
            np.testing.assert_allclose(np.asarray(jy)[far], py.numpy()[far],
                                       atol=5e-4)
    # a point at the camera centre projects to the principal point
    jc, tc = cams[0]
    C = np.asarray(JC.camera_center(jc))[None]
    px, py, pd = TG.project(tc, torch.from_numpy(C))
    assert (float(px[0]), float(py[0])) == tuple(
        float(v) for v in np.asarray(jc.params)[1:3])


@pytest.fixture(scope="module")
def seam_coords():
    """Sample coordinates that straddle the seam and the poles: x across
    [-2, W + 2], y across [-2, H + 2], plus exact seam columns."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, SW + 2, (30, 40)).astype(np.float32)
    y = rng.uniform(-2, SH + 2, (30, 40)).astype(np.float32)
    x[0, :6] = [0.0, -1.0, SW - 1.0, SW, SW - 0.5, -0.5]
    return x, y


def test_bilinear_wrap_matches_reference(seam_coords):
    x, y = seam_coords
    img = np.random.default_rng(4).uniform(0, 255, (SH + 3, SW + 5)).astype(
        np.float32)
    jv, jok = JS.sample_bilinear(jnp.asarray(img), x, y, jnp.float32(SW),
                                 jnp.float32(SH), wrap_x=True)
    pk = JS.pack_bilinear(jnp.asarray(img), jnp.float32(SW), jnp.float32(SH),
                          wrap_x=True)
    jpv, _ = JS.sample_bilinear_packed(pk, SW + 5, x, y, jnp.float32(SW),
                                       jnp.float32(SH), wrap_x=True)
    tv, tok = TS.sample_bilinear(torch.from_numpy(img), torch.from_numpy(x),
                                 torch.from_numpy(y), torch.tensor(float(SW)),
                                 torch.tensor(float(SH)), wrap_x=True)
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jpv), tv.numpy())


def test_bicubic_wrap_matches_packed16(seam_coords):
    x, y = seam_coords
    img = np.random.default_rng(5).uniform(0, 255, (SH + 3, SW + 5)).astype(
        np.float32)
    pk = JS.pack_bicubic(jnp.asarray(img), jnp.float32(SW), jnp.float32(SH),
                         wrap_x=True)
    jv, jok = JS.sample_bicubic_packed16(pk, SW + 5, jnp.asarray(x),
                                         jnp.asarray(y), jnp.float32(SW),
                                         jnp.float32(SH), wrap_x=True)
    tv, tok = TS.sample_bicubic(torch.from_numpy(img), torch.from_numpy(x),
                                torch.from_numpy(y), torch.tensor(float(SW)),
                                torch.tensor(float(SH)), wrap_x=True)
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=1e-5, atol=1e-4)


def test_nearest_trunc_wrap_matches_sdisp_lookup(seam_coords):
    """The wrapped trunc-nearest read equals the reference's inline source
    depth lookup of build_sphere_sdisp (sphere_rect.py:308-316)."""
    x, y = seam_coords
    img = np.random.default_rng(6).uniform(0, 9, (SH + 3, SW + 5)).astype(
        np.float32)
    xi = np.remainder(np.trunc(x).astype(np.int32), SW)
    yi = np.trunc(y).astype(np.int32)
    ok = (y >= 0) & (yi < SH)
    ref = img[np.clip(yi, 0, SH - 1), np.clip(xi, 0, SW + 4)]
    tv, tok = TS.sample_nearest_trunc(torch.from_numpy(img),
                                      torch.from_numpy(x), torch.from_numpy(y),
                                      torch.tensor(float(SW)),
                                      torch.tensor(float(SH)), wrap_x=True)
    np.testing.assert_array_equal(ok, tok.numpy())
    np.testing.assert_array_equal(ref[ok], tv.numpy()[ok])


@pytest.mark.parametrize("dy,dx", [(0, 1), (0, -1), (2, -5), (-3, 11),
                                   (0, SW - 1)])
def test_shift2d_wrap_at_seam(dy, dx):
    a = np.random.default_rng(7).normal(size=(2, SH, SW)).astype(np.float32)
    j = np.asarray(JS.shift2d(jnp.asarray(a), dy, dx, fill=np.inf,
                              wrap_x=True))
    t = TS.shift2d(torch.from_numpy(a), dy, dx, fill=np.inf,
                   wrap_x=True).numpy()
    np.testing.assert_array_equal(j, t)
    # the seam columns read across it
    if dy == 0:
        np.testing.assert_array_equal(t[..., SW - 1], a[..., (SW - 1 + dx) % SW])


def test_stencils_wrap_at_seam():
    rng = np.random.default_rng(8)
    n = rng.normal(size=(SH, SW, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    w = rng.uniform(-8, -1, (SH, SW)).astype(np.float32)
    cost = rng.uniform(0, 2, (SH, SW)).astype(np.float32)
    cost[:, 0] = 0.01                     # seam column wins across the seam
    j = JCd.gather_candidates(jnp.asarray(n), jnp.asarray(w),
                              jnp.asarray(cost), wrap_x=True)
    t = TCd.gather_candidates(torch.from_numpy(n), torch.from_numpy(w),
                              torch.from_numpy(cost), wrap_x=True)
    for f in ("normal", "w", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)
    assert t.valid[6, :, SW - 1].all()    # right-near region across the seam
    sel = rng.uniform(size=(S, SH, SW)) > 0.5
    nv = np.asarray(j.valid)[[0, 2, 4, 6]]
    np.testing.assert_array_equal(
        np.asarray(JV.view_selection_priors(jnp.asarray(sel), jnp.asarray(nv),
                                            P, wrap_x=True)),
        TV.view_selection_priors(torch.from_numpy(sel), torch.from_numpy(nv),
                                 P, wrap_x=True).numpy())
    d = rng.uniform(1, 10, (SH, SW)).astype(np.float32)
    c = rng.uniform(0, 0.01, (SH, SW)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(JF.checkerboard_median_filter(jnp.asarray(d),
                                                 jnp.asarray(c), wrap_x=True)),
        TF.checkerboard_median_filter(torch.from_numpy(d), torch.from_numpy(c),
                                      wrap_x=True).numpy())


def test_sphere_exact_ncc_matches_reference():
    """ref_tap_context's angular bilateral weights and multiview_ncc's
    wrapped per-source sampling on an equirect CubeRoom ring."""
    from acmmp_spherical_tpu.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
    )

    cams = make_ring_of_cameras(1 + S, model=JC.SPHERE, width=SW, height=SH)
    images, depths, normals = render_scene(cams, CubeRoom(), SW, SH)
    tcams = [_to_port(c) for c in cams]
    jctx = JN.ref_tap_context(jnp.asarray(images[0]), cams[0], P)
    tctx = TN.ref_tap_context(torch.from_numpy(images[0]), tcams[0],
                              port_params(P))
    for f in ("offsets", "ref_taps", "weights", "center", "xs", "ys"):
        np.testing.assert_allclose(np.asarray(getattr(jctx, f)),
                                   getattr(tctx, f).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    xs, ys = np.meshgrid(np.arange(SW, dtype=np.float32),
                         np.arange(SH, dtype=np.float32))
    n_cam = np.asarray(JG.normal_world_to_cam(cams[0], normals[0]))
    for scale in (1.0, 1.3):
        w = np.asarray(JG.dist_to_origin(cams[0], xs, ys, depths[0], n_cam))
        w = (w * scale).astype(np.float32)
        jcv = np.asarray(JN.multiview_ncc(
            jnp.asarray(images[1:]), JC.stack_cameras(cams[1:]), cams[0],
            jnp.asarray(n_cam), jnp.asarray(w), jctx, P))
        tcv = TN.multiview_ncc(
            torch.from_numpy(images[1:]), TC.stack_cameras(tcams[1:]),
            tcams[0], torch.from_numpy(n_cam), torch.from_numpy(w), tctx,
            port_params(P)).numpy()
        both = (jcv < P.cost_max) & (tcv < P.cost_max)
        assert ((jcv < P.cost_max) == (tcv < P.cost_max)).mean() >= 0.999
        assert np.abs(jcv - tcv)[both].max() < 1e-4


def test_sphere_camera_files_byte_identical(tmp_path):
    from acmmp_spherical_tpu.io import scene as JSc
    from acmmp_spherical_torch.io import scene as TSc

    rng = np.random.default_rng(9)
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    t = rng.normal(size=3)
    kw = dict(sphere_params=np.float32([1.0, 512.0, 256.25]), depth_min=1.2,
              depth_max=10.0, depth_interval=float(np.float32(8.8 / 191)),
              num_planes=192)
    JSc.write_camera_file(tmp_path / "j.txt", "sphere", R, t, **kw)
    TSc.write_camera_file(tmp_path / "t.txt", "sphere", R, t, **kw)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    jc = JSc.read_camera_file(tmp_path / "t.txt")
    tc = TSc.read_camera_file(tmp_path / "j.txt", device="cpu")
    assert tc.model == "sphere"
    for k, v in jax_cam_dict(jc).items():
        np.testing.assert_array_equal(getattr(tc, k).numpy(), v, err_msg=k)


def test_sphere_render_and_scene_folder_identical(tmp_path):
    from acmmp_spherical_tpu.utils import synthetic as JSy
    from acmmp_spherical_torch.utils import synthetic as TSy

    jc = JSy.make_ring_of_cameras(3, model=JC.SPHERE, width=48, height=24)
    tc = TSy.make_ring_of_cameras(3, model=TC.SPHERE, width=48, height=24,
                                  device="cpu")
    ja = JSy.render_scene(jc, JSy.CubeRoom(), 48, 24)
    ta = TSy.render_scene(tc, TSy.CubeRoom(), 48, 24)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a, b)
    JSy.write_synthetic_scene_to_disk(tmp_path / "j", jc, ja[0])
    TSy.write_synthetic_scene_to_disk(tmp_path / "t", tc, ta[0])
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert any(f.suffix == ".txt" and f.parent.name == "cams" for f in files)
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == (
            tmp_path / "t" / f).read_bytes(), f


def test_prior_sphere_ray_and_planes():
    from acmmp_spherical_tpu.pipeline import prior as JP
    from acmmp_spherical_torch.pipeline import prior as TP

    rng = np.random.default_rng(10)
    jc, tc = _sphere_camera(rng, 96, 48)
    x = rng.integers(0, 96, (20, 3)).astype(np.float32)
    y = rng.integers(0, 48, (20, 3)).astype(np.float32)
    np.testing.assert_array_equal(JP._np_pixel_ray(jc, x, y),
                                  TP._pixel_ray(tc, x, y))
    depth = rng.uniform(1, 5, (48, 96)).astype(np.float32)
    tris = np.stack([x, y], -1).astype(np.int32)
    np.testing.assert_array_equal(JP.fit_planes(jc, depth, tris),
                                  TP.fit_planes(tc, depth, tris))
