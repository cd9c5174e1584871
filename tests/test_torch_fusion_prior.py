"""The port's planar-prior build, JBU and fusion against the JAX package's.

* ``build_planar_prior`` on the golden ring's ground-truth depth with a
  patterned cost and on a depth/cost pair from a noisy field: support
  points, triangles, prior normals, offsets and mask equal (both are the
  same numpy and OpenCV code on the same float32 camera); the overlay of
  ``draw_triangulation`` equal; the native support points equal the numpy
  fallback's;
* ``joint_bilateral_upsample`` of a depth map and of a normal field (2x,
  25 taps) within 1e-5 relative (exp and the weight sums round differently
  in XLA);
* ``fuse_reference_view`` and ``fuse_reference_view_dynamic`` on the golden
  ring's ground-truth depths, perturbed per view so some sources disagree:
  identical validity masks and emitted points, normals and colours within
  1e-5 (XLA contracts the projections into multiply-adds); ``fuse_all_views``
  emits the same number of points.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.config import FusionParams, PriorConfig  # noqa: E402
from acmmp_spherical_torch.core.camera import stack_cameras  # noqa: E402
from acmmp_spherical_torch.ops import fusion as TF  # noqa: E402
from acmmp_spherical_torch.ops.jbu import joint_bilateral_upsample  # noqa: E402
from acmmp_spherical_torch.pipeline import prior as TPR  # noqa: E402

from torch_port_util import golden_scene  # noqa: E402


@pytest.fixture(scope="module")
def scene():
    return golden_scene()


def _costs(depths):
    H, W = depths.shape[1:]
    ys, xs = np.mgrid[0:H, 0:W]
    rng = np.random.default_rng(11)
    return {
        "pattern": (depths[0], np.where((xs // 12 + ys // 12) % 4 == 0, 0.5,
                                        0.05).astype(np.float32)),
        "noisy": ((depths[0] * (1 + 0.01 * rng.standard_normal((H, W))))
                  .astype(np.float32),
                  rng.uniform(0.0, 0.4, (H, W)).astype(np.float32)),
    }


@pytest.mark.parametrize("case", ["pattern", "noisy"])
def test_planar_prior_matches_reference(scene, case):
    from acmmp_spherical_tpu.config import PriorConfig as JPriorConfig
    from acmmp_spherical_tpu.pipeline import prior as JPR

    cams, tcams, images, depths, _ = scene
    depth, cost = _costs(depths)[case]
    dmin, dmax = np.asarray(cams[0].depth_range)
    j = JPR.build_planar_prior(cams[0], depth, cost, 0.6 * dmin, 1.2 * dmax,
                               JPriorConfig())
    t = TPR.build_planar_prior(tcams[0], depth, cost, 0.6 * dmin, 1.2 * dmax,
                               PriorConfig())
    assert j[2].mean() > 0.3 and len(j[3]) > 20
    for a, b, name in zip(t, j, ("normal", "w", "mask", "triangles")):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(TPR.draw_triangulation(images[0], t[3]),
                                  JPR.draw_triangulation(images[0], j[3]))


def test_support_points_native_matches_numpy(scene, monkeypatch):
    from acmmp_spherical_torch.io import native

    _, _, _, depths, _ = scene
    cost = _costs(depths)["noisy"][1]
    assert native.available()
    pts = TPR.get_support_points(cost, PriorConfig())
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(TPR.get_support_points(cost, PriorConfig()),
                                  pts)


@pytest.mark.parametrize("field", ["depth", "normal"])
def test_jbu_matches_reference(scene, field):
    from acmmp_spherical_tpu.ops.jbu import joint_bilateral_upsample as jjbu

    _, _, images, depths, normals = scene
    coarse = (depths[0][::2, ::2] if field == "depth"
              else normals[0][::2, ::2]).astype(np.float32)
    j = np.asarray(jjbu(jnp.asarray(coarse), jnp.asarray(images[0])))
    t = joint_bilateral_upsample(torch.from_numpy(coarse),
                                 torch.from_numpy(images[0])).numpy()
    assert t.shape == j.shape == images[0].shape + coarse.shape[2:]
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def _fusion_inputs(scene):
    cams, tcams, images, depths, normals = scene
    V, H, W = depths.shape
    i = np.arange(H * W).reshape(H, W)
    d = np.stack([depths[v] * (1 + 0.004 * v * np.sin(i + v))
                  for v in range(V)]).astype(np.float32)
    d[1, :5] = 0.0                       # no depth on a few rows
    colors = np.stack([images] * 3, -1).astype(np.float32)
    src = np.array([[j for j in range(V) if j != v] + [-1] for v in range(V)],
                   np.int32)
    return cams, tcams, d, normals.astype(np.float32), colors, src


@pytest.mark.parametrize("variant", ["gpu_path", "dynamic"])
def test_fuse_reference_view_matches_reference(scene, variant):
    from acmmp_spherical_tpu.config import FusionParams as JFusionParams
    from acmmp_spherical_tpu.core.camera import stack_cameras as jstack
    from acmmp_spherical_tpu.ops import fusion as JF

    cams, tcams, d, n, c, src = _fusion_inputs(scene)
    jfn, tfn = {"gpu_path": (JF.fuse_reference_view, TF.fuse_reference_view),
                "dynamic": (JF.fuse_reference_view_dynamic,
                            TF.fuse_reference_view_dynamic)}[variant]
    tc = stack_cameras(tcams)
    for ref in range(len(cams)):
        j = [np.asarray(a) for a in jfn(
            jnp.asarray(d), jnp.asarray(n), jnp.asarray(c), jstack(cams),
            jnp.asarray(ref), jnp.asarray(src[ref]), JFusionParams())]
        t = [a.numpy() for a in tfn(
            torch.from_numpy(d), torch.from_numpy(n), torch.from_numpy(c), tc,
            ref, src[ref], FusionParams())]
        np.testing.assert_array_equal(t[3], j[3])
        assert 0.2 < j[3].mean() < 1.0, j[3].mean()
        v = j[3]
        for a, b in zip(t[:3], j[:3]):
            np.testing.assert_allclose(a[v], b[v], rtol=1e-5, atol=1e-5)


def test_fuse_all_views_matches_reference(scene):
    from acmmp_spherical_tpu.config import FusionParams as JFusionParams
    from acmmp_spherical_tpu.core.camera import stack_cameras as jstack
    from acmmp_spherical_tpu.ops import fusion as JF

    cams, tcams, d, n, c, src = _fusion_inputs(scene)
    j = JF.fuse_all_views(jnp.asarray(d), jnp.asarray(n), jnp.asarray(c),
                          jstack(cams), src, JFusionParams())
    t = TF.fuse_all_views(torch.from_numpy(d), torch.from_numpy(n),
                          torch.from_numpy(c), stack_cameras(tcams), src,
                          FusionParams())
    assert len(t[0]) == len(j[0]) > 1000
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=1e-5)
