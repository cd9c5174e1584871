"""Port parity: core/camera.py, core/geometry.py, core/plane.py.

Random pinhole cameras, pixels and planes from a numpy seed go through the
JAX functions and their torch counterparts.  Tolerance: 2 ulp of each
vector's largest component (the 3-term contractions may round in another
order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_tpu.core import camera as JC  # noqa: E402
from acmmp_spherical_tpu.core import geometry as JG  # noqa: E402
from acmmp_spherical_torch.core import camera as TC  # noqa: E402
from acmmp_spherical_torch.core import geometry as TG  # noqa: E402


def _ulp_close(a, b, ulps=2):
    """|a - b| <= ulps x the f32 spacing of the vector's largest component
    (a rounding-order difference in a sum is relative to its largest term)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    if a.ndim and a.shape[-1] == 3:
        mag = np.broadcast_to(mag.max(-1, keepdims=True), mag.shape)
    tol = ulps * np.spacing(mag.astype(np.float32))
    assert np.all(np.abs(a - b) <= tol), np.max(np.abs(a - b) / tol)


def _random_camera(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    K = np.array([[rng.uniform(60, 900), 0, rng.uniform(30, 500)],
                  [0, rng.uniform(60, 900), rng.uniform(30, 400)], [0, 0, 1]])
    t = rng.normal(size=3)
    kw = dict(K=K, width=640, height=480, depth_min=0.5, depth_max=9.0)
    return JC.make_camera(q, t, **kw), TC.make_camera(q, t, **kw, device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    cams = [_random_camera(rng) for _ in range(3)]
    x = rng.uniform(0, 640, (40, 50)).astype(np.float32)
    y = rng.uniform(0, 480, (40, 50)).astype(np.float32)
    n = rng.normal(size=(40, 50, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[..., 2] = -np.abs(n[..., 2])
    d = rng.uniform(0.5, 9.0, (40, 50)).astype(np.float32)
    return cams, x, y, n, d


def test_camera_fields_and_stack(data):
    cams, *_ = data
    jc = JC.stack_cameras([c[0] for c in cams])
    tc = TC.stack_cameras([c[1] for c in cams])
    for f in ("R", "t", "K", "params", "wh", "depth_range"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                      getattr(tc, f).numpy(), err_msg=f)
    _ulp_close(JC.camera_center(jc), TC.camera_center(tc))
    one = TC.camera_index(tc, 1)
    np.testing.assert_array_equal(one.R.numpy(), np.asarray(jc.R[1]))


@pytest.mark.parametrize("fn", ["pixel_ray", "view_direction"])
def test_rays(data, fn):
    cams, x, y, *_ = data
    for jcam, tcam in cams:
        a = getattr(JG, fn)(jcam, jnp.asarray(x), jnp.asarray(y))
        b = getattr(TG, fn)(tcam, torch.from_numpy(x), torch.from_numpy(y))
        _ulp_close(a, b)


def test_plane_depth_roundtrip(data):
    cams, x, y, n, d = data
    for jcam, tcam in cams:
        X, Y, Nn, Dd = map(torch.from_numpy, (x, y, n, d))
        wj = JG.dist_to_origin(jcam, x, y, jnp.asarray(d), jnp.asarray(n))
        wt = TG.dist_to_origin(tcam, X, Y, Dd, Nn)
        _ulp_close(wj, wt)
        dj = JG.depth_from_plane(jcam, x, y, jnp.asarray(n), wj)
        dt = TG.depth_from_plane(tcam, X, Y, Nn, torch.tensor(np.asarray(wj)))
        _ulp_close(dj, dt)
        # near-parallel rays take the INVALID_DEPTH sentinel in both
        par = TG.depth_from_plane(tcam, X[:1, :1], Y[:1, :1],
                                  torch.tensor([[[1.0, 0.0, 0.0]]]) * 0,
                                  torch.ones(1, 1))
        assert float(par) == TG.INVALID_DEPTH == JG.INVALID_DEPTH


def test_normal_transforms(data):
    cams, _, _, n, _ = data
    for jcam, tcam in cams:
        _ulp_close(JG.normal_cam_to_world(jcam, jnp.asarray(n)),
                   TG.normal_cam_to_world(tcam, torch.from_numpy(n)))
        _ulp_close(JG.normal_world_to_cam(jcam, jnp.asarray(n)),
                   TG.normal_world_to_cam(tcam, torch.from_numpy(n)))
        v = 3.0 * n
        _ulp_close(JG.normalize(jnp.asarray(v)),
                   TG.normalize(torch.from_numpy(v)))


def test_plane_state_and_sphere_guard():
    from acmmp_spherical_torch.core.plane import PlaneState

    s = PlaneState(normal=torch.zeros(2, 2, 3), w=torch.zeros(2, 2),
                   cost=torch.ones(2, 2), selected=torch.zeros(3, 2, 2,
                                                               dtype=bool),
                   pre_cost=torch.ones(2, 2))
    assert s.selected.shape == (3, 2, 2)
    # a SPHERE camera needs its [f, cx, cy]; with them its K is the identity
    with pytest.raises(ValueError, match="sphere_params"):
        TC.make_camera(np.eye(3), np.zeros(3), model=TC.SPHERE, device="cpu")
    cam = TC.make_camera(np.eye(3), np.zeros(3), model=TC.SPHERE,
                         sphere_params=[1, 2, 3], device="cpu")
    assert cam.params.tolist() == [1.0, 2.0, 3.0, 0.0]
    assert torch.equal(cam.K, torch.eye(3))
