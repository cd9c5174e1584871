"""Port parity: ops/rng.py and its threefry2x32 against jax.random
(JAX 0.9.0, jax_threefry_partitionable=True).

Tolerances: keys, bits and uniforms bit-exact.  Normal draws within 2 ulp
of their magnitude, on fewer than 1 in 1000 elements: the port reproduces
XLA's f32 erf_inv polynomial and its CPU log1p, up to float64 double
rounding of the emulated fused multiply-adds.  Plane-field normals within
8 ulp: the reference's rsqrt normalisation is XLA's CPU approximation, the
port's is torch's (ROADMAP Queue 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_tpu.ops import rng as JR  # noqa: E402
from acmmp_spherical_torch.ops import rng as TR  # noqa: E402

SEEDS = [0, 1, 2333, 2 ** 31 - 1]


def _kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.max(np.abs(a - b) / np.spacing(np.maximum(mag, 1e-30)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, tk = jax.random.key(seed), TR.key(seed)
    assert _kd(jk) == tk
    for num in (2, 4, 5):
        js = jax.random.split(jk, num)
        assert [_kd(k) for k in js] == TR.split(tk, num)
    for data in (0, 1, 7, 2 ** 31):
        assert _kd(jax.random.fold_in(jk, data)) == TR.fold_in(tk, data)


@pytest.mark.parametrize("shape", [(7,), (64, 48), (15, 8, 40), (3, 5, 7, 3)])
def test_bits_bit_exact(shape):
    for seed in SEEDS[:3]:
        jb = np.asarray(jax.random.bits(jax.random.key(seed), shape))
        tb = TR.bits(TR.key(seed), shape, "cpu").numpy()
        np.testing.assert_array_equal(jb.astype(np.int64), tb)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 0.5), (0.0, 0.9375),
                                   (1.2, 10.0), (0.3, 7.7)])
def test_uniform_bit_exact(lo, hi):
    for seed in SEEDS:
        k = jax.random.key(seed)
        lo32, hi32 = jnp.float32(lo), jnp.float32(hi)    # traced-range form
        ju = np.asarray(jax.random.uniform(k, (96, 48), jnp.float32, lo32,
                                           hi32))
        tu = TR.uniform(TR.key(seed), (96, 48), "cpu", torch.tensor(lo),
                        torch.tensor(hi)).numpy()
        np.testing.assert_array_equal(ju, tu)


def test_normal_within_ulps():
    for seed in SEEDS:
        jn = np.asarray(jax.random.normal(jax.random.key(seed), (64, 96, 3)))
        tn = TR.normal(TR.key(seed), (64, 96, 3), "cpu").numpy()
        assert _ulps(jn, tn) <= 2.0
        assert np.mean(jn != tn) < 1e-3


def test_plane_hypotheses_and_perturbation():
    from acmmp_spherical_tpu.core.camera import make_camera as jcam_
    from acmmp_spherical_tpu.ops.sampling import grid_coords as jgrid
    from acmmp_spherical_torch.core.camera import make_camera as tcam_
    from acmmp_spherical_torch.ops.sampling import grid_coords as tgrid

    K = np.array([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]])
    kw = dict(K=K, width=96, height=64, depth_min=1.2, depth_max=10.0)
    jc = jcam_(np.eye(3), np.zeros(3), **kw)
    tc = tcam_(np.eye(3), np.zeros(3), **kw, device="cpu")
    jx, jy = jgrid(64, 96)
    tx, ty = tgrid(64, 96, "cpu")
    for seed in (0, 11):
        jn, jw = JR.random_plane_hypothesis(jax.random.key(seed), jc, jx, jy,
                                            jnp.float32(1.2), jnp.float32(10.0))
        tn, tw = TR.random_plane_hypothesis(TR.key(seed), tc, tx, ty,
                                            torch.tensor(1.2), torch.tensor(10.0))
        assert _ulps(jn, tn) <= 8.0
        np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=1e-5,
                                   atol=1e-5)
        jp = JR.perturbed_normal(jax.random.key(seed + 1), jc, jx, jy, jn,
                                 0.02 * np.pi)
        tp = TR.perturbed_normal(TR.key(seed + 1), tc, tx, ty,
                                 torch.tensor(np.asarray(jn)), 0.02 * np.pi)
        np.testing.assert_allclose(np.asarray(jp), tp.numpy(), atol=2e-6)
    u = torch.tensor([0.0, 0.5, 0.999])
    d = TR.sample_depth_inv(u, torch.tensor(1.2), torch.tensor(10.0)).numpy()
    jd = np.asarray(JR.sample_depth_inv(jnp.asarray(u.numpy()), 1.2, 10.0))
    np.testing.assert_allclose(d, jd, rtol=1e-6)
