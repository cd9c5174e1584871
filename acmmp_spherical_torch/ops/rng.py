"""Counter-based randomness bit-identical to ``jax.random`` (threefry2x32).

Counterpart of acmmp_spherical_tpu/ops/rng.py, plus the generator itself:
the reference draws every random number from ``jax.random`` with the
threefry2x32 PRNG and ``jax_threefry_partitionable=True`` (JAX 0.9.0), so a
pass of the port that starts from the same key draws the same numbers and
the two packages can be compared pixel by pixel, not only in distribution.

A key is a pair of Python ints ``(k1, k2)`` (each < 2**32): key derivation
(``split``, ``fold_in``) is a handful of scalar hashes and runs on the host.
Bulk bits run on the tensors' device as int64 arithmetic masked to 32 bits.
Each element hashes its flat index in the drawn shape, so a ``Cols`` window
draws a band of columns of a larger frame's draw without drawing the rest:
a width tile of the tile-parallel pass draws the numbers that the one-slot
pass draws at its pixels.

``normal`` is ``sqrt(2) * erfinv(u)`` as in jax.random, with XLA's own
erf_inv polynomial and CPU log1p re-implemented (``torch.log1p`` and
``torch.erfinv`` differ from them in the last ulps), so normals agree within
2 ulp while ``bits`` and ``uniform`` agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from acmmp_spherical_torch.core import geometry as G
from acmmp_spherical_torch.core.camera import Camera
from acmmp_spherical_torch.utils.log import span

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple


def _threefry(k1, k2, x0, x1, rotl, m32):
    """threefry2x32 (jax/_src/prng.py _threefry2x32_lowering), generic over
    Python ints and int64 tensors; ``rotl`` and ``m32`` supply the ops."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = m32(x0 + ks[0])
    x1 = m32(x1 + ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = m32(x0 + x1)
            x1 = x0 ^ rotl(x1, r)
        x0 = m32(x0 + ks[(i + 1) % 3])
        x1 = m32(x1 + ks[(i + 2) % 3] + i + 1)
    return x0, x1


def _py_rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry_py(k1: int, k2: int, x0: int, x1: int) -> tuple[int, int]:
    return _threefry(k1, k2, x0, x1, _py_rotl, lambda v: v & _M32)


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed in [0, 2**31): data ``(0, seed)``."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return (0, seed)


def split(k: Key, num: int = 2) -> list:
    """``jax.random.split`` under jax_threefry_partitionable: key i is
    threefry(k, (0, i))."""
    return [_threefry_py(k[0], k[1], 0, i) for i in range(num)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: threefry(k, threefry_seed(data)) = hash of the
    count pair (0, data)."""
    return _threefry_py(k[0], k[1], 0, int(data) & _M32)


@dataclasses.dataclass(frozen=True)
class Cols:
    """A column window of a draw: the drawn shape's column axis holds
    columns ``x0, x0 + 1, ...`` (taken modulo ``width``, so a window may
    run across a longitude seam) of the same draw over a frame ``width``
    columns wide."""

    x0: int
    width: int


def _flat_index(shape, device, cols: Optional[Cols], axis: int):
    """int64 flat index, in the frame's draw, of each element of ``shape``
    (``cols`` on axis ``axis``; None: the shape is the frame)."""
    if cols is None:
        return torch.arange(math.prod(shape), dtype=torch.int64,
                            device=device)
    axis %= len(shape)
    lead, trail = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
    col = torch.remainder(
        cols.x0 + torch.arange(shape[axis], dtype=torch.int64, device=device),
        cols.width)
    row = torch.arange(lead, dtype=torch.int64, device=device)
    t = torch.arange(trail, dtype=torch.int64, device=device)
    return ((row[:, None, None] * cols.width + col[None, :, None]) * trail
            + t[None, None, :]).reshape(-1)


@span("rng")
def bits(k: Key, shape, device, cols: Optional[Cols] = None,
         axis: int = -1) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2**32)), equal to
    ``jax.random.bits(k, shape)``: hash of the flat index, words xor-ed.
    With ``cols`` the elements are those of the window ``cols`` of the
    draw over the frame's shape (``shape`` with ``cols.width`` on axis
    ``axis``), bit for bit."""
    idx = _flat_index(tuple(shape), device, cols, axis)
    m32 = lambda v: v & _M32
    rotl = lambda v, r: ((v << r) | (v >> (32 - r))) & _M32
    b1, b2 = _threefry(k[0], k[1], idx >> 32, idx & _M32, rotl, m32)
    return (b1 ^ b2).reshape(shape)


def uniform(k: Key, shape, device, lo=0.0, hi=1.0,
            cols: Optional[Cols] = None, axis: int = -1) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, lo, hi)``: mantissa bits with
    exponent 1, minus 1, scaled; ``lo``/``hi`` may be 0-d tensors.  XLA fuses
    the scale ``f * (hi - lo) + lo`` into one multiply-add: it is taken in
    float64 (the f32 product is exact there) and rounded once to f32.
    ``cols``, ``axis``: a column window, as in :func:`bits`."""
    fb = ((bits(k, shape, device, cols, axis) >> 9)
          | 0x3F800000).to(torch.int32)
    f = fb.view(torch.float32) - 1.0
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def _f32(*vals) -> tuple:
    """Python floats rounded to float32 (XLA's constants are f32)."""
    return tuple(torch.tensor(vals, dtype=torch.float32).tolist())


_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
# XLA's single-precision ErfInv (Giles' polynomial), which jax.random.normal
# reaches through lax.erf_inv: w < 5 and w >= 5 coefficient sets
_ERFINV_LT5 = _f32(2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = _f32(-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU f32 log (Cephes logf) and log1p (Cephes rational form below
# sqrt(2) - 1) coefficients
_LOG_P = _f32(7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
              -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
              2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2, _SQRT_HALF, _LOG1P_SMALL = _f32(
    -2.12194440e-4, 0.693359375, 0.707106781186547524, 0.41421356237309504880)
_LOG1P_NUM = _f32(4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                  6.5787325942061044846969e0, 2.9911919328553073277375e1,
                  6.0949667980987787057556e1, 5.7112963590585538103336e1,
                  2.0039553499201281259648e1)
_LOG1P_DEN = _f32(1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
                  2.2176239823732856465394e2, 3.0909872225312059774938e2,
                  2.1642788614495947685003e2, 6.0118660497603843919306e1)
_F32_MIN_NORMAL = 2.0 ** -126


def _fma(a, b, c) -> torch.Tensor:
    """f32 fused multiply-add, as XLA's CPU backend contracts ``a * b + c``:
    the product is exact in float64, the sum rounds once to f32 (after its
    float64 rounding, which differs from a true fma only in rare ties)."""
    a = torch.as_tensor(a, dtype=torch.float64)
    return (a * b + c).to(torch.float32)


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 ``log`` for positive normal inputs: mantissa in
    [sqrt(1/2), sqrt(2)), Cephes polynomial with fused multiply-adds, the
    exponent added back as the split ln 2 (q1 + q2)."""
    bits = torch.clamp(x, min=_F32_MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    below = m < _SQRT_HALF
    t = (m - 1.0) + torch.where(below, m, 0.0)
    e = e - below.to(torch.float32)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y, y1, y2 = _fma(t, p[0], p[1]), _fma(t, p[3], p[4]), _fma(t, p[6], p[7])
    y, y1, y2 = _fma(y, t, p[2]), _fma(y1, t, p[5]), _fma(y2, t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = y * x3 + _LOG_Q1 * e
    return ((t - 0.5 * x2) + y) + _LOG_Q2 * e


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 ``log1p`` for x > -1: a rational approximation for
    |x| < sqrt(2) - 1, else ``log(1 + x)``."""
    def poly(coefs):
        r = torch.zeros_like(x)
        for c in coefs:
            r = _fma(r, x, c)
        return r

    x2 = x * x
    small = x + _fma(x2, -0.5, (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)))
    return torch.where(x.abs() < _LOG1P_SMALL, small, _xla_log(1.0 + x))


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf_inv for |x| <= 1, with XLA's CPU log1p and its fused
    multiply-adds, so it matches the reference to an ulp or two on a few
    elements in 10^4 (float64 double rounding and XLA's log where the port's
    emulation of it is an ulp off)."""
    w = -_xla_log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])
    p = coef(0)
    for i in range(1, 9):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(k: Key, shape, device, cols: Optional[Cols] = None,
           axis: int = -1) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1));
    ``cols``, ``axis`` as in :func:`bits`."""
    u = uniform(k, shape, device, _NORMAL_LO, 1.0, cols, axis)
    return _erfinv(u) * math.sqrt(2.0)


def sample_depth_inv(u, dmin, dmax) -> torch.Tensor:
    """Uniform-in-inverse-depth sample (reference SampleDepthInv,
    ACMMP.cu:14-22)."""
    dmin = torch.clamp(dmin, min=1e-6)
    dmax = torch.maximum(dmax, dmin + 1e-6)
    inv_min = 1.0 / dmax
    inv_max = 1.0 / dmin
    return 1.0 / (inv_min + u * (inv_max - inv_min))


def random_normal_toward_viewer(k: Key, cam: Camera, xs, ys,
                                cols: Optional[Cols] = None) -> torch.Tensor:
    """Uniform-on-sphere unit normals flipped to face the viewer (reference
    GenerateRandomNormal, ACMMP.cu:194-220).  Returns (H, W, 3); ``cols``:
    the columns of ``xs`` in the frame's draw."""
    n = G.normalize(normal(k, tuple(xs.shape) + (3,), xs.device, cols, -2))
    vd = G.view_direction(cam, xs, ys)
    flip = (n * vd).sum(-1, keepdim=True) > 0.0
    return torch.where(flip, -n, n)


def perturbed_normal(k: Key, cam: Camera, xs, ys, normal_, perturbation,
                     cols: Optional[Cols] = None):
    """Euler-angle perturbation of per-pixel normals (reference
    GeneratePerturbedNormal, ACMMP.cu:222-257); keeps the original where the
    perturbed normal faces away from the viewer.  ``cols``: the columns of
    ``xs`` in the frame's draw."""
    a = uniform(k, tuple(xs.shape) + (3,), xs.device, -0.5, 0.5, cols,
                -2) * perturbation
    s1, s2, s3 = torch.sin(a).unbind(-1)
    c1, c2, c3 = torch.cos(a).unbind(-1)
    nx, ny, nz = normal_.unbind(-1)
    px = (c2 * c3) * nx + (c3 * s1 * s2 - c1 * s3) * ny + (s1 * s3 + c1 * c3 * s2) * nz
    py = (c2 * s3) * nx + (c1 * c3 + s1 * s2 * s3) * ny + (c1 * s2 * s3 - c3 * s1) * nz
    pz = (-s2) * nx + (c2 * s1) * ny + (c1 * c2) * nz
    p = torch.stack([px, py, pz], -1)
    vd = G.view_direction(cam, xs, ys)
    keep = (p * vd).sum(-1, keepdim=True) >= 0.0
    return G.normalize(torch.where(keep, normal_, p))


def random_plane_hypothesis(k: Key, cam: Camera, xs, ys, depth_min,
                            depth_max, cols: Optional[Cols] = None):
    """Fresh random plane field (reference ACMMP.cu:259-265); ``cols``: the
    columns of ``xs`` in the frame's draw.  Returns (normal (H, W, 3),
    w (H, W))."""
    kd, kn = split(k)
    depth = uniform(kd, tuple(xs.shape), xs.device, depth_min, depth_max,
                    cols)
    n = random_normal_toward_viewer(kn, cam, xs, ys, cols)
    return n, G.dist_to_origin(cam, xs, ys, depth, n)
