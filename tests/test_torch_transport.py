"""Port parity: kernel 2's plain version, ``coefficient_transport_plain``
(the coefficient tables of C plane fields gathered onto the compact live
pixels), against the reference's own pre-step plus its Pallas transport
(``acmmp_spherical_tpu.ops.pallas.ncc_rect.warp_transport``, interpret
mode), for the full map and both parity maps, and on edge fields.  The CUDA
kernel against this plain version: tests/test_torch_gpu.py.

The reference's pre-step (``rect_batched_ncc``, ncc_rect.py:550-566) is
reproduced here and run op by op (eagerly), with its einsum written as the
left-to-right sum ``(n0 R[i,0] + n1 R[i,1]) + n2 R[i,2]``: under ``jit``, and
in its einsum, XLA's CPU backend contracts products and sums into fused
multiply-adds, which round differently on about a third of the elements.
Run op by op, every operation rounds once, as in the port and on the card.

Tolerance: D and the packed AB words bit for bit, NaN words included;
against the jitted einsum pre-step, D within 4e-6 relative + 1e-6 absolute
(a few ulp of disparities of a few tens of pixels) and A, B within one bf16
step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_tpu.core import geometry as JG  # noqa: E402
from acmmp_spherical_tpu.core.camera import stack_cameras as jstack  # noqa: E402
from acmmp_spherical_tpu.ops import rectify as JRT  # noqa: E402
from acmmp_spherical_tpu.ops.pallas import ncc_rect as JNR  # noqa: E402
from acmmp_spherical_tpu.ops.sampling import (  # noqa: E402
    checkerboard_pack, grid_coords,
)
from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.ops.kernels import _lib  # noqa: E402
from acmmp_spherical_torch.ops.kernels import ncc_rect as TNR  # noqa: E402

from torch_port_util import H, W, golden_scene, np_tree, rect_params  # noqa: E402

S2 = 2
PARITIES = [None, 0, 1]


@pytest.fixture(scope="module")
def setup():
    cams, _, images, depths, normals = golden_scene()
    p = rect_params(cams)
    ctx = JRT.build_rect_context(
        jnp.asarray(images[0]), jnp.asarray(images[1:]), cams[0],
        jstack(cams[1:]), (cams[0].depth_range[0], cams[0].depth_range[1]),
        comp_hw=p.rect_comp_hw, live_n=p.rect_live_n, warp_hw=p.rect_warp_hw,
        inv_attrib=True)
    ctx = jax.tree.map(lambda a: a[:S2], ctx)
    xs, ys = grid_coords(H, W)
    n_cam = np.asarray(JG.normal_world_to_cam(cams[0], jnp.asarray(normals[0])))
    w = np.asarray(JG.dist_to_origin(cams[0], xs, ys, jnp.asarray(depths[0]),
                                     jnp.asarray(n_cam)))
    rng = np.random.default_rng(7)
    tilt = rng.normal(size=n_cam.shape).astype(np.float32) * 0.3
    n_tilt = n_cam + tilt
    n_tilt /= np.linalg.norm(n_tilt, axis=-1, keepdims=True)
    planes = (np.stack([n_cam, n_cam, n_tilt]).astype(np.float32),
              np.stack([w, w * 1.2, w * 0.9]).astype(np.float32))
    d = np_tree(ctx)
    d["maps"] = [{k: m[k] for k in ("fwd_idx", "fwd_valid", "bwd_cidx", "bwd_x",
                                    "bwd_y", "bwd_valid")} for m in d["maps"]]
    return p, ctx, interop.rect_context(d, device="cpu"), planes


def _packed(planes, parity):
    n, w = planes
    if parity is None:
        return n, w
    return (np.array(jnp.moveaxis(checkerboard_pack(
        jnp.moveaxis(jnp.asarray(n), -1, 1), parity), 1, -1)),
            np.array(checkerboard_pack(jnp.asarray(w), parity)))


def _reference_prestep(ctx, maps, normals, ws):
    """ncc_rect.py:550-566 of the reference, op by op: D and pack_ab(A, B)
    on the evaluation grid, (S, C, H, Wg)."""
    C, Hg, Wg = ws.shape
    S = ctx.pr.R_rr.shape[0]
    R = ctx.pr.R_rr[:, None, :, :, None, None]            # (S, 1, 3, 3, 1, 1)
    n = jnp.moveaxis(jnp.asarray(normals), -1, 1)[None]    # (1, C, 3, H, Wg)
    n_r = [n[:, :, 0] * R[:, :, i, 0] + n[:, :, 1] * R[:, :, i, 1]
           + n[:, :, 2] * R[:, :, i, 2] for i in range(3)]
    f = ctx.pr.K[:, 0][:, None, None, None]
    wply = jnp.asarray(ws)[None]
    scale = -ctx.pr.baseline[:, None, None, None] / jnp.where(
        jnp.abs(wply) < 1e-20, 1e-20, wply)
    A = scale * n_r[0]
    B = scale * n_r[1]
    cterm = scale * n_r[2] * f
    cx = ctx.pr.K[:, 1][:, None, None, None]
    cy = ctx.pr.K[:, 2][:, None, None, None]
    off_x = ctx.srow[:, 3][:, None, None, None]
    off_y = ctx.srow[:, 2][:, None, None, None]
    xb = maps.bwd_x.astype(jnp.float32).reshape(S, 1, Hg, Wg)
    yb = maps.bwd_y.astype(jnp.float32).reshape(S, 1, Hg, Wg)
    D = A * (xb + off_x - cx) + B * (yb + off_y - cy) + cterm
    D = jnp.where(jnp.isfinite(D) & (jnp.abs(D) < 1e8), D, -1e9)
    return D, JNR.pack_ab(A, B)


def _reference(p, ctx, parity, normals, ws):
    maps = ctx.maps[0 if parity is None else 1 + parity]
    D, AB = _reference_prestep(ctx, maps, normals, ws)
    win = JRT.warp_windows(p.rect_warp_hw)[0 if parity is None else 1]
    jd, jab = JNR.warp_transport(D, AB, maps, win, interpret=True)
    return np.asarray(jd), np.asarray(jab).view(np.int32)


def _port(t, parity, normals, ws):
    maps = t.maps[0 if parity is None else 1 + parity]
    td, tab = TNR.coefficient_transport(t, maps, torch.from_numpy(normals),
                                        torch.from_numpy(ws))
    return td.numpy(), tab.numpy()


@pytest.mark.parametrize("parity", PARITIES, ids=["full", "parity0", "parity1"])
def test_coefficient_transport_plain_matches_reference(setup, parity):
    """D and the AB words bit for bit, for C=3 fields on the full map's grid
    and on each colour's packed half-grid."""
    p, ctx, t, planes = setup
    n, w = _packed(planes, parity)
    jd, jab = _reference(p, ctx, parity, n, w)
    _lib.reset_launch_counts()
    td, tab = _port(t, parity, n, w)
    assert td.shape == jd.shape == (3, S2, *ctx.maps[0].fwd_valid.shape[1:])
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tab, jab)
    live = td > -1e9
    assert live.mean() > 0.05 and (tab[live] != 0).all()
    assert all(v == 0 for v in _lib.LAUNCHES.values())


@pytest.mark.parametrize("parity", [None, 1], ids=["full", "parity1"])
def test_coefficient_transport_plain_near_jitted_reference(setup, parity):
    """The reference as it runs (jitted, its einsum): the fused
    multiply-adds move D by a few ulp and A, B by at most one bf16 step."""
    p, ctx, t, planes = setup
    n, w = _packed(planes, parity)
    maps = ctx.maps[0 if parity is None else 1 + parity]

    @jax.jit
    def prestep(n_, w_):
        n_r = jnp.einsum("sij,chwj->scihw", ctx.pr.R_rr, n_,
                         precision=jax.lax.Precision.HIGHEST)
        S = n_r.shape[0]
        f = ctx.pr.K[:, 0][:, None, None, None]
        wply = w_[None]
        scale = -ctx.pr.baseline[:, None, None, None] / jnp.where(
            jnp.abs(wply) < 1e-20, 1e-20, wply)
        A, B = scale * n_r[:, :, 0], scale * n_r[:, :, 1]
        xb = maps.bwd_x.astype(jnp.float32).reshape(S, 1, *w_.shape[1:])
        yb = maps.bwd_y.astype(jnp.float32).reshape(S, 1, *w_.shape[1:])
        D = (A * (xb + ctx.srow[:, 3][:, None, None, None]
                  - ctx.pr.K[:, 1][:, None, None, None])
             + B * (yb + ctx.srow[:, 2][:, None, None, None]
                    - ctx.pr.K[:, 2][:, None, None, None])
             + scale * n_r[:, :, 2] * f)
        D = jnp.where(jnp.isfinite(D) & (jnp.abs(D) < 1e8), D, -1e9)
        return D, JNR.pack_ab(A, B)

    D, AB = prestep(jnp.asarray(n), jnp.asarray(w))
    win = JRT.warp_windows(p.rect_warp_hw)[0 if parity is None else 1]
    jd, jab = (np.asarray(a) for a in JNR.warp_transport(D, AB, maps, win,
                                                         interpret=True))
    td, tab = _port(t, parity, n, w)
    np.testing.assert_allclose(td, jd, rtol=4e-6, atol=1e-6)
    ja, jb = (np.asarray(a) for a in JNR._unpack_ab(jnp.asarray(jab)))
    ta, tb = (a.numpy() for a in TNR.unpack_ab(torch.from_numpy(tab)))
    for x, y in ((ta, ja), (tb, jb)):
        np.testing.assert_allclose(x, y, rtol=2.0 ** -7, atol=0)


def _edge_fields(t, parity, planes):
    """The fields with edge values at claimed pixels of pair 0: w = 0,
    +-1e-21, +-1e-20 (the threshold itself), 1e-30 and -1e30; normals with
    +inf, -inf, +NaN or -NaN in one component, or 1e30 in all three (the
    rotated normal overflows); A or B then inf or NaN."""
    n, w = (a.copy() for a in _packed(planes, parity))
    maps = t.maps[0 if parity is None else 1 + parity]
    ok = maps.fwd_valid[0].reshape(-1) > 0.5
    m = np.unique(maps.fwd_idx[0][ok].numpy())
    m = m[np.linspace(0, len(m) - 1, 40).astype(int)]
    wf, nf = w.reshape(w.shape[0], -1), n.reshape(n.shape[0], -1, 3)
    w_edge = np.array([0.0, 1e-21, -1e-21, 1e-20, -1e-20, 1e-30, -1e30],
                      np.float32)
    for c in range(w.shape[0]):
        wf[c, m[:7]] = w_edge
        nf[c, m[7], 0] = np.inf
        nf[c, m[8], 1] = -np.inf
        nf[c, m[9], 2] = np.float32(np.nan)
        nf[c, m[10], 0] = -np.float32(np.nan)
        nf[c, m[11]] = 1e30
        nf[c, m[12], :2] = (np.inf, -np.inf)
        wf[c, m[13]] = 0.0
        nf[c, m[13], 1] = np.inf
    return n, w


@pytest.mark.parametrize("parity", PARITIES, ids=["full", "parity0", "parity1"])
def test_coefficient_transport_plain_edge_fields(setup, parity):
    """Edge fields: the 1e-20 floor of |w| (sign dropped), infinite and NaN
    coefficients (D = -1e9, the AB word as the reference's bf16 conversion
    writes it) -- bit for bit against the reference."""
    p, ctx, t, planes = setup
    n, w = _edge_fields(t, parity, planes)
    jd, jab = _reference(p, ctx, parity, n, w)
    td, tab = _port(t, parity, n, w)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tab, jab)
    hi = (tab.view(np.uint32) >> 16) & 0x7FFF
    assert (hi == 0x7FC0).any() and (hi == 0x7F80).any()   # NaN and inf A
    assert ((tab.view(np.uint32) >> 16) == 0xFFC0).any()   # a negative NaN


def test_pack_ab_edge_values_match_reference():
    """pack_ab's bf16 rounding on the bits: ties to even, overflow to inf,
    subnormals, signed zeros, infinities and NaN (0x7FC0 with its sign) as
    the reference's conversion gives them."""
    vals = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40,
                     -1e-45, 3.4e38, -3.39e38, 1.00390625, 1.01171875,
                     -1.00390625, 65535.5, 1e-20, -2.5e19], np.float32)
    bits = np.array([0x7F800001, 0xFF800001, 0x7FBFFFFF, 0x7F7FFFFF,
                     0x00008000, 0x00018000, 0x3F808000, 0xBF818000],
                    np.uint32).view(np.float32)
    A = np.concatenate([vals, bits])
    B = A[::-1].copy()
    jw = np.asarray(JNR.pack_ab(jnp.asarray(A), jnp.asarray(B))).view(np.int32)
    tw = TNR.pack_ab(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    np.testing.assert_array_equal(tw, jw)
