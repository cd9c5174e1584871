"""Port parity: the three kernels of ops/kernels -- their plain-torch
versions on the CPU against the Pallas kernels in interpret mode (the CUDA
kernels against the plain versions: tests/test_torch_gpu.py).

Shapes: the golden problem cut to S=2 pairs and C=2 candidates.
Tolerances: kernel 2's masked gather (warp_transport_plain) bit-exact (its
coefficient tables: tests/test_torch_transport.py); kernel 3
(warp_src_frames) within 1e-4 greylevels on valid samples with an identical
SENTINEL mask; kernel 1 (rect_ncc) with the cost_max ("bad") mask
identical on >= 99.9% of pixels and costs within 1e-4 absolute on >= 99.9%
of the rest, 5e-4 on all of it: XLA's CPU backend fuses the interpreted
kernel's moment sums into multiply-adds, and the variance step
(E[x^2] - E[x]^2) cancels about two digits of that rounding difference.
pack_ab's bf16 rounding is bit-identical to the reference's.
"""

import dataclasses

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
from acmmp_spherical_tpu.ops.pallas import warp_image as JWI  # noqa: E402
from acmmp_spherical_tpu.ops.sampling import (  # noqa: E402
    checkerboard_pack, grid_coords,
)
from acmmp_spherical_torch import interop  # noqa: E402
from acmmp_spherical_torch.ops.kernels import _lib  # noqa: E402
from acmmp_spherical_torch.ops.kernels import ncc_rect as TNR  # noqa: E402
from acmmp_spherical_torch.ops.kernels import warp_image as TWI  # noqa: E402

from torch_port_util import (  # noqa: E402
    H, W, golden_scene, np_tree, port_params, rect_params,
)

S2 = 2


@pytest.fixture(scope="module")
def setup():
    cams, tcams, images, depths, normals = golden_scene()
    p = rect_params(cams)
    ctx = JRT.build_rect_context(
        jnp.asarray(images[0]), jnp.asarray(images[1:]), cams[0],
        jstack(cams[1:]), (cams[0].depth_range[0], cams[0].depth_range[1]),
        comp_hw=p.rect_comp_hw, live_n=p.rect_live_n, warp_hw=p.rect_warp_hw,
        inv_attrib=True)
    ctx2 = jax.tree.map(lambda a: a[:S2], ctx)          # first two pairs
    xs, ys = grid_coords(H, W)
    n_cam = JG.normal_world_to_cam(cams[0], jnp.asarray(normals[0]))
    w = JG.dist_to_origin(cams[0], xs, ys, jnp.asarray(depths[0]), n_cam)
    planes = (jnp.stack([n_cam, n_cam]), jnp.stack([w, w * 1.2]))
    return cams, images, p, ctx2, planes


def _tctx(ctx):
    d = np_tree(ctx)
    d["maps"] = [{k: m[k] for k in ("fwd_idx", "fwd_valid", "bwd_cidx", "bwd_x",
                                    "bwd_y", "bwd_valid")} for m in d["maps"]]
    return interop.rect_context(d, device="cpu")


def _packed(planes, parity):
    n, w = planes
    if parity is None:
        return n, w
    return (jnp.moveaxis(checkerboard_pack(jnp.moveaxis(n, -1, 1), parity), 1, -1),
            checkerboard_pack(w, parity))


def test_pack_ab_matches_reference():
    rng = np.random.default_rng(3)
    A = (rng.normal(size=(64, 64)) * 10.0 ** rng.integers(-6, 6, (64, 64))
         ).astype(np.float32)
    B = rng.normal(size=(64, 64)).astype(np.float32)
    jw = np.asarray(JNR.pack_ab(jnp.asarray(A), jnp.asarray(B))).view(np.int32)
    tw = TNR.pack_ab(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_array_equal(tw.numpy(), jw)
    ja, jb = JNR._unpack_ab(JNR.pack_ab(jnp.asarray(A), jnp.asarray(B)))
    ta, tb = TNR.unpack_ab(tw)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_warp_transport_plain_matches_pallas(setup):
    """Kernel 2: the plain gather equals the Pallas warp-gather transport
    (interpret mode) bit for bit, on the parity-0 map."""
    _, _, p, ctx, _ = setup
    maps = ctx.maps[1]
    rng = np.random.default_rng(5)
    Wg = W // 2
    D = rng.uniform(-50, 300, (S2, 2, H, Wg)).astype(np.float32)
    A = rng.normal(size=(S2, 2, H, Wg)).astype(np.float32)
    B = rng.normal(size=(S2, 2, H, Wg)).astype(np.float32)
    ab = JNR.pack_ab(jnp.asarray(A), jnp.asarray(B))
    win = JRT.warp_windows(p.rect_warp_hw)[1]
    jd, jab = JNR.warp_transport(jnp.asarray(D), ab, maps, win, interpret=True)
    tab_ab = torch.tensor(np.asarray(ab).view(np.int32)).reshape(S2, 2, -1)
    td, tab = TNR.warp_transport_plain(
        torch.from_numpy(D).reshape(S2, 2, -1), tab_ab,
        torch.tensor(np.asarray(maps.fwd_idx)),
        torch.tensor(np.asarray(maps.fwd_valid)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jab).view(np.int32))


@pytest.mark.parametrize("gate", ["window", "no_window"])
def test_warp_src_frames_plain_matches_pallas(setup, gate):
    """Kernel 3: valid samples within 1e-4 greylevels, SENTINEL mask (with
    the per-tile gate) identical.  Without a claimant window the reference
    warps with its XLA path, which has no tile gate."""
    from acmmp_spherical_tpu.ops.sampling import pack_bicubic

    cams, images, p, ctx, _ = setup
    src = jstack(cams[1:1 + S2])
    rhw = JRT.rect_shape(H, W)
    imgs = jnp.asarray(images[1:1 + S2])
    if gate == "window":
        win = p.rect_warp_hw
        jf = np.asarray(JWI.warp_src_frames(imgs, ctx.pr.H1inv, src.width,
                                            src.height, rhw, win,
                                            interpret=True))
    else:
        win = None
        jf = np.stack([np.asarray(JRT.warp_to_rect(
            imgs[s], ctx.pr.H1inv[s], src.width[s], src.height[s], rhw,
            sentinel=True, packed16=pack_bicubic(imgs[s], src.width[s],
                                                 src.height[s])))
            for s in range(S2)])
    tf = TWI.warp_src_frames(
        torch.from_numpy(images[1:1 + S2]), torch.tensor(np.asarray(ctx.pr.H1inv)),
        torch.tensor(np.asarray(src.width)), torch.tensor(np.asarray(src.height)),
        rhw, win).numpy()
    vj, vt = jf > JRT.SENTINEL_THRESH, tf > JRT.SENTINEL_THRESH
    np.testing.assert_array_equal(vt, vj)
    assert vj.mean() > 0.05
    np.testing.assert_allclose(tf[vt], jf[vj], rtol=0, atol=1e-4)


@pytest.mark.parametrize("parity", [0, None])
def test_rect_ncc_plain_matches_pallas(setup, parity):
    """Kernel 1 and the batched evaluation around it: the port's
    rect_batched_ncc (coefficients, plain transport, plain rect_ncc, f32
    back-map) against the reference's with both bf16 packs off."""
    _, _, p, ctx, planes = setup
    n, w = _packed(planes, parity)
    jc = np.asarray(JNR.rect_batched_ncc(ctx, n, w, p, interpret=True,
                                         parity=parity))
    tc = TNR.rect_batched_ncc(_tctx(ctx), torch.tensor(np.asarray(n)),
                              torch.tensor(np.asarray(w)), port_params(p),
                              parity=parity).numpy()
    assert tc.shape == jc.shape
    bj, bt = jc >= p.cost_max, tc >= p.cost_max
    assert (bj == bt).mean() >= 0.999, (bj == bt).mean()
    assert (~bj).mean() > 0.3
    d = np.abs(tc - jc)[~bj & ~bt]
    assert np.mean(d <= 1e-4) >= 0.999 and d.max() <= 5e-4, d.max()


def test_rect_ncc_window_rules(setup):
    """A wider source window only adds coverage (the 128-aligned window
    placement and the [0, win_w - 2] tap rule are kept)."""
    _, _, p, ctx, planes = setup
    p = port_params(p)
    t = _tctx(ctx)
    n, w = (torch.tensor(np.asarray(a)) for a in _packed(planes, 1))
    c384 = TNR.rect_batched_ncc(t, n, w, p, parity=1)
    c512 = TNR.rect_batched_ncc(t, n, w, dataclasses.replace(p, rect_win_w=512),
                                parity=1)
    ok384, ok512 = c384 < p.cost_max, c512 < p.cost_max
    assert bool((ok512 | ~ok384).all())
    assert torch.allclose(c384[ok384 & ok512], c512[ok384 & ok512], atol=1e-5)


@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
def test_rect_ncc_plain_candidates_are_independent(setup, with_geom):
    """The property the chunked CUDA kernel relies on: on the golden
    context, a C=5 batch equals its five C=1 evaluations bit for bit, so a
    kernel may regroup the candidates (the with_geom variant against a
    seeded source-disparity plane with SENTINEL holes)."""
    from acmmp_spherical_torch.ops.rectify import SENTINEL

    _, _, p, ctx, planes = setup
    p = port_params(p)
    t = _tctx(ctx)
    n, w = (torch.tensor(np.asarray(a)) for a in _packed(planes, 0))
    normals = torch.stack([n[0]] * 5)
    ws = torch.stack([w[0] * (1.0 + 0.01 * k) for k in range(-2, 3)])
    maps = t.maps[1]
    D, AB = TNR.coefficient_transport(t, maps, normals, ws)
    kw = {}
    if with_geom:
        rng = np.random.default_rng(11)
        sdisp = rng.uniform(0.0, 60.0, t.rect_ref.shape).astype(np.float32)
        sdisp[rng.random(sdisp.shape) < 0.2] = SENTINEL
        kw = dict(sdisp=torch.from_numpy(sdisp))
    frames = (t.srow, t.tile_oy, t.tile_ox, t.rect_ref, t.rect_src)
    batch = TNR.rect_ncc(*frames, D, AB, maps.fwd_valid, p, **kw)
    singles = [TNR.rect_ncc(*frames, D[c:c + 1], AB[c:c + 1], maps.fwd_valid,
                            p, **kw) for c in range(5)]
    planes_b = batch if with_geom else (batch,)
    for i, plane in enumerate(planes_b):
        one = torch.cat([s[i] if with_geom else s for s in singles])
        assert torch.equal(plane, one)
    assert float((planes_b[0] < p.cost_max).float().mean()) > 0.05
    if with_geom:
        assert bool((batch[1] < p.geom_max_cost).any())


def test_cpu_wrappers_do_not_count_launches(setup):
    _, _, p, ctx, planes = setup
    _lib.reset_launch_counts()
    n, w = (torch.tensor(np.asarray(a)) for a in _packed(planes, 0))
    TNR.rect_batched_ncc(_tctx(ctx), n, w, port_params(p), parity=0)
    assert all(v == 0 for v in _lib.LAUNCHES.values())
