"""Port parity: the two kernels of the geometric pass -- their plain-torch
versions on the CPU against the Pallas kernels in interpret mode (the CUDA
kernels against the plain versions: tests/test_torch_gpu.py).

On the golden problem (96x64x3src), both bf16 packs off:
(a) kernel 5, ``warp_src_disparities``: SENTINEL masks identical and values
    within 1e-5 relative, with the per-tile gate against the Pallas kernel
    and without it (``build_rect_sdisp`` with no window) against the
    reference's XLA ``warp_disp``;
(b) kernel 4, ``rect_ncc`` with ``sdisp`` (the with_geom variant) on the
    same coefficient planes: costs as in test_torch_kernels.py
    (``bad`` mask identical on >= 99.9%, within 1e-4 on >= 99.9% of the
    rest and 5e-4 on all of it: XLA fuses the interpreted moment sums);
    geometric costs with the ``gok`` mask (geom < geom_max_cost) agreeing on
    >= 99.9% of pixels and within 1e-4 where both hold;
(c) ``rect_batched_ncc(with_geom=True)``, C=9 on parity 0, end to end
    against the reference's, with the tolerances of (b).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

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
from acmmp_spherical_torch.bench import golden_geom_fields  # noqa: E402
from acmmp_spherical_torch.ops import rectify as TRT  # noqa: E402
from acmmp_spherical_torch.ops.kernels import ncc_rect as TNR  # noqa: E402
from acmmp_spherical_torch.ops.kernels import warp_image as TWI  # noqa: E402

from torch_port_util import (  # noqa: E402
    H, W, golden_scene, np_tree, port_params, rect_params,
)


@pytest.fixture(scope="module")
def setup():
    cams, tcams, images, depths, normals = golden_scene()
    p = rect_params(cams).with_geom(False)
    src_depths, _, _ = golden_geom_fields(depths, normals)
    ctx = JRT.build_rect_context(
        jnp.asarray(images[0]), jnp.asarray(images[1:]), cams[0],
        jstack(cams[1:]), (cams[0].depth_range[0], cams[0].depth_range[1]),
        comp_hw=p.rect_comp_hw, live_n=p.rect_live_n, warp_hw=p.rect_warp_hw,
        inv_attrib=True, src_depths=jnp.asarray(src_depths))
    xs, ys = grid_coords(H, W)
    n_cam = JG.normal_world_to_cam(cams[0], jnp.asarray(normals[0]))
    w = JG.dist_to_origin(cams[0], xs, ys, jnp.asarray(depths[0]), n_cam)
    return cams, p, ctx, src_depths, (n_cam, w)


def _tctx(ctx):
    d = np_tree(ctx)
    d["maps"] = [{k: m[k] for k in ("fwd_idx", "fwd_valid", "bwd_cidx", "bwd_x",
                                    "bwd_y", "bwd_valid")} for m in d["maps"]]
    return interop.rect_context(d, device="cpu")


def _assert_disp_match(t, j):
    vt, vj = t > JRT.SENTINEL_THRESH, j > JRT.SENTINEL_THRESH
    np.testing.assert_array_equal(vt, vj)
    assert vj.mean() > 0.05
    np.testing.assert_allclose(t[vt], j[vj], rtol=1e-5, atol=0)


@pytest.mark.parametrize("gate", ["window", "no_window"])
def test_warp_src_disparities_plain_matches_reference(setup, gate):
    """(a) kernel 5 against the Pallas kernel (gated) and the XLA warp_disp
    of build_rect_sdisp (ungated)."""
    cams, p, ctx, src_depths, _ = setup
    src = jstack(cams[1:])
    rhw = JRT.rect_shape(H, W)
    if gate == "window":
        win = p.rect_warp_hw
        jd = np.asarray(JWI.warp_src_disparities(
            jnp.asarray(src_depths), ctx.pr.H1inv, ctx.pr.R_sr, src.K,
            ctx.pr.K[:, 0] * ctx.pr.baseline, src.width, src.height, rhw,
            win, interpret=True))
    else:
        win = None
        jd = np.asarray(JRT.build_rect_sdisp(ctx.pr, jnp.asarray(src_depths),
                                             src, rhw, None))
    tpr = TRT.PairRect(**{k: torch.tensor(v) for k, v in
                          np_tree(ctx.pr).items()})
    tsrc = interop.camera({k: np.asarray(getattr(src, k)) for k in
                           ("R", "t", "K", "params", "wh", "depth_range")},
                          device="cpu")
    td = TRT.build_rect_sdisp(tpr, torch.from_numpy(src_depths), tsrc, rhw,
                              win).numpy()
    _assert_disp_match(td, jd)
    if win is not None:
        # the ctx's own rect_sdisp came from the same Pallas kernel
        _assert_disp_match(td, np.asarray(ctx.rect_sdisp))


def _assert_geom_match(tc, tg, jc, jg, p):
    bj, bt = jc >= p.cost_max, tc >= p.cost_max
    assert (bj == bt).mean() >= 0.999, (bj == bt).mean()
    assert (~bj).mean() > 0.3
    d = np.abs(tc - jc)[~bj & ~bt]
    assert np.mean(d <= 1e-4) >= 0.999 and d.max() <= 5e-4, d.max()
    gj, gt = jg < p.geom_max_cost, tg < p.geom_max_cost
    assert (gj == gt).mean() >= 0.999, (gj == gt).mean()
    assert gj.mean() > 0.3
    np.testing.assert_allclose(tg[gj & gt], jg[gj & gt], rtol=0, atol=1e-4)


def test_rect_ncc_geom_plain_matches_pallas(setup):
    """(b) kernel 4 on the same transported coefficient planes (full grid,
    C=2: the GT plane and one 1% off it; the port's tables and transport
    equal the reference's bit for bit, test_torch_kernels.py)."""
    cams, p, ctx, _, (n_cam, w) = setup
    t = _tctx(ctx)
    tm = t.maps[0]
    tab_d, tab_ab = TNR.coefficient_tables(
        t, tm, torch.tensor(np.asarray(jnp.stack([n_cam, n_cam]))),
        torch.tensor(np.asarray(jnp.stack([w, w * 1.01]))))
    D, AB = TNR.warp_transport_plain(tab_d, tab_ab, tm.fwd_idx, tm.fwd_valid)
    jc, jg = JNR.run_rect_kernel(
        ctx.srow, ctx.rect_ref, ctx.rect_src, jnp.asarray(D.numpy()),
        jnp.asarray(AB.numpy().view(np.float32)), ctx.maps[0], ctx.tile_oy,
        ctx.tile_ox, p, out_hw=(H, W), interpret=True,
        rect_sdisp=ctx.rect_sdisp)
    tc, tg = TNR.rect_ncc_plain(t.srow, t.tile_oy, t.tile_ox, t.rect_ref,
                                t.rect_src, D, AB, tm.fwd_valid,
                                port_params(p), sdisp=t.rect_sdisp)
    tc = TNR.backmap(tc, tm, (H, W), p.cost_max).numpy()
    tg = TNR.backmap(tg, tm, (H, W), p.geom_max_cost).numpy()
    _assert_geom_match(tc, tg, np.asarray(jc), np.asarray(jg), p)


def test_rect_batched_ncc_with_geom_matches_reference(setup):
    """(c) C=9 near-GT planes on parity 0 through the whole batched
    evaluation of both packages."""
    cams, p, ctx, _, (n_cam, w) = setup
    k = jnp.arange(9, dtype=jnp.float32)[:, None, None]
    normals = jnp.broadcast_to(n_cam, (9,) + n_cam.shape)
    ws = w[None] * (1.0 + 0.005 * (k - 4.0))
    n = jnp.moveaxis(checkerboard_pack(jnp.moveaxis(normals, -1, 1), 0), 1, -1)
    wp = checkerboard_pack(ws, 0)
    jc, jg = JNR.rect_batched_ncc(ctx, n, wp, p, interpret=True,
                                  with_geom=True, parity=0)
    tc, tg = TNR.rect_batched_ncc(_tctx(ctx), torch.tensor(np.asarray(n)),
                                  torch.tensor(np.asarray(wp)), port_params(p),
                                  parity=0, with_geom=True)
    assert tc.shape == jc.shape == tg.shape
    _assert_geom_match(tc.numpy(), tg.numpy(), np.asarray(jc), np.asarray(jg),
                       p)
