"""The CUDA kernels on the card, against their plain-torch versions, and the
port's pass on the card against the reference's golden statistics.

These tests need a CUDA device and skip without one.  They import nothing of
JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances (as chip_smoke.py): warp_transport bit-exact; rect_ncc with the
cost_max mask identical on >= 99.9% of pixels and costs within 1e-4
elsewhere, and in its with_geom variant the geometric planes with an
identical geom < geom_max_cost mask and within 1e-4; warp_src_frames within
1e-4 greylevels and warp_src_disparities equal, each with an identical
SENTINEL mask; the golden photometric and geometric passes within
drift_gate's 2e-2 of their fixtures.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from acmmp_spherical_torch.bench import (  # noqa: E402
    GOLDEN_KEY, GOLDEN_SCENE, golden_geom_problem, make_problem,
)
from acmmp_spherical_torch.ops import rng as R  # noqa: E402
from acmmp_spherical_torch.ops.kernels import _lib  # noqa: E402
from acmmp_spherical_torch.ops.kernels import ncc_rect as NR  # noqa: E402
from acmmp_spherical_torch.ops.kernels import warp_image as WI  # noqa: E402
from acmmp_spherical_torch.ops.propagate import prepare_inputs  # noqa: E402
from acmmp_spherical_torch.ops.rectify import (  # noqa: E402
    SENTINEL_THRESH, rect_shape,
)
from acmmp_spherical_torch.ops.sampling import (  # noqa: E402
    checkerboard_pack, grid_coords,
)
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _golden(device):
    return make_problem(**GOLDEN_SCENE, device=device)


def _check_against(fixture, d, nrm, cost):
    d, nrm, cost = d.cpu().numpy(), nrm.cpu().numpy(), cost.cpu().numpy()
    H, W = d.shape
    stats = {}
    for qi, sl in enumerate([np.s_[: H // 2, : W // 2], np.s_[: H // 2, W // 2:],
                             np.s_[H // 2:, : W // 2], np.s_[H // 2:, W // 2:]]):
        stats[f"depth_mean_q{qi}"] = float(np.mean(d[sl]))
        stats[f"depth_median_q{qi}"] = float(np.median(d[sl]))
        stats[f"cost_mean_q{qi}"] = float(np.mean(cost[sl]))
    stats["normal_mean_abs"] = float(np.mean(np.abs(nrm)))
    stats["depth_p10"] = float(np.percentile(d, 10))
    stats["depth_p90"] = float(np.percentile(d, 90))
    for k, v in json.loads((FIXTURES / fixture).read_text()).items():
        assert abs(stats[k] - v) <= max(2e-2, 2e-2 * abs(v)), (k, stats[k], v)


@pytest.mark.gpu
def test_cuda_kernels_match_plain(cuda):
    inputs, params = _golden(cuda)[:2]
    prep = prepare_inputs(inputs, params)
    rect = prep.rect
    H, W = inputs.ref_image.shape
    xs, ys = grid_coords(H, W, cuda)
    planes = [R.random_plane_hypothesis(R.key(i), inputs.ref_cam, xs, ys,
                                        inputs.depth_range[0],
                                        inputs.depth_range[1]) for i in range(3)]
    n = torch.stack([checkerboard_pack(p[0].movedim(-1, 0), 0).movedim(0, -1)
                     for p in planes])
    w = torch.stack([checkerboard_pack(p[1], 0) for p in planes])
    maps = rect.maps[1]
    tab_d, tab_ab = NR.coefficient_tables(rect, maps, n, w)
    _lib.reset_launch_counts()
    D, AB = NR.warp_transport(tab_d, tab_ab, maps.fwd_idx, maps.fwd_valid)
    Dp, ABp = NR.warp_transport_plain(tab_d, tab_ab, maps.fwd_idx,
                                      maps.fwd_valid)
    assert torch.equal(D, Dp) and torch.equal(AB, ABp)
    args = (rect.srow, rect.tile_oy, rect.tile_ox, rect.rect_ref,
            rect.rect_src, D, AB, maps.fwd_valid, params)
    ck, cp = NR.rect_ncc(*args), NR.rect_ncc_plain(*args)
    torch.cuda.synchronize()
    bk, bp = ck >= params.cost_max, cp >= params.cost_max
    assert float((bk == bp).float().mean()) >= 0.999
    assert torch.allclose(ck[~bk & ~bp], cp[~bk & ~bp], atol=1e-4, rtol=0)
    wargs = (inputs.src_images, rect.pr.H1inv, inputs.src_cams.width,
             inputs.src_cams.height, rect_shape(H, W), params.rect_warp_hw)
    fk, fp = WI.warp_src_frames(*wargs), WI.warp_src_frames_plain(*wargs)
    torch.cuda.synchronize()
    vk = fk > SENTINEL_THRESH
    assert torch.equal(vk, fp > SENTINEL_THRESH)
    assert float((fk - fp)[vk].abs().max()) <= 1e-4
    assert _lib.LAUNCHES == {"rect_ncc": 1, "rect_ncc_geom": 0,
                             "warp_transport": 1, "warp_src_frames": 1,
                             "warp_src_disparities": 0}


@pytest.mark.gpu
def test_geom_kernels_match_plain(cuda):
    inputs, params, seeds, _ = golden_geom_problem(cuda)
    prep = prepare_inputs(inputs, params)
    rect = prep.rect
    H, W = inputs.ref_image.shape
    _lib.reset_launch_counts()
    src = inputs.src_cams
    dargs = (inputs.src_depths, rect.pr.H1inv, rect.pr.R_sr, src.K,
             rect.pr.K[:, 0] * rect.pr.baseline, src.width, src.height,
             rect_shape(H, W), params.rect_warp_hw)
    sk = WI.warp_src_disparities(*dargs)
    sp = WI.warp_src_disparities_plain(*dargs)
    torch.cuda.synchronize()
    vk = sk > SENTINEL_THRESH
    assert torch.equal(vk, sp > SENTINEL_THRESH) and float(vk.float().mean()) > 0.05
    assert torch.equal(sk[vk], sp[vk])
    xs, ys = grid_coords(H, W, cuda)
    from acmmp_spherical_torch.core import geometry as G

    n = G.normal_world_to_cam(inputs.ref_cam, seeds["seed_normal_world"])
    w = G.dist_to_origin(inputs.ref_cam, xs, ys, seeds["seed_depth"], n)
    normals = torch.stack([checkerboard_pack(n.movedim(-1, 0), 1).movedim(0, -1)
                           ] * 5)
    ws = torch.stack([checkerboard_pack(w * (1.0 + 0.005 * k), 1)
                      for k in range(-2, 3)])
    maps = rect.maps[2]
    tab_d, tab_ab = NR.coefficient_tables(rect, maps, normals, ws)
    D, AB = NR.warp_transport(tab_d, tab_ab, maps.fwd_idx, maps.fwd_valid)
    args = (rect.srow, rect.tile_oy, rect.tile_ox, rect.rect_ref,
            rect.rect_src, D, AB, maps.fwd_valid, params)
    ck, gk = NR.rect_ncc(*args, sdisp=rect.rect_sdisp)
    cp, gp = NR.rect_ncc_plain(*args, sdisp=rect.rect_sdisp)
    torch.cuda.synchronize()
    bk, bp = ck >= params.cost_max, cp >= params.cost_max
    assert float((bk == bp).float().mean()) >= 0.999
    assert torch.allclose(ck[~bk & ~bp], cp[~bk & ~bp], atol=1e-4, rtol=0)
    ok = gk < params.geom_max_cost
    assert torch.equal(ok, gp < params.geom_max_cost) and bool(ok.any())
    assert torch.allclose(gk[ok], gp[ok], atol=1e-4, rtol=0)
    assert _lib.LAUNCHES == {"rect_ncc": 0, "rect_ncc_geom": 1,
                             "warp_transport": 1, "warp_src_frames": 0,
                             "warp_src_disparities": 1}


@pytest.mark.gpu
def test_golden_pass_on_card(cuda):
    inputs, params = _golden(cuda)[:2]
    params = dataclasses.replace(params, rect_inv_attrib=False)
    d, nrm, cost, _ = run_patchmatch(inputs, params, GOLDEN_KEY)
    _check_against("golden_pass_stats_warp.json", d, nrm, cost)


@pytest.mark.gpu
def test_golden_geom_pass_on_card(cuda):
    inputs, params, seeds, _ = golden_geom_problem(cuda)
    d, nrm, cost, _ = run_patchmatch(inputs, params, GOLDEN_KEY, **seeds)
    assert bool(torch.isfinite(d).all())
    _check_against("golden_geom_pass_stats_rect.json", d, nrm, cost)
