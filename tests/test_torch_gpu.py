"""The CUDA kernels on the card, against their plain-torch versions, and the
port's pass on the card against the reference's golden statistics.

These tests need a CUDA device and skip without one.  They import nothing of
JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances (as chip_smoke.py): warp_transport bit-exact; rect_ncc with the
cost_max mask identical on >= 99.9% of pixels and costs within 1e-4
elsewhere; warp_src_frames within 1e-4 greylevels with an identical
SENTINEL mask; the golden pass within drift_gate's 2e-2 of the fixture.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from acmmp_spherical_torch.bench import make_problem  # noqa: E402
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

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_pass_stats_warp.json"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _golden(device):
    return make_problem(96, 64, 3, device, focal=80.0, radius=0.35)


@pytest.mark.gpu
def test_cuda_kernels_match_plain(cuda):
    inputs, params, _ = _golden(cuda)
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
    assert _lib.LAUNCHES == {"rect_ncc": 1, "warp_transport": 1,
                             "warp_src_frames": 1}


@pytest.mark.gpu
def test_golden_pass_on_card(cuda):
    inputs, params, _ = _golden(cuda)
    params = dataclasses.replace(params, rect_inv_attrib=False)
    d, nrm, cost, _ = run_patchmatch(inputs, params, 2333)
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
    for k, v in json.loads(FIXTURE.read_text()).items():
        assert abs(stats[k] - v) <= max(2e-2, 2e-2 * abs(v)), (k, stats[k], v)
