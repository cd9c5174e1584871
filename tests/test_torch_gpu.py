"""The CUDA kernels on the card, against their plain-torch versions, and the
port's pass on the card against the reference's golden statistics.

These tests need a CUDA device and skip without one.  They import nothing of
JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances (as chip_smoke.py): warp_transport (``coefficient_transport``,
every candidate count, map and pass, and on edge fields) bit-exact; rect_ncc
(both variants, every candidate count and tap pattern) bit-exact;
warp_src_frames and warp_src_disparities (gate on and off, bench and odd
frames; source depths with zeros, negatives and a NaN) bit-exact;
ncc_window (both variants, every field count and tap pattern) bit-exact;
window_sample bit-exact on values and ok (window origins at and beyond the
int32 range, non-finite samples, frames smaller than the window, the
golden problem's centre-tap projections), one launch per call; the
golden photometric and geometric passes on the rectified path, and the
photometric ones on the windowed and exact paths, within drift_gate's 2e-2
of their fixtures.  The sphere path: kernels 1 and 4 on the pole-rotated
operands (C = 1, 5, 9, full grid and both parities) bit-exact;
``sphere_batched_ncc`` on the card against the CPU plain version within
the transcendental tolerance of test_torch_sphere_rect.py; the sphere's
golden rectified pass within 2e-2 of its fixture.
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

from torch_port_util import WINDOW_EDGE_CASES, window_edge_case  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _golden(device):
    return make_problem(**GOLDEN_SCENE, device=device)


def _check_against(fixture, d, nrm, cost):
    _check_against_stats(json.loads((FIXTURES / fixture).read_text()), d,
                         nrm, cost)


def _check_against_stats(golden, d, nrm, cost):
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
    for k, v in golden.items():
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
    _lib.reset_launch_counts()
    D, AB = NR.coefficient_transport(rect, maps, n, w)
    Dp, ABp = NR.coefficient_transport_plain(rect, maps, n, w)
    assert torch.equal(D, Dp) and torch.equal(AB, ABp)
    args = (rect.srow, rect.tile_oy, rect.tile_ox, rect.rect_ref,
            rect.rect_src, D, AB, maps.fwd_valid, params)
    ck, cp = NR.rect_ncc(*args), NR.rect_ncc_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp)
    wargs = (inputs.src_images, rect.pr.H1inv, inputs.src_cams.width,
             inputs.src_cams.height, rect_shape(H, W), params.rect_warp_hw)
    fk, fp = WI.warp_src_frames(*wargs), WI.warp_src_frames_plain(*wargs)
    torch.cuda.synchronize()
    assert torch.equal(fk, fp) and bool((fk > SENTINEL_THRESH).any())
    assert _lib.LAUNCHES == {"rect_ncc": 1, "rect_ncc_geom": 0,
                             "warp_transport": 1, "warp_src_frames": 1,
                             "warp_src_disparities": 0, "ncc_window": 0,
                             "ncc_window_geom": 0, "window_sample": 0}


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
    assert torch.equal(sk, sp)
    assert float((sk > SENTINEL_THRESH).float().mean()) > 0.05
    xs, ys = grid_coords(H, W, cuda)
    from acmmp_spherical_torch.core import geometry as G

    n = G.normal_world_to_cam(inputs.ref_cam, seeds["seed_normal_world"])
    w = G.dist_to_origin(inputs.ref_cam, xs, ys, seeds["seed_depth"], n)
    normals = torch.stack([checkerboard_pack(n.movedim(-1, 0), 1).movedim(0, -1)
                           ] * 5)
    ws = torch.stack([checkerboard_pack(w * (1.0 + 0.005 * k), 1)
                      for k in range(-2, 3)])
    maps = rect.maps[2]
    D, AB = NR.coefficient_transport(rect, maps, normals, ws)
    args = (rect.srow, rect.tile_oy, rect.tile_ox, rect.rect_ref,
            rect.rect_src, D, AB, maps.fwd_valid, params)
    ck, gk = NR.rect_ncc(*args, sdisp=rect.rect_sdisp)
    cp, gp = NR.rect_ncc_plain(*args, sdisp=rect.rect_sdisp)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp) and torch.equal(gk, gp)
    assert bool((gk < params.geom_max_cost).any())
    assert _lib.LAUNCHES == {"rect_ncc": 0, "rect_ncc_geom": 1,
                             "warp_transport": 1, "warp_src_frames": 0,
                             "warp_src_disparities": 1, "ncc_window": 0,
                             "ncc_window_geom": 0, "window_sample": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["11x11s2", "7x7s1"])
@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
@pytest.mark.parametrize("C", [1, 3, 5, 9])
def test_rect_ncc_chunks_match_plain(cuda, C, with_geom, pattern):
    """rect_ncc walks the candidates in chunks: bit-identical to the plain
    version for C at and across the chunk edges, both variants, on the
    default tap pattern and on 7x7 at stride 1 (49 taps, the instantiation
    with runtime tap bounds)."""
    from acmmp_spherical_torch.core import geometry as G

    inputs, params, seeds, _ = golden_geom_problem(cuda)
    if pattern == "7x7s1":
        params = dataclasses.replace(params, patch_size=7, radius_increment=1)
    rect = prepare_inputs(inputs, params).rect
    H, W = inputs.ref_image.shape
    xs, ys = grid_coords(H, W, cuda)
    n = G.normal_world_to_cam(inputs.ref_cam, seeds["seed_normal_world"])
    w = G.dist_to_origin(inputs.ref_cam, xs, ys, seeds["seed_depth"], n)
    normals = torch.stack([checkerboard_pack(n.movedim(-1, 0), 0).movedim(0, -1)
                           ] * C)
    ws = torch.stack([checkerboard_pack(w * (1.0 + 0.005 * (k - C // 2)), 0)
                      for k in range(C)])
    maps = rect.maps[1]
    D, AB = NR.coefficient_transport(rect, maps, normals, ws)
    args = (rect.srow, rect.tile_oy, rect.tile_ox, rect.rect_ref,
            rect.rect_src, D, AB, maps.fwd_valid, params)
    kw = dict(sdisp=rect.rect_sdisp) if with_geom else {}
    _lib.reset_launch_counts()
    k, p = NR.rect_ncc(*args, **kw), NR.rect_ncc_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, p) if with_geom else ((k, p),):
        assert a.shape == (C, *maps.fwd_valid.shape) and torch.equal(a, b)
    assert bool(((p[0] if with_geom else p) < params.cost_max).any())
    assert _lib.LAUNCHES["rect_ncc_geom" if with_geom else "rect_ncc"] == 1


def _transport_fields(inputs, seeds, parity, C):
    """C plane fields on the grid of ``parity``'s map: the seed (geometric
    pass) or random planes (photometric pass), w scaled by 1 + 0.05 k."""
    from acmmp_spherical_torch.core import geometry as G

    H, W = inputs.ref_image.shape
    dev = inputs.ref_image.device
    xs, ys = grid_coords(H, W, dev)
    if seeds is not None:
        n = G.normal_world_to_cam(inputs.ref_cam, seeds["seed_normal_world"])
        w = G.dist_to_origin(inputs.ref_cam, xs, ys, seeds["seed_depth"], n)
        planes = [(n, w * (1.0 + 0.05 * (k - C // 2))) for k in range(C)]
    else:
        planes = [R.random_plane_hypothesis(
            R.key(40 + k), inputs.ref_cam, xs, ys, inputs.depth_range[0],
            inputs.depth_range[1]) for k in range(C)]
    if parity is None:
        return (torch.stack([a for a, _ in planes]).contiguous(),
                torch.stack([b for _, b in planes]).contiguous())
    return (torch.stack([checkerboard_pack(a.movedim(-1, 0), parity)
                         .movedim(0, -1) for a, _ in planes]).contiguous(),
            torch.stack([checkerboard_pack(b, parity) for _, b in planes]))


def _transport_problem(cuda, kind):
    if kind == "geom":
        inputs, params, seeds, _ = golden_geom_problem(cuda)
    else:
        inputs, params = _golden(cuda)[:2]
        seeds = None
    return inputs, prepare_inputs(inputs, params).rect, seeds


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["phot", "geom"])
@pytest.mark.parametrize("parity", [None, 0, 1], ids=["full", "parity0",
                                                      "parity1"])
@pytest.mark.parametrize("C", [1, 5, 9])
def test_coefficient_transport_matches_plain(cuda, C, parity, kind):
    """Kernel 2 computes D and AB at each claimed pixel: bit-identical to
    the coefficient tables + masked gather, for C = 1, 5 and 9 on the full
    map and both parity maps, in the photometric pass's context (random
    planes) and the geometric pass's (planes around the seed)."""
    inputs, rect, seeds = _transport_problem(cuda, kind)
    maps = rect.maps[0 if parity is None else 1 + parity]
    n, w = _transport_fields(inputs, seeds, parity, C)
    _lib.reset_launch_counts()
    D, AB = NR.coefficient_transport(rect, maps, n, w)
    Dp, ABp = NR.coefficient_transport_plain(rect, maps, n, w)
    torch.cuda.synchronize()
    assert D.shape == (C, *maps.fwd_valid.shape)
    assert torch.equal(D, Dp) and torch.equal(AB, ABp)
    assert bool((D > -1e9).any())
    assert _lib.LAUNCHES["warp_transport"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("parity", [None, 0, 1], ids=["full", "parity0",
                                                      "parity1"])
def test_coefficient_transport_edge_fields(cuda, parity):
    """Edge fields at claimed pixels: w = 0, +-1e-21, +-1e-20, 1e-30, -1e30
    and normals with inf, NaN or 1e30 components (A or B inf or NaN, D
    -1e9): bit-identical to the plain version, NaN words included."""
    inputs, rect, _ = _transport_problem(cuda, "phot")
    maps = rect.maps[0 if parity is None else 1 + parity]
    n, w = _transport_fields(inputs, None, parity, 3)
    ok = maps.fwd_valid[0].reshape(-1) > 0.5
    m = torch.unique(maps.fwd_idx[0][ok].long())
    m = m[torch.linspace(0, len(m) - 1, 40, device=cuda).long()]
    wf, nf = w.reshape(3, -1), n.reshape(3, -1, 3)
    inf, nan = float("inf"), float("nan")
    wf[:, m[:7]] = torch.tensor([0.0, 1e-21, -1e-21, 1e-20, -1e-20, 1e-30,
                                 -1e30], device=cuda)
    nf[:, m[7], 0] = inf
    nf[:, m[8], 1] = -inf
    nf[:, m[9], 2] = nan
    nf[:, m[10], 0] = -nan
    nf[:, m[11]] = 1e30
    nf[:, m[12], 0], nf[:, m[12], 1] = inf, -inf
    wf[:, m[13]] = 0.0
    nf[:, m[13], 1] = inf
    D, AB = NR.coefficient_transport(rect, maps, n, w)
    Dp, ABp = NR.coefficient_transport_plain(rect, maps, n, w)
    torch.cuda.synchronize()
    assert torch.equal(D, Dp) and torch.equal(AB, ABp)
    hi = (AB.long() >> 16) & 0x7FFF
    assert bool((hi == 0x7FC0).any()) and bool((hi == 0x7F80).any())


@pytest.mark.gpu
def test_card_path_does_not_build_coefficient_tables(cuda, monkeypatch):
    """On the card rect_batched_ncc transports through the kernel: the
    plain-torch tables are never built."""
    inputs, rect, _ = _transport_problem(cuda, "phot")
    n, w = _transport_fields(inputs, None, 0, 5)
    params = _golden(cuda)[1]
    expect = NR.rect_batched_ncc(rect, n, w, params, parity=0)

    def refuse(*_):
        raise AssertionError("coefficient_tables ran on the card path")

    monkeypatch.setattr(NR, "coefficient_tables", refuse)
    _lib.reset_launch_counts()
    got = NR.rect_batched_ncc(rect, n, w, params, parity=0)
    torch.cuda.synchronize()
    assert torch.equal(got, expect)
    assert _lib.LAUNCHES["warp_transport"] == 1
    assert _lib.LAUNCHES["rect_ncc"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("gate", ["gate", "no_gate"])
@pytest.mark.parametrize("frame", ["bench", "odd"])
def test_warp_src_frames_match_plain(cuda, frame, gate):
    """Kernel 3 bit for bit, with the per-tile gate on and off, on the
    1024x768x8src bench frames and the 95x64 odd frames."""
    from acmmp_spherical_torch.bench import BENCH_SCENE

    scene = BENCH_SCENE if frame == "bench" else dict(GOLDEN_SCENE, width=95)
    inputs, params = make_problem(**scene, device=cuda)[:2]
    rect = prepare_inputs(inputs, params).rect
    H, W = inputs.ref_image.shape
    src = inputs.src_cams
    args = (inputs.src_images, rect.pr.H1inv, src.width, src.height,
            rect_shape(H, W), params.rect_warp_hw if gate == "gate" else None)
    _lib.reset_launch_counts()
    fk, fp = WI.warp_src_frames(*args), WI.warp_src_frames_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(fk, fp)
    valid = float((fk > SENTINEL_THRESH).float().mean())
    assert 0.05 < valid < 1.0
    assert _lib.LAUNCHES["warp_src_frames"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("gate", ["gate", "no_gate"])
@pytest.mark.parametrize("frame", ["bench", "odd"])
def test_warp_src_disparities_match_plain(cuda, frame, gate):
    """Kernel 5 bit for bit, with the per-tile gate on and off, on the
    1024x768x8src bench frames and the 95x64 odd frames, from ground-truth
    source depths holding a band of zeros, a band of negatives and a NaN."""
    from acmmp_spherical_torch.bench import BENCH_SCENE

    scene = BENCH_SCENE if frame == "bench" else dict(GOLDEN_SCENE, width=95)
    inputs, params, depths = make_problem(**scene, device=cuda)[:3]
    rect = prepare_inputs(inputs, params).rect
    H, W = inputs.ref_image.shape
    dep = torch.as_tensor(depths[1:], device=cuda).clone()
    dep[:, H // 4:H // 4 + 6] = 0.0
    dep[:, :, W // 3:W // 3 + 5] = -dep[:, :, W // 3:W // 3 + 5]
    dep[:, H // 2, W // 2] = float("nan")
    src = inputs.src_cams
    args = (dep, rect.pr.H1inv, rect.pr.R_sr, src.K,
            rect.pr.K[:, 0] * rect.pr.baseline, src.width, src.height,
            rect_shape(H, W), params.rect_warp_hw if gate == "gate" else None)
    _lib.reset_launch_counts()
    sk = WI.warp_src_disparities(*args)
    sp = WI.warp_src_disparities_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(sk, sp)
    valid = float((sk > SENTINEL_THRESH).float().mean())
    assert 0.05 < valid < 1.0
    assert _lib.LAUNCHES["warp_src_disparities"] == 1


def _sampler_case(case):
    """(src, x, y, src_h, src_w) numpy of a windowed-sampler case: the
    int32-edge and non-finite cases of ``window_edge_case``, a frame smaller
    than the 40x384 window ("small_frame", padded by the sampler), and the
    smooth and wild coordinates of tests/test_pallas_window.py."""
    if case in WINDOW_EDGE_CASES:
        return window_edge_case(case)
    rng = np.random.default_rng(1234)
    Hs, Ws = (30, 200) if case == "small_frame" else (64, 256)
    src = rng.random((Hs, Ws)).astype(np.float32)
    if case == "wild":
        x = rng.uniform(0, Ws - 2, (16, 128))
        y = rng.uniform(0, Hs - 2, (16, 128))
    else:
        ys, xs = np.mgrid[0:16, 0:256].astype(np.float32)
        x = xs * (0.8 if case == "small_frame" else 0.9) + 3.7 \
            + 2 * np.sin(ys / 17)
        y = ys * (1.9 if case == "small_frame" else 0.8) + 1.2 \
            + 1.5 * np.cos(xs / 23)
    return src, x.astype(np.float32), y.astype(np.float32), Hs, Ws


@pytest.mark.gpu
@pytest.mark.parametrize("case", WINDOW_EDGE_CASES + ("small_frame", "smooth",
                                                      "wild"))
def test_window_sample_matches_plain(cuda, case):
    """Kernel 7, which places each tile's window itself, bit for bit on
    values and ok against the plain version (origins from
    ``compute_window_offsets``)."""
    from acmmp_spherical_torch.ops.kernels import window_sample as WS

    src, x, y, Hs, Ws = _sampler_case(case)
    src, x, y = (torch.as_tensor(a, device=cuda) for a in (src, x, y))
    _lib.reset_launch_counts()
    v, ok = WS.windowed_sample(src, x, y, src_h=Hs, src_w=Ws)
    vp, okp = WS.windowed_sample_plain(src, x, y, src_h=Hs, src_w=Ws)
    torch.cuda.synchronize()
    assert torch.equal(ok, okp) and torch.equal(v, vp)
    assert bool(ok.any())
    assert _lib.LAUNCHES["window_sample"] == 1


@pytest.mark.gpu
def test_windowed_sample_is_one_launch(cuda, monkeypatch):
    """On the card windowed_sample is one kernel launch: the plain-torch
    origin pre-pass never runs, and the profiler sees no device kernel but
    the sampler's."""
    from acmmp_spherical_torch.ops.kernels import window_sample as WS

    src, x, y, Hs, Ws = window_edge_case("x_-2^31")
    src, x, y = (torch.as_tensor(a, device=cuda) for a in (src, x, y))
    vp, okp = WS.windowed_sample_plain(src, x, y, src_h=Hs, src_w=Ws)

    def refuse(*_, **__):
        raise AssertionError("compute_window_offsets ran on the card path")

    monkeypatch.setattr(WS, "compute_window_offsets", refuse)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            v, ok = WS.windowed_sample(src, x, y, src_h=Hs, src_w=Ws)
        torch.cuda.synchronize()
    assert torch.equal(ok, okp) and torch.equal(v, vp)
    assert _lib.LAUNCHES["window_sample"] == 4
    # the profiler may drop an event at the edge of its window
    device = {ev.key: ev.count for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and ev.self_device_time_total > 0}
    assert device and all("window_sample_kernel" in k for k in device), device
    assert 3 <= sum(device.values()) <= 4, device


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


def _golden_off_rect(device, **kw):
    """The golden problem on the windowed (``fast_ncc``) or exact path."""
    inputs, params = _golden(device)[:2]
    return inputs, dataclasses.replace(params, rect_ncc=False, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
def test_window_kernels_match_plain(cuda, with_geom):
    """Kernel 6 (both variants) on the golden problem's packed half-grid,
    padded to the 8x128 tile, and kernel 7 on its centre-tap projections:
    bit-identical to the plain versions, as on the bench shapes."""
    from acmmp_spherical_torch.core import geometry as G
    from acmmp_spherical_torch.core.camera import camera_index
    from acmmp_spherical_torch.ops.kernels import ncc_window as NW
    from acmmp_spherical_torch.ops.kernels import window_sample as WS
    from acmmp_spherical_torch.ops.ncc import RefTapContext, ref_tap_context

    inputs, params, depths, normals = _golden(cuda)
    H, W = inputs.ref_image.shape
    xs, ys = grid_coords(H, W, cuda)
    cam = inputs.ref_cam
    n = G.normal_world_to_cam(cam, torch.as_tensor(normals[0], device=cuda))
    w = G.dist_to_origin(cam, xs, ys, torch.as_tensor(depths[0], device=cuda),
                         n)
    ctx = ref_tap_context(inputs.ref_image, cam, params)
    pad = lambda a: torch.nn.functional.pad(
        checkerboard_pack(a, 0)[None], (0, 128 - W // 2, 0, 0),
        mode="replicate")[0]
    ctx_p = RefTapContext(ctx.offsets, pad(ctx.ref_taps), pad(ctx.weights),
                          pad(ctx.center[None])[0], pad(xs[None])[0],
                          pad(ys[None])[0])
    n_p = pad(n.movedim(-1, 0)).movedim(0, -1)
    w_p = pad(w[None])[0]
    dep = torch.as_tensor(depths[1:], device=cuda) if with_geom else None
    ops = NW._setup(inputs.src_images, inputs.src_cams, cam, n_p[None],
                    w_p[None], ctx_p, dep)
    _lib.reset_launch_counts()
    k = NW.ncc_window(**ops, params=params)
    p = NW.ncc_window_plain(**ops, params=params)
    torch.cuda.synchronize()
    for a, b in zip(k, p) if with_geom else ((k, p),):
        assert a.shape == (1, 3, H, 128) and torch.equal(a, b)
    assert float((p[0] if with_geom else p).lt(params.cost_max).float()
                 .mean()) > 0.3
    X = G.unproject_world(cam, xs, ys, G.depth_from_plane(cam, xs, ys, n, w))
    px, py, _ = G.project(camera_index(inputs.src_cams, 0), X)
    sx, sy = (pad(a[None])[0] for a in (px, py))
    v, ok = WS.windowed_sample(inputs.src_images[0], sx, sy, src_h=H,
                               src_w=W)
    vp, okp = WS.windowed_sample_plain(inputs.src_images[0], sx, sy,
                                       src_h=H, src_w=W)
    torch.cuda.synchronize()
    assert torch.equal(ok, okp) and bool(ok.any()) and torch.equal(v, vp)
    assert _lib.LAUNCHES["ncc_window_geom" if with_geom else "ncc_window"] == 1
    assert _lib.LAUNCHES["window_sample"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["packed", "odd"])
@pytest.mark.parametrize("pattern", ["11x11s2", "7x7s1"])
@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
@pytest.mark.parametrize("C", [1, 5, 9])
def test_ncc_window_batches_match_plain(cuda, C, with_geom, pattern, grid):
    """ncc_window evaluates C fields in one launch, in chunks of views:
    bit-identical to the plain version for C = 1, 5 and 9, both variants,
    on the default tap pattern and on 7x7 at stride 1 (49 taps), on the
    golden problem's packed half-grid and on the 95x64 odd frame's full
    grid, each padded to 128 columns.  The fields (the ground truth's depth
    scaled by 1.5^(k - C // 2)) place their windows differently."""
    from acmmp_spherical_torch.core import geometry as G
    from acmmp_spherical_torch.ops.kernels import ncc_window as NW
    from acmmp_spherical_torch.ops.ncc import RefTapContext, ref_tap_context

    scene = dict(GOLDEN_SCENE, width=95) if grid == "odd" else GOLDEN_SCENE
    inputs, params, depths, normals = make_problem(**scene, device=cuda)
    if pattern == "7x7s1":
        params = dataclasses.replace(params, patch_size=7, radius_increment=1)
    H, W = inputs.ref_image.shape
    xs, ys = grid_coords(H, W, cuda)
    cam = inputs.ref_cam
    n = G.normal_world_to_cam(cam, torch.as_tensor(normals[0], device=cuda))
    w = G.dist_to_origin(cam, xs, ys, torch.as_tensor(depths[0], device=cuda),
                         n)
    ctx = ref_tap_context(inputs.ref_image, cam, params)
    pack = (lambda a: checkerboard_pack(a, 0)) if grid == "packed" else \
        (lambda a: a)
    Wg = W // 2 if grid == "packed" else W
    pad = lambda a: torch.nn.functional.pad(
        pack(a).reshape(1, -1, H, Wg), (0, 128 - Wg, 0, 0),
        mode="replicate").reshape(*a.shape[:-2], H, 128)
    ctx_p = RefTapContext(ctx.offsets, pad(ctx.ref_taps), pad(ctx.weights),
                          pad(ctx.center), pad(xs), pad(ys))
    scale = 1.5 ** (torch.arange(C, device=cuda) - C // 2).float()
    ns = pad(n.movedim(-1, 0)).movedim(0, -1).expand(C, H, 128, 3)
    ws = pad(w)[None] * scale[:, None, None]
    dep = torch.as_tensor(depths[1:], device=cuda) if with_geom else None
    ops = NW._setup(inputs.src_images, inputs.src_cams, cam, ns, ws, ctx_p,
                    dep)
    if C > 1:
        assert len({tuple(o.flatten().tolist()) for o in ops["off_y"]}) > 1
    _lib.reset_launch_counts()
    k = NW.ncc_window(**ops, params=params)
    p = NW.ncc_window_plain(**ops, params=params)
    torch.cuda.synchronize()
    for a, b in zip(k, p) if with_geom else ((k, p),):
        assert a.shape == (C, 3, H, 128) and torch.equal(a, b)
    assert bool(((p[0] if with_geom else p) < params.cost_max).any())
    assert _lib.LAUNCHES["ncc_window_geom" if with_geom else "ncc_window"] == 1


@pytest.mark.gpu
def test_windowed_golden_pass_on_card(cuda):
    inputs, params = _golden_off_rect(cuda, fast_ncc=True)
    _lib.reset_launch_counts()
    d, nrm, cost, _ = run_patchmatch(inputs, params, GOLDEN_KEY)
    # 2 launches per half-step (C=9 and C=5) x 6 half-steps; the init is exact
    assert _lib.LAUNCHES["ncc_window"] == 12
    _check_against("golden_pass_stats_window.json", d, nrm, cost)


@pytest.mark.gpu
def test_exact_golden_pass_on_card(cuda):
    inputs, params = _golden_off_rect(cuda)
    d, nrm, cost, _ = run_patchmatch(inputs, params, GOLDEN_KEY)
    _check_against("golden_pass_stats.json", d, nrm, cost)


def _sphere_fields(inputs, depths, normals, parity, C):
    """C plane fields around the ground truth (w scaled by 1 + 0.05 k) on
    the grid of ``parity``'s map."""
    from acmmp_spherical_torch.core import geometry as G

    dev = inputs.ref_image.device
    H, W = inputs.ref_image.shape
    xs, ys = grid_coords(H, W, dev)
    n = G.normal_world_to_cam(inputs.ref_cam,
                              torch.as_tensor(normals[0], device=dev))
    w = G.dist_to_origin(inputs.ref_cam, xs, ys,
                         torch.as_tensor(depths[0], device=dev), n)
    ns = torch.stack([n] * C)
    ws = torch.stack([w * (1.0 + 0.05 * (k - C // 2)) for k in range(C)])
    if parity is None:
        return ns.contiguous(), ws.contiguous()
    return (checkerboard_pack(ns.movedim(-1, 1), parity).movedim(1, -1)
            .contiguous(), checkerboard_pack(ws, parity).contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("parity", [None, 0, 1], ids=["full", "parity0",
                                                      "parity1"])
@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
@pytest.mark.parametrize("C", [1, 5, 9])
def test_sphere_rect_ncc_matches_plain(cuda, C, with_geom, parity):
    """Kernels 1 and 4 on the pole-rotated operands (transposed rotated
    frames, a sphere srow, zero tile offsets, the sphere's transport maps)
    against their plain version, bit for bit, one launch each."""
    from acmmp_spherical_torch.bench import (
        SPHERE_GOLDEN_SCENE, golden_geom_fields, make_sphere_problem,
    )
    from acmmp_spherical_torch.ops import sphere_rect as SR

    inputs, params, depths, normals = make_sphere_problem(
        **SPHERE_GOLDEN_SCENE, device=cuda)
    src = torch.as_tensor(golden_geom_fields(depths, normals)[0], device=cuda)
    ctx = prepare_inputs(dataclasses.replace(inputs, src_depths=src),
                         params.with_geom(False)).rect
    assert isinstance(ctx, SR.SphereRectContext)
    maps = ctx.maps[0 if parity is None else 1 + parity]
    ns, ws = _sphere_fields(inputs, depths, normals, parity, C)
    D, AB = NR.warp_transport_plain(
        *SR.sphere_coefficient_tables(ctx, ns, ws, parity), maps.fwd_idx,
        maps.fwd_valid)
    args = (ctx.srow, ctx.tile_oy, ctx.tile_ox, ctx.rect_ref, ctx.rect_src,
            D, AB, maps.fwd_valid, params)
    kw = dict(sdisp=ctx.rect_sdisp) if with_geom else {}
    _lib.reset_launch_counts()
    k, p = NR.rect_ncc(*args, **kw), NR.rect_ncc_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, p) if with_geom else ((k, p),):
        assert torch.equal(a, b)
    assert bool(((p[0] if with_geom else p) < params.cost_max).any())
    assert _lib.LAUNCHES["rect_ncc_geom" if with_geom else "rect_ncc"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("with_geom", [False, True], ids=["phot", "geom"])
def test_sphere_batched_ncc_on_card_matches_cpu(cuda, with_geom):
    """sphere_batched_ncc on the card (its context built there) against the
    CPU plain version: the transcendentals of the two devices differ by
    ulps, so the cost_max decisions agree on >= 99.9%, the mean |cost
    difference| is below 1e-3 and fewer than 1% of the costs (2% of the
    geometric costs) are more than 1e-2 apart."""
    from acmmp_spherical_torch.bench import (
        SPHERE_GOLDEN_SCENE, golden_geom_fields, make_sphere_problem,
    )
    from acmmp_spherical_torch.ops import sphere_rect as SR

    outs = []
    for dev in (cuda, torch.device("cpu")):
        inputs, params, depths, normals = make_sphere_problem(
            **SPHERE_GOLDEN_SCENE, device=dev)
        src = torch.as_tensor(golden_geom_fields(depths, normals)[0],
                              device=dev)
        ctx = prepare_inputs(dataclasses.replace(inputs, src_depths=src),
                             params.with_geom(False)).rect
        ns, ws = _sphere_fields(inputs, depths, normals, 0, 9)
        r = SR.sphere_batched_ncc(ctx, ns, ws, params, with_geom=with_geom,
                                  parity=0)
        outs.append([a.cpu() for a in (r if with_geom else (r,))])
    (card, cpu), cm = outs, params.cost_max
    assert ((card[0] >= cm) == (cpu[0] >= cm)).float().mean() >= 0.999
    d = (card[0] - cpu[0]).abs()
    assert d.mean() < 1e-3 and (d > 1e-2).float().mean() < 0.01
    if with_geom:
        assert ((card[1] - cpu[1]).abs() > 1e-2).float().mean() < 0.02


@pytest.mark.gpu
def test_sphere_golden_pass_on_card(cuda):
    from acmmp_spherical_torch.bench import (
        SPHERE_GOLDEN_SCENE, make_sphere_problem,
    )

    inputs, params = make_sphere_problem(**SPHERE_GOLDEN_SCENE,
                                         device=cuda)[:2]
    _lib.reset_launch_counts()
    d, nrm, cost, _ = run_patchmatch(inputs, params, GOLDEN_KEY)
    assert _lib.LAUNCHES["rect_ncc"] > 0
    stats = json.loads((FIXTURES / "golden_sphere_pass_stats_rect.json")
                       .read_text())
    stats.pop("band_median_rel_err")
    _check_against_stats(stats, d, nrm, cost)
