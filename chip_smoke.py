#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from ``acmmp_spherical_torch/csrc`` (one nvcc per source, all
   started together; build seconds printed);
2. check the photometric pass's kernels against their plain-torch versions
   on the card, at the shapes of the 1024x768x8src photometric pass (the
   C=9 and C=5 parity evaluations and the C=1 init evaluation; the source
   warp with its tile gate on and off); every kernel (phase 4 too) must
   equal its plain version bit for bit;
3. drive the photometric path -- ``pipeline.patchmatch.run_patchmatch`` on
   the CubeRoom 1024x768x8src scene -- once warm and three times timed, with
   the launch counters zeroed just before and read just after; its median
   relative depth error must be < 0.0032;
4. the geometric path: the 8 source views' own photometric passes (keys
   1000 + i) give the source depths and the photometric pass's output the
   seed; the geometric kernels (``warp_src_disparities`` and ``rect_ncc``
   with_geom at C=9 parity 0 and C=5 parity 1) are checked against their
   plain versions at the geometric pass's shapes; then the geometric pass
   runs once warm and three times timed (keys 100, 101-103) with the
   counters zeroed just before and read just after; its depth must be
   finite, with a median relative error < 0.0032 and below the photometric
   pass's;
5. the 96x64x3src golden photometric and geometric passes match the
   reference's committed statistics at drift_gate's 2e-2;
6. the windowed photometric path (``rect_ncc`` off, ``fast_ncc`` on, as the
   pass runner runs problems that fail ``host_rectifiable``): ``ncc_window``
   against its plain version, bit for bit, on the batched launches of the
   packed half-grids (parity 0 with 9 fields, parity 1 with 5; random
   planes and planes around phase 3's output) and ``window_sample`` (one
   launch per ``windowed_sample`` call, window origins included) on phase
   3's centre-tap projections into each source view; the pass once
   warm and three times timed (12 ``ncc_window`` launches each), median
   relative depth error < 0.0046; then the windowed sampler's path: every
   source view warped into the reference frame through that depth, its
   residual against the same warp through the ground truth;
7. the windowed geometric path (phase 4's source depths, seeded from phase
   6): ``ncc_window`` with_geom against its plain version on the same
   batched launches, the pass warm + 3 timed (8 launches each), its error
   below phase 6's;
8. the exact and windowed golden passes and 95x64 odd-frame passes on the
   rectified, windowed and exact paths against the reference's statistics
   at 2e-2;
8b. the golden planar-prior passes (photometric pass, prior build, prior
   pass; ``bench.golden_prior_pass``) on the rectified and windowed paths
   (the windowed one evaluates its random-depth refinement candidates on
   the exact path) and the golden hierarchy pass on the rectified path,
   96x64x3src, against the reference's statistics at 2e-2;
9. the pipeline at a real size: ``pipeline.multiscale.run_pipeline`` with
   ``PipelineConfig()`` defaults (planar prior on, 2 geometric passes, size
   bound 1000) on an 8-view CubeRoom ring (focal 0.9 W, radius 0.25; every
   view takes the other 7 as sources) rendered at 1600x1200, DTU's image
   size, and written in the on-disk layout (JPEG q98) to a temporary
   folder.  8 views where a DTU scene has 49 is the cut that keeps the
   smoke inside its time.  Two scales run: 800x600, then 1600x1200 after
   JBU with hierarchy passes; the launch counters are zeroed just before
   and read just after, and printed per pass and round (the main round, or
   the planar-prior round).  In each (pass, round) the first launch of each
   kernel at each set of operand shapes is held bit for bit against the
   kernel's plain version on the same operands (uncounted, and out of the
   times and the peak memory).  The manifest must hold all 48 (pass, view)
   entries from one run of each pass per view (no retry), every
   photometric and hierarchy pass must have run its prior round, kernels
   1-5 must have been launched, every view's final depths_geom.dmb must
   have a median relative depth error < 0.02 against ground truth, and the
   fused cloud must hold > 2000 points, > 90% of them within 0.08 of the
   cube surface (the gates of tests/test_pipeline_e2e.py).  Times per pass kind and scale, of JBU,
   the prior builds, fusion and io, the wall time and the peak device
   memory are printed.  The launches are sorted by pass and round by a
   hook on the run's ``Timings`` that reads the counters as each pass
   scope and prior build opens and closes;
10. the sphere passes at the sphere operating point, the equirect CubeRoom
   ring at 1024x512 with 6 source views (``bench.make_sphere_problem``):
   ``rect_ncc`` and ``rect_ncc_geom`` held bit for bit against their plain
   version at their pole-rotated operands (C=1 init, C=9 parity 0, C=5
   parity 1; the geometric ones around the photometric pass's output),
   with the times of the coefficient pre-step and the transport gather
   that feed them; the photometric pass once warm and three times timed
   (13 ``rect_ncc`` launches each), its device time from torch.profiler
   over one more pass; the 6 per-view photometric seed passes (keys
   2000 + i); the geometric pass seeded from the photometric one (keys 50,
   51-53; 9 ``rect_ncc_geom`` launches each).  Median relative depth error
   over the latitude band that ``LAT_CAP_DEG`` leaves, and over the pole
   band: each pass's band error must be < 0.02 (the reference's own sphere
   geometric pass does not lower the band error when its source depths
   come from the views' photometric passes, so the geometric pass is not
   held below the photometric one);
11. the sphere scene: ``run_pipeline`` with ``PipelineConfig()`` defaults on
   6 equirect views of the CubeRoom ring at 1024x512 (two scales, 512x256
   then 1024x512), with the same launch sorting and first-launch checks as
   phase 9; every view must run each pass once and every prior round must
   launch kernels; each view's median relative depth error < 0.08, more
   than 1500 fused points, more than 70% of them within 0.2 of the cube
   surface (tests/test_multiscale_sphere.py:77-81); then ``convert`` on a
   small synthetic COLMAP model with a SPHERE camera, whose scene folder
   must read back.
Every kernel must have been launched by one of the driven paths.

Prints the card's name and power limit, one JSON line of kernel results,
then, last, ``{"ok": true, "device": {...}}``.  A kernel's ``ms`` is the
time of its launch: CUDA events over back-to-back calls, except for the
source warps and the sampler, whose ``ms`` is their device time from
torch.profiler and whose ``call_ms`` is the CUDA-event time of the whole
Python call.  Needs CUDA; never falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
COST_TOL = 1e-4          # |kernel - plain| on costs where both agree on `bad`
#                          (rect_ncc and ncc_window must besides be
#                          bit-identical)
BAD_AGREE_MIN = 0.999    # fraction of pixels whose `bad` decision agrees
GEOM_TOL = 1e-4          # |kernel - plain| on geom costs; gok mask identical
DEPTH_ERR_MAX = 0.0032   # median relative depth error gate of the bench
FIXTURE_TOL = 2e-2       # scripts/drift_gate.py rtol/atol
# NVIDIA H100 SXM peaks (data sheet, 700 W): HBM bytes/s and fp32 FLOP/s
# outside the tensor cores; the bound of a call is the larger of its bytes
# and its operations over these
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TAP_FLOPS = 30           # fp32 operations per (candidate, pixel, tap)
BICUBIC_FLOPS = 80       # per valid rect pixel: coordinates, weights, 16 taps
DISP_FLOPS = 20          # per valid rect pixel: coordinates, z_rect, division
# ncc_window's least work, per (field, pixel, tap) for the view-independent
# part -- ray 6, plane depth 6 (n.r 4, parallel test, division), camera-frame
# point 2, wgt*ref and wgt*ref^2 2 -- and per (field, view, pixel, tap) for
# the rest -- pose 18, |z| test and reciprocal 2, projection 6, floors 2,
# image and window test 4 (one interval per axis), fractions 2, bilinear 9,
# moment sums 9
WIN_PLANE_FLOPS = 16
WIN_VIEW_FLOPS = 52
SAMPLE_FLOPS = 17        # window_sample, per sample: floors, window test,
#                          bilinear, image test
WINDOW_ERR_MAX = 0.0046  # windowed pass gate: see PERF.md, "Windowed pass"
WARP_RESID_SLACK = 1.0   # greylevels over twice the ground truth's residual
# ncc_window launches per pass: 2 per half-step (the 8 candidates and the
# current plane at C=9, the 5 refinement candidates at C=5) x 6 photometric
# / 4 geometric half-steps; the init is exact
WIN_PHOT_LAUNCHES = 12
WIN_GEOM_LAUNCHES = 8
# phase 9: the pipeline scene and its gates (tests/test_pipeline_e2e.py;
# tau 0.08 is 1% of the 8-unit room)
PIPELINE_SCENE = dict(
    label="pinhole", n_views=8, width=1600, height=1200,
    cameras=dict(focal=1440.0, radius=0.25), err_border=6,
    depth_err_max=0.02, min_points=2000, tau=0.08, on_surface_min=0.9,
    kernels=("rect_ncc", "rect_ncc_geom", "warp_transport", "warp_src_frames",
             "warp_src_disparities"))
# phase 10: the sphere operating point (root bench.py:257-261) and the gate
# of tests/test_sphere_rect.py:119 over the latitude band that LAT_CAP_DEG
# leaves, for both passes: the geometric pass is not held below the
# photometric one, since with source depths from the views' own photometric
# passes the reference's sphere geometric pass raises the band error too
# (tests/test_torch_sphere_pass.py --geom-seeded; PERF.md, Findings)
SPHERE_BAND_ERR_MAX = 0.02
# rect_ncc launches per sphere pass: the C=1 init, then 2 per half-step (the
# 8 candidates and the current plane at C=9, the 5 refinement candidates at
# C=5) x 6 photometric / 4 geometric half-steps
SPHERE_PHOT_LAUNCHES = 13
SPHERE_GEOM_LAUNCHES = 9
# phase 11: the sphere scene and its gates (tests/test_multiscale_sphere.py:
# 77-81, over the whole frame)
SPHERE_PIPELINE_SCENE = dict(
    label="sphere", n_views=6, width=1024, height=512,
    cameras=dict(model="sphere"), err_border=0, depth_err_max=0.08,
    min_points=1500, tau=0.2, on_surface_min=0.7,
    kernels=("rect_ncc", "rect_ncc_geom"))
ODD_SCENE = dict(width=95, height=64, n_src=3, focal=80.0, radius=0.35)
PHOT_KERNELS = ("rect_ncc", "warp_transport", "warp_src_frames")
GEOM_KERNELS = ("rect_ncc_geom", "warp_transport", "warp_src_frames",
                "warp_src_disparities")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int):
    """(ms, kernels): the mean device time of one launch of the device
    kernel whose name holds ``kernel``, and the device kernels of every
    name per such launch, from torch.profiler over ``reps`` calls of ``fn``
    (one launch each) after a warm one.  Per observed launch, since the
    profiler may drop an event at the edge of its window."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = []
    # the profiler has been seen to drop over half of a window's events on
    # the card; such a window is profiled again, up to three in all
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
        mine = [ev for ev in evs if kernel in ev.key]
        n = sum(ev.count for ev in mine)
        seen.append(n)
        if n >= reps // 2:
            break
    else:
        raise AssertionError(f"the profiler saw {kernel} {seen} times in "
                             f"three windows of {reps} calls")
    if len(seen) > 1:
        log(f"the profiler saw {kernel} {seen} times in windows of {reps} "
            "calls")
    return (sum(ev.self_device_time_total for ev in mine) / 1e3 / n,
            sum(ev.count for ev in evs) / n)


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def golden_stats(d, nrm, cost) -> dict:
    """Region statistics of a pass, as tests/test_regression_fixture.py
    computes them for the committed golden fixtures."""
    import numpy as np

    out = {}
    H, W = d.shape
    for qi, sl in enumerate([np.s_[: H // 2, : W // 2], np.s_[: H // 2, W // 2:],
                             np.s_[H // 2:, : W // 2], np.s_[H // 2:, W // 2:]]):
        out[f"depth_mean_q{qi}"] = float(np.mean(d[sl]))
        out[f"depth_median_q{qi}"] = float(np.median(d[sl]))
        out[f"cost_mean_q{qi}"] = float(np.mean(cost[sl]))
    out["normal_mean_abs"] = float(np.mean(np.abs(nrm)))
    out["depth_p10"] = float(np.percentile(d, 10))
    out["depth_p90"] = float(np.percentile(d, 90))
    return out


def check_golden(fixture: str, out, key: str | None = None) -> float:
    """Worst |stat - fixture| over drift_gate's tolerance of a golden pass
    (``key``: the entry of a fixture that holds several)."""
    golden = json.loads((ROOT / "tests/fixtures" / fixture).read_text())
    if key is not None:
        golden = golden[key]
    d, n, c = (a.cpu().numpy() for a in out[:3])
    if not np_finite(d):
        raise AssertionError(f"golden pass vs {fixture}: depth not finite")
    stats = golden_stats(d, n, c)
    worst = max(abs(stats[k] - v) / max(FIXTURE_TOL, FIXTURE_TOL * abs(v))
                for k, v in golden.items())
    log(f"golden pass vs {fixture}{'' if key is None else ' ' + key}: "
        f"worst {worst:.3f} x tolerance")
    if worst > 1.0:
        raise AssertionError(f"golden pass drifted from {fixture}")
    return worst


def np_finite(a) -> bool:
    import numpy as np

    return bool(np.all(np.isfinite(a)))


def median_rel_err(depth, gt) -> float:
    import numpy as np

    d = depth.cpu().numpy()
    if not np.all(np.isfinite(d)) or d.shape != gt.shape:
        raise AssertionError("depth map is not finite or has the wrong shape")
    g = gt[8:-8, 8:-8]
    return float(np.median(np.abs(d[8:-8, 8:-8] - g) / g))


def packed(normals, ws, parity):
    """(C, H, W[, 3]) plane fields -> that parity's packed half-grids,
    contiguous as the pass's batches are."""
    from acmmp_spherical_torch.ops.sampling import checkerboard_pack

    if parity is None:
        return normals.contiguous(), ws.contiguous()
    return (checkerboard_pack(normals.movedim(-1, 0), parity).movedim(0, -1)
            .contiguous(), checkerboard_pack(ws, parity))


def check_rect_case(name, rect, normals, ws, parity, p, with_geom):
    """Transport + rect_ncc (with_geom: its geometric variant) against their
    plain versions on one batched evaluation; returns its numbers."""
    import torch

    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR

    maps = rect.maps[0 if parity is None else 1 + parity]
    targs = (rect, maps, normals, ws)
    D, AB = NR.coefficient_transport(*targs)
    Dp, ABp = NR.coefficient_transport_plain(*targs)
    torch.cuda.synchronize()
    if not (torch.equal(D, Dp) and torch.equal(AB, ABp)):
        raise AssertionError(f"warp_transport {name}: not bit-identical")
    sd = dict(sdisp=rect.rect_sdisp) if with_geom else {}
    rargs = (rect.srow, rect.tile_oy, rect.tile_ox, rect.rect_ref,
             rect.rect_src, D, AB, maps.fwd_valid, p)
    ck = NR.rect_ncc(*rargs, **sd)
    cp = NR.rect_ncc_plain(*rargs, **sd)
    torch.cuda.synchronize()
    if with_geom:
        (ck, gk), (cp, gp) = ck, cp
    bk, bp = ck >= p.cost_max, cp >= p.cost_max
    agree = float((bk == bp).float().mean())
    both = ~bk & ~bp
    err = float((ck - cp)[both].abs().max()) if bool(both.any()) else 0.0
    log(f"rect_ncc {name}: bad-mask agreement {agree:.6f}, max err "
        f"{err:.3g}, live fraction {float(both.float().mean()):.3f}")
    if agree < BAD_AGREE_MIN or err > COST_TOL:
        raise AssertionError(f"rect_ncc {name}: agreement {agree}, err {err}")
    gerr = None
    if with_geom:
        gok = gk < p.geom_max_cost
        if not torch.equal(gok, gp < p.geom_max_cost):
            raise AssertionError(f"rect_ncc_geom {name}: gok masks differ")
        gerr = float((gk - gp)[gok].abs().max()) if bool(gok.any()) else 0.0
        log(f"rect_ncc_geom {name}: gok fraction "
            f"{float(gok.float().mean()):.3f}, max geom err {gerr:.3g}")
        if gerr > GEOM_TOL:
            raise AssertionError(f"rect_ncc_geom {name}: geom err {gerr}")
    if not (torch.equal(ck, cp) and (not with_geom or torch.equal(gk, gp))):
        raise AssertionError(f"rect_ncc {name}: not bit-identical to the "
                             "plain version")
    # the work this run's data needs: every candidate pixel of a live tile
    # runs the taps; every input is read and every output written once
    C, S, K8, _ = D.shape
    live_tiles = int((maps.fwd_valid.reshape(S, K8 // 8, 1024).amax(-1)
                      > 0.5).sum())
    n_taps = len(range(-(p.patch_size // 2), p.patch_size // 2 + 1,
                       p.radius_increment)) ** 2
    frames = (rect.rect_ref, rect.rect_src) + (
        (rect.rect_sdisp,) if with_geom else ())
    outs = (ck, gk) if with_geom else (ck,)
    ncc_bound = bound(nbytes(D, AB, maps.fwd_valid, rect.srow, rect.tile_oy,
                             rect.tile_ox, *frames, *outs),
                      live_tiles * 1024 * C * n_taps * TAP_FLOPS)
    # the transport reads the fields, the claim map (bwd_x, bwd_y), the
    # compact map and the pair constants once and writes D and AB once
    transport_bound = bound(nbytes(
        normals, ws, maps.bwd_x, maps.bwd_y, maps.fwd_idx, maps.fwd_valid,
        rect.pr.R_rr, rect.pr.K, rect.pr.baseline, rect.srow, D, AB), 0)
    return dict(
        ncc_max_abs_err=max(err, gerr or 0.0),
        transport_max_abs_err=float((D - Dp).abs().max()),
        transport_ms=cuda_ms(lambda: NR.coefficient_transport(*targs), 10),
        transport_plain_ms=cuda_ms(
            lambda: NR.coefficient_transport_plain(*targs), 3),
        transport_bound=transport_bound,
        ncc_ms=cuda_ms(lambda: NR.rect_ncc(*rargs, **sd), 5),
        ncc_plain_ms=cuda_ms(lambda: NR.rect_ncc_plain(*rargs, **sd), 1),
        ncc_bound=ncc_bound,
        batched_ms=cuda_ms(lambda: NR.rect_batched_ncc(
            rect, normals, ws, p, parity=parity, with_geom=with_geom), 5))


def kernel_entry(route_src, replaces, max_abs_err, ms, plain_ms, bnd):
    return dict(route="cuda", source=f"acmmp_spherical_torch/csrc/{route_src}",
                replaces=f"acmmp_spherical_tpu/ops/pallas/{replaces}",
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)


def rect_entry(results, names, prefix):
    """The kernel entry of rect_ncc (``prefix`` "ncc") or warp_transport
    ("transport") over the rectified cases ``names``: the first case's
    times, and every case's under ``cases``."""
    cs = [results["cases"][n] for n in names]
    e = kernel_entry(
        "rect_ncc.cu" if prefix == "ncc" else "warp_transport.cu",
        "ncc_rect.py:614" if prefix == "ncc" else "ncc_rect.py:460",
        max(c[f"{prefix}_max_abs_err"] for c in cs), cs[0][f"{prefix}_ms"],
        cs[0][f"{prefix}_plain_ms"], cs[0][f"{prefix}_bound"])
    e["cases"] = {n: dict(ms=c[f"{prefix}_ms"], plain_ms=c[f"{prefix}_plain_ms"],
                          bound_ms=c[f"{prefix}_bound"][0],
                          bound_by=c[f"{prefix}_bound"][1])
                  for n, c in zip(names, cs)}
    return e


def check_warp(name, fn, plain, args, valid_flops, results):
    """A source warp against its plain version, bit for bit, with its tile
    gate (the last argument) off and as given; timed as given."""
    import torch

    from acmmp_spherical_torch.ops.rectify import SENTINEL_THRESH

    for gated in (args[:-1] + (None,), args):
        k, pl = fn(*gated), plain(*gated)
        torch.cuda.synchronize()
        err = float((k - pl).abs().max())
        if not torch.equal(k, pl):
            raise AssertionError(f"{name} (gate {gated[-1]}): not "
                                 f"bit-identical, max err {err}")
    valid = k > SENTINEL_THRESH
    src, kernel = ("warp_image.py:215", "warp_src_kernel") \
        if name == "warp_src_frames" else ("warp_image.py:263",
                                            "warp_disp_kernel")
    ms, per_call = device_ms(lambda: fn(*args), kernel, 20)
    results[name] = kernel_entry(
        "warp_image.cu", src, err, ms, cuda_ms(lambda: plain(*args), 2),
        bound(nbytes(args[0], k), int(valid.sum()) * valid_flops))
    results[name].update(call_ms=cuda_ms(lambda: fn(*args), 20),
                         device_kernels_per_call=per_call)
    log(f"{name} ok: {results[name]}, valid fraction "
        f"{float(valid.float().mean()):.3f}")


def check_phot_kernels(inputs, params, results):
    """Phase 2: the photometric kernels at the photometric pass's shapes,
    from random planes."""
    import torch

    from acmmp_spherical_torch.ops import rng as R
    from acmmp_spherical_torch.ops.kernels import warp_image as WI
    from acmmp_spherical_torch.ops.rectify import rect_shape
    from acmmp_spherical_torch.ops.sampling import grid_coords

    rect = inputs.rect
    H, W = inputs.ref_image.shape
    cams = inputs.src_cams
    check_warp("warp_src_frames", WI.warp_src_frames, WI.warp_src_frames_plain,
               (inputs.src_images, rect.pr.H1inv, cams.width, cams.height,
                rect_shape(H, W), params.rect_warp_hw), BICUBIC_FLOPS,
               results)
    xs, ys = grid_coords(H, W, inputs.ref_image.device)
    dmin, dmax = inputs.depth_range[0], inputs.depth_range[1]
    planes = [R.random_plane_hypothesis(R.key(100 + i), inputs.ref_cam, xs,
                                        ys, dmin, dmax) for i in range(9)]
    for name, C, parity, p in (
            ("C9_parity0", 9, 0, params), ("C5_parity1", 5, 1, params),
            ("C1_init", 1, None, dataclasses.replace(
                params, rect_win_w=params.rect_init_win))):
        n, w = packed(torch.stack([a for a, _ in planes[:C]]),
                      torch.stack([b for _, b in planes[:C]]), parity)
        case = check_rect_case(name, rect, n, w, parity, p, False)
        results.setdefault("cases", {})[name] = case
        log(f"{name}: {case}")
    names = ("C9_parity0", "C5_parity1", "C1_init")
    results["warp_transport"] = rect_entry(results, names, "transport")
    results["rect_ncc"] = rect_entry(results, names, "ncc")


def check_geom_kernels(inputs, params, seeds, results):
    """Phase 4: the geometric kernels at the geometric pass's shapes, from
    planes around the seed field (the photometric pass's output)."""
    import torch

    from acmmp_spherical_torch.core import geometry as G
    from acmmp_spherical_torch.ops.kernels import warp_image as WI
    from acmmp_spherical_torch.ops.rectify import rect_shape
    from acmmp_spherical_torch.ops.sampling import grid_coords

    rect = inputs.rect
    H, W = inputs.ref_image.shape
    cams = inputs.src_cams
    check_warp("warp_src_disparities", WI.warp_src_disparities,
               WI.warp_src_disparities_plain,
               (inputs.src_depths, rect.pr.H1inv, rect.pr.R_sr, cams.K,
                rect.pr.K[:, 0] * rect.pr.baseline, cams.width, cams.height,
                rect_shape(H, W), params.rect_warp_hw), DISP_FLOPS,
               results)
    xs, ys = grid_coords(H, W, inputs.ref_image.device)
    cam = inputs.ref_cam
    n = G.normalize(G.normal_world_to_cam(cam, seeds["seed_normal_world"]))
    w = G.dist_to_origin(cam, xs, ys, seeds["seed_depth"], n)
    for name, C, parity in (("geom_C9_parity0", 9, 0),
                            ("geom_C5_parity1", 5, 1)):
        scale = 1.0 + 0.005 * (torch.arange(C, device=w.device) - C // 2)
        nn, ww = packed(n.expand(C, *n.shape), w * scale[:, None, None],
                        parity)
        case = check_rect_case(name, rect, nn, ww, parity, params, True)
        results["cases"][name] = case
        log(f"{name}: {case}")
    results["rect_ncc_geom"] = rect_entry(
        results, ("geom_C9_parity0", "geom_C5_parity1"), "ncc")


def check_sphere_case(name, ctx, normals, ws, parity, p, with_geom):
    """Kernel 1 (``with_geom``: kernel 4) on the pole-rotated operands of
    one batched evaluation against its plain version, bit for bit; returns
    its numbers, with the times of the coefficient pre-step and of the
    transport gather (``warp_transport_plain``) that feed it."""
    import torch

    from acmmp_spherical_torch.ops import sphere_rect as SR
    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR

    maps = ctx.maps[0 if parity is None else 1 + parity]
    tables = SR.sphere_coefficient_tables(ctx, normals, ws, parity)
    D, AB = NR.warp_transport_plain(*tables, maps.fwd_idx, maps.fwd_valid)
    sd = dict(sdisp=ctx.rect_sdisp) if with_geom else {}
    rargs = (ctx.srow, ctx.tile_oy, ctx.tile_ox, ctx.rect_ref, ctx.rect_src,
             D, AB, maps.fwd_valid, p)
    ck = NR.rect_ncc(*rargs, **sd)
    cp = NR.rect_ncc_plain(*rargs, **sd)
    torch.cuda.synchronize()
    if not _same(ck, cp):
        raise AssertionError(f"rect_ncc sphere {name}: not bit-identical to "
                             f"the plain version, max err {_max_err(ck, cp)}")
    cost = ck[0] if with_geom else ck
    log(f"rect_ncc{'_geom' if with_geom else ''} sphere {name}: "
        f"bit-identical, live fraction "
        f"{float((cost < p.cost_max).float().mean()):.3f}")
    C, S, K8, _ = D.shape
    live_tiles = int((maps.fwd_valid.reshape(S, K8 // 8, 1024).amax(-1)
                      > 0.5).sum())
    n_taps = len(range(-(p.patch_size // 2), p.patch_size // 2 + 1,
                       p.radius_increment)) ** 2
    frames = (ctx.rect_ref, ctx.rect_src) + (
        (ctx.rect_sdisp,) if with_geom else ())
    outs = ck if with_geom else (ck,)
    case = dict(
        C=C, parity=parity, max_abs_err=0.0,
        ms=cuda_ms(lambda: NR.rect_ncc(*rargs, **sd), 5),
        plain_ms=cuda_ms(lambda: NR.rect_ncc_plain(*rargs, **sd), 1),
        bound=bound(nbytes(D, AB, maps.fwd_valid, ctx.srow, ctx.tile_oy,
                           ctx.tile_ox, *frames, *outs),
                    live_tiles * 1024 * C * n_taps * TAP_FLOPS),
        tables_ms=cuda_ms(lambda: SR.sphere_coefficient_tables(
            ctx, normals, ws, parity), 5),
        gather_ms=cuda_ms(lambda: NR.warp_transport_plain(
            *tables, maps.fwd_idx, maps.fwd_valid), 5),
        batched_ms=cuda_ms(lambda: SR.sphere_batched_ncc(
            ctx, normals, ws, p, with_geom=with_geom, parity=parity), 5))
    log(f"sphere {name}: {case}")
    return case


def run_sphere_phase(dev, results):
    """Phase 10: the sphere passes at 1024x512x6src; returns their numbers,
    the photometric and geometric paths under ``phot`` and ``geom``."""
    import torch

    from acmmp_spherical_torch.bench import (
        SPHERE_BENCH_SCENE, make_sphere_problem, source_depths,
        sphere_band_errors,
    )
    from acmmp_spherical_torch.ops import rng as R
    from acmmp_spherical_torch.ops.propagate import prepare_inputs
    from acmmp_spherical_torch.ops.sampling import grid_coords
    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch
    from acmmp_spherical_torch.profile_pass import trace

    t0 = time.perf_counter()
    inputs, params, gt, _ = make_sphere_problem(**SPHERE_BENCH_SCENE,
                                                device=dev)
    out = dict(scene_s=time.perf_counter() - t0, init_win=params.rect_init_win,
               live_n=params.sphere_live_n)
    ctx = prepare_inputs(inputs, params).rect
    out["build_context_ms"] = cuda_ms(lambda: prepare_inputs(inputs, params),
                                      2)
    H, W = inputs.ref_image.shape
    xs, ys = grid_coords(H, W, dev)
    planes = [R.random_plane_hypothesis(R.key(300 + i), inputs.ref_cam, xs,
                                        ys, *inputs.depth_range)
              for i in range(9)]
    cases = {}
    for name, C, parity, p in (
            ("C1_init", 1, None, dataclasses.replace(
                params, rect_win_w=params.rect_init_win)),
            ("C9_parity0", 9, 0, params), ("C5_parity1", 5, 1, params)):
        n, w = packed(torch.stack([a for a, _ in planes[:C]]),
                      torch.stack([b for _, b in planes[:C]]), parity)
        cases[name] = check_sphere_case(name, ctx, n, w, parity, p, False)
    del ctx
    res, phot = drive("sphere photometric", ("rect_ncc",),
                      lambda r: run_patchmatch(inputs, params, r))
    if phot["launches"]["rect_ncc"] != 4 * SPHERE_PHOT_LAUNCHES:
        raise AssertionError("the sphere photometric pass did not launch "
                             f"rect_ncc {SPHERE_PHOT_LAUNCHES} times")
    d = res[0].cpu().numpy()
    if not np_finite(d) or d.shape != gt[0].shape:
        raise AssertionError("sphere depth is not finite or misshapen")
    phot["errors"] = sphere_band_errors(d, gt[0], inputs.ref_cam)
    phot["pass_ms"] = 1e3 * sum(phot["pass_s"]) / len(phot["pass_s"])
    trace(phot, inputs, params, {})
    log(f"sphere photometric: {phot}")
    if not phot["errors"]["band"] < SPHERE_BAND_ERR_MAX:
        raise AssertionError(f"sphere band error {phot['errors']} >= "
                             f"{SPHERE_BAND_ERR_MAX}")

    t0 = time.perf_counter()
    geom_inputs = dataclasses.replace(inputs, src_depths=source_depths(
        inputs, params, key_base=2000))
    torch.cuda.synchronize()
    out["seed_passes_s"] = time.perf_counter() - t0
    geom_params = params.with_geom(multi_geometry=False)
    seeds = dict(seed_normal_world=res[1], seed_depth=res[0])
    gctx = prepare_inputs(geom_inputs, geom_params).rect
    out["build_context_geom_ms"] = cuda_ms(
        lambda: prepare_inputs(geom_inputs, geom_params), 2)
    n, w = plane_field(inputs.ref_cam, res[0], res[1])
    for name, C, parity in (("geom_C9_parity0", 9, 0),
                            ("geom_C5_parity1", 5, 1)):
        scale = 1.0 + 0.005 * (torch.arange(C, device=dev) - C // 2)
        nn, ww = packed(n.expand(C, *n.shape), w * scale[:, None, None],
                        parity)
        cases[name] = check_sphere_case(name, gctx, nn, ww, parity,
                                        geom_params, True)
    del gctx
    gres, geom = drive("sphere geometric", ("rect_ncc_geom",),
                       lambda r: run_patchmatch(geom_inputs, geom_params,
                                                50 + r, **seeds))
    if geom["launches"]["rect_ncc_geom"] != 4 * SPHERE_GEOM_LAUNCHES:
        raise AssertionError("the sphere geometric pass did not launch "
                             f"rect_ncc_geom {SPHERE_GEOM_LAUNCHES} times")
    gd = gres[0].cpu().numpy()
    if not np_finite(gd):
        raise AssertionError("sphere geometric depth is not finite")
    geom["errors"] = sphere_band_errors(gd, gt[0], inputs.ref_cam)
    geom["pass_ms"] = 1e3 * sum(geom["pass_s"]) / len(geom["pass_s"])
    trace(geom, geom_inputs, geom_params, seeds)
    log(f"sphere geometric: {geom}")
    if not geom["errors"]["band"] < SPHERE_BAND_ERR_MAX:
        raise AssertionError(f"sphere geometric band error {geom['errors']} "
                             f">= {SPHERE_BAND_ERR_MAX}")
    for k, names in (("rect_ncc", ("C1_init", "C9_parity0", "C5_parity1")),
                     ("rect_ncc_geom", ("geom_C9_parity0",
                                        "geom_C5_parity1"))):
        results[k]["sphere_cases"] = {
            nm: dict(ms=cases[nm]["ms"], plain_ms=cases[nm]["plain_ms"],
                     bound_ms=cases[nm]["bound"][0],
                     bound_by=cases[nm]["bound"][1]) for nm in names}
    out.update(cases=cases, phot=phot, geom=geom)
    return out


def check_convert():
    """Phase 11: ``convert`` (the CLI) on a small synthetic COLMAP model
    with a SPHERE camera; the scene folder must read back."""
    import tempfile

    from acmmp_spherical_torch.io.scene import (
        read_camera_file, read_pair_file,
    )
    from acmmp_spherical_torch.pipeline.cli import main as cli_main
    from acmmp_spherical_torch.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene, write_synthetic_colmap,
    )

    cams = make_ring_of_cameras(5, model="sphere", width=64, height=32,
                                device="cpu")
    images, depths, _ = render_scene(cams, CubeRoom(), 64, 32)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        write_synthetic_colmap(root / "colmap", cams, images, depths)
        if cli_main(["convert", "--dense_folder", str(root / "colmap"),
                     "--save_folder", str(root / "scene"), "--top_k", "4",
                     "--min_shared", "5", "--theta0", "0.05"]) != 0:
            raise AssertionError("convert failed")
        problems = read_pair_file(root / "scene" / "pair.txt")
        models = [read_camera_file(root / "scene" / "cams" / f"{i:08d}_cam.txt",
                                   device="cpu").model for i in range(5)]
        n_images = len(list((root / "scene" / "images").glob("*.jpg")))
    log(f"convert: {len(problems)} problems, sources per view "
        f"{[len(p.src_image_ids) for p in problems]}, models {models}, "
        f"{n_images} images")
    if not (len(problems) == 5 and all(len(p.src_image_ids) >= 2
                                       for p in problems)
            and models == ["sphere"] * 5 and n_images == 5):
        raise AssertionError("the converted scene folder does not read back")
    return dict(problems=len(problems), models=models, images=n_images)


def packed_ctx(ctx, parity):
    """The reference tap context on one colour's packed half-grid."""
    from acmmp_spherical_torch.ops.ncc import RefTapContext
    from acmmp_spherical_torch.ops.sampling import (
        checkerboard_coords, checkerboard_pack,
    )

    P = lambda a: checkerboard_pack(a, parity)
    xs, ys = checkerboard_coords(*ctx.xs.shape, parity, ctx.xs.device)
    return RefTapContext(ctx.offsets, P(ctx.ref_taps), P(ctx.weights),
                         P(ctx.center), xs, ys)


def plane_field(cam, depth, normal_world):
    """(normal, w) of a depth map and its world normals in ``cam``'s frame."""
    from acmmp_spherical_torch.core import geometry as G
    from acmmp_spherical_torch.ops.sampling import grid_coords

    xs, ys = grid_coords(*depth.shape, depth.device)
    n = G.normalize(G.normal_world_to_cam(cam, normal_world))
    return n, G.dist_to_origin(cam, xs, ys, depth, n)


def check_window_case(name, inputs, ctx, normals, ws, p, dep):
    """ncc_window (with ``dep``: its with_geom variant) against its plain
    version on one batched launch of C plane fields: bit-identical.
    Returns (max |kernel - plain|, the kernel's operands)."""
    import torch

    from acmmp_spherical_torch.ops.kernels import ncc_window as NW

    ops = NW._setup(inputs.src_images, inputs.src_cams, inputs.ref_cam,
                    normals, ws, ctx, dep)
    ck = NW.ncc_window(**ops, params=p)
    cp = NW.ncc_window_plain(**ops, params=p)
    torch.cuda.synchronize()
    pairs = tuple(zip(ck, cp)) if dep is not None else ((ck, cp),)
    err = max(float((k - pl).abs().nan_to_num(float("inf")).max())
              for k, pl in pairs)
    if not all(torch.equal(k, pl) for k, pl in pairs):
        raise AssertionError(f"ncc_window {name}: not bit-identical to the "
                             f"plain version (max err {err})")
    msg = (f"ncc_window {name}: bit-identical, live fraction "
           f"{float((pairs[0][1] < p.cost_max).float().mean()):.3f}")
    if dep is not None:
        msg += (f", gok fraction "
                f"{float((pairs[1][1] < p.geom_max_cost).float().mean()):.3f}")
    log(msg)
    return err, ops


def window_timing(ops, p):
    """ms per launch of ncc_window and of its plain version on one batch,
    and the bound of the launch from its inputs."""
    from acmmp_spherical_torch.ops.kernels import ncc_window as NW

    C, H, W = ops["w"].shape
    S = ops["src"].shape[0]
    n_taps = ops["taps"].shape[0]
    outs = 1 if ops["dep"] is None else 2
    nb = nbytes(*(t for t in ops.values() if t is not None)) \
        + outs * C * S * H * W * 4
    flops = C * H * W * n_taps * (WIN_PLANE_FLOPS + S * WIN_VIEW_FLOPS)
    ms = cuda_ms(lambda: NW.ncc_window(**ops, params=p), 10)
    bnd = bound(nb, flops)
    return dict(ms=ms, ms_per_field=ms / C,
                plain_ms=cuda_ms(lambda: NW.ncc_window_plain(**ops, params=p),
                                 1),
                bound_ms=bnd[0], bound_by=bnd[1])


def check_window_kernel(label, inputs, p, fields, dep):
    """Phases 6-7: ncc_window (``dep``: with_geom) on the batched launches of
    the windowed pass's packed half-grids, parity 0 with 9 fields and parity
    1 with 5, for each family of full-grid plane fields in ``fields``
    ({family: [(normal, w), ...]}); returns its kernel entry, timed on the
    first family's launches (``ms`` at C=9, every case under ``cases``)."""
    import torch

    from acmmp_spherical_torch.ops.ncc import ref_tap_context

    ctx = ref_tap_context(inputs.ref_image, inputs.ref_cam, p)
    cases, errs = {}, []
    for family, planes in fields.items():
        for C, parity in ((9, 0), (5, 1)):
            n, w = packed(torch.stack([a for a, _ in planes[:C]]),
                          torch.stack([b for _, b in planes[:C]]), parity)
            case = f"C{C}_parity{parity}"
            err, ops = check_window_case(f"{label} {family} {case}",
                                         inputs, packed_ctx(ctx, parity), n,
                                         w, p, dep)
            errs.append(err)
            if case not in cases:
                cases[case] = window_timing(ops, p)
                log(f"ncc_window {label} {case}: {cases[case]}")
    c9 = cases["C9_parity0"]
    e = kernel_entry("ncc_window.cu", "ncc_window.py:346", max(errs),
                     c9["ms"], c9["plain_ms"],
                     (c9["bound_ms"], c9["bound_by"]))
    e["ms_per_field"] = c9["ms_per_field"]
    e["cases"] = cases
    return e


def centre_projections(inputs, depth):
    """(x, y) (S, H, W) of each pixel of ``depth`` in every source view."""
    import torch

    from acmmp_spherical_torch.core import geometry as G
    from acmmp_spherical_torch.core.camera import camera_index
    from acmmp_spherical_torch.ops.sampling import grid_coords

    xs, ys = grid_coords(*depth.shape, depth.device)
    X = G.unproject_world(inputs.ref_cam, xs, ys, depth)
    pts = [G.project(camera_index(inputs.src_cams, s), X)[:2]
           for s in range(inputs.src_images.shape[0])]
    return torch.stack([x for x, _ in pts]), torch.stack([y for _, y in pts])


def check_window_sample(inputs, depth):
    """Phase 6: window_sample (``windowed_sample``: one launch that places
    the windows itself) against its plain version, bit for bit on values
    and ok, on the centre-tap projections of ``depth`` into each source
    view; returns its entry, timed on view 0: ``ms`` the kernel's device
    time, ``call_ms`` the whole call."""
    import torch

    from acmmp_spherical_torch.ops.kernels import window_sample as WS

    H, W = depth.shape
    px, py = centre_projections(inputs, depth)
    err = 0.0
    for s in range(px.shape[0]):
        args = (inputs.src_images[s], px[s], py[s])
        v, ok = WS.windowed_sample(*args, src_h=H, src_w=W)
        vp, okp = WS.windowed_sample_plain(*args, src_h=H, src_w=W)
        torch.cuda.synchronize()
        err = max(err, float((v - vp).abs().max()))
        if not (torch.equal(ok, okp) and torch.equal(v, vp)):
            raise AssertionError(f"window_sample view {s}: not bit-identical "
                                 f"to the plain version (max err {err})")
        log(f"window_sample view {s}: bit-identical, ok fraction "
            f"{float(ok.float().mean()):.3f}")
    args = (inputs.src_images[0], px[0], py[0])
    call = lambda: WS.windowed_sample(*args, src_h=H, src_w=W)
    ms, per_call = device_ms(call, "window_sample_kernel", 20)
    # x, y and the source frame read once, values and ok written once
    v, ok = call()
    e = kernel_entry(
        "window_sample.cu", "window_sample.py:144", err, ms,
        cuda_ms(lambda: WS.windowed_sample_plain(*args, src_h=H, src_w=W),
                3),
        bound(nbytes(*args, v, ok), H * W * SAMPLE_FLOPS))
    e.update(call_ms=cuda_ms(call, 20), device_kernels_per_call=per_call)
    log(f"window_sample: {e}")
    return e


def warp_residual(inputs, depth):
    """The windowed sampler's path: every source view warped into the
    reference frame through ``depth`` (``windowed_sample``); returns the
    median |reference - warped| over the samples that are ok in all
    views and the fraction of such pixels."""
    import torch

    from acmmp_spherical_torch.ops.kernels.window_sample import (
        windowed_sample,
    )

    H, W = depth.shape
    px, py = centre_projections(inputs, depth)
    res, all_ok = [], torch.ones_like(depth, dtype=torch.bool)
    for s in range(px.shape[0]):
        v, ok = windowed_sample(inputs.src_images[s], px[s], py[s],
                                src_h=H, src_w=W)
        res.append((v - inputs.ref_image).abs())
        all_ok &= ok
    r = torch.stack(res).amax(0)[all_ok]
    return float(r.median()), float(all_ok.float().mean())


def drive(name, kernels, fn, reps: int = 3):
    """Run a path once warm and ``reps`` times timed with the launch
    counters zeroed just before and read just after."""
    import torch

    from acmmp_spherical_torch.ops.kernels import _lib

    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    fn(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times = []
    for r in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(r + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(_lib.LAUNCHES)
    log(f"{name} pass times (s): warm {warm_s:.3f}, timed {times}; "
        f"launches {launches}")
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 f"{name} path")
    return out, dict(warm_s=warm_s, pass_s=times, launches=launches)


PASS_SCOPE = r"(photometric|hierarchy|geom\d+)_s\d+"


def _same(a, b) -> bool:
    """Bit-for-bit equality of two outputs (tensors or tuples of them),
    NaN where both are NaN counting as equal."""
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_same, a, b))
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0),
                                               b.masked_fill(nb, 0))


def _max_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(map(_max_err, a, b))
    if not a.is_floating_point():
        return float((a != b).any())
    return float((a - b).abs().nan_to_num(0.0).max()) if a.numel() else 0.0


class LaunchScopes:
    """The ``Timings`` hook of a ``run_pipeline`` run: it reads the launch
    counters as each pass scope (``photometric_s1``, ``geom0_s0``, ...)
    opens and closes, and as the pass's ``prior_build`` scope closes, and
    sorts the launches by pass and round (``main``; ``prior`` after the
    prior build).  ``check`` holds the first launch of each kernel at each
    set of operand shapes in each (pass, round) against the kernel's plain
    version; its own time is left out of every scope and its peak memory
    out of ``peak``."""

    def __init__(self):
        from acmmp_spherical_torch.utils.log import Timings

        self.timings = Timings(hook=self)
        self.by_round: dict = {}      # (pass, round) -> {kernel: launches}
        self.prior_rounds: dict = {}  # pass -> rounds that launched
        self.checks: dict = {}        # (pass, round, kernel, shapes) -> err
        self.failures: list = []
        self.peak = 0
        self._pass = self._round = None
        self._snap: dict = {}

    def _close_round(self):
        from acmmp_spherical_torch.ops.kernels import _lib

        acc = self.by_round.setdefault((self._pass, self._round),
                                       dict.fromkeys(_lib.LAUNCHES, 0))
        for k, v in _lib.LAUNCHES.items():
            acc[k] += v - self._snap[k]
        self._snap = dict(_lib.LAUNCHES)
        return acc

    def __call__(self, name: str, entering: bool) -> None:
        import re

        from acmmp_spherical_torch.ops.kernels import _lib

        is_pass = re.fullmatch(PASS_SCOPE, name) is not None
        if entering:
            if is_pass:
                self._pass, self._round = name, "main"
                self._snap = dict(_lib.LAUNCHES)
        elif name == "prior_build" and self._pass is not None:
            self._close_round()
            self._round = "prior"
        elif is_pass:
            round_ = self._round
            acc = self._close_round()
            if round_ == "prior" and (acc["rect_ncc"] or acc["ncc_window"]):
                self.prior_rounds[name] = self.prior_rounds.get(name, 0) + 1
            self._pass = self._round = None

    def check(self, kernel, shapes, out, plain):
        import torch

        key = (self._pass, self._round, kernel, shapes)
        if key in self.checks:
            return
        torch.cuda.synchronize()
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        t0 = time.perf_counter()
        ref = plain()
        torch.cuda.synchronize()
        same, err = _same(out, ref), _max_err(out, ref)
        del ref
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.timings.excluded_s += time.perf_counter() - t0
        self.checks[key] = err
        if not same:
            # kept, since run_pipeline retries a failed pass and then
            # skips the view
            self.failures.append(
                f"{kernel} in {self._pass} ({self._round} round), "
                f"operands {shapes}: not bit-identical to the plain "
                f"version, max err {err}")
            raise AssertionError(self.failures[-1])


@contextlib.contextmanager
def checked_kernels(scopes):
    """Route the wrappers of kernels 1-6 through ``scopes.check``: the
    wrapper runs (and counts its launch) as always, then its plain version
    runs on the same operands, uncounted."""
    import torch

    from acmmp_spherical_torch.ops import sphere_rect as SR
    from acmmp_spherical_torch.ops.kernels import _lib
    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR
    from acmmp_spherical_torch.ops.kernels import ncc_window as NW
    from acmmp_spherical_torch.ops.kernels import warp_image as WI

    def checked(fn, plain):
        def call(*args, **kw):
            before = dict(_lib.LAUNCHES)
            out = fn(*args, **kw)
            kernel, = (k for k, v in _lib.LAUNCHES.items() if v != before[k])
            shapes = tuple(tuple(a.shape) for a in (*args, *kw.values())
                           if torch.is_tensor(a))
            scopes.check(kernel, shapes, out, lambda: plain(*args, **kw))
            return out
        return call

    swaps = [(NR, "coefficient_transport", NR.coefficient_transport_plain),
             (NR, "rect_ncc", NR.rect_ncc_plain),
             (SR, "rect_ncc", NR.rect_ncc_plain),
             (WI, "warp_src_frames", WI.warp_src_frames_plain),
             (WI, "warp_src_disparities", WI.warp_src_disparities_plain),
             (NW, "ncc_window", NW.ncc_window_plain)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, checked(getattr(mod, name), plain))
    try:
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


def run_pipeline_phase(dev, sc):
    """Phase 9 (pinhole) or 11 (SPHERE): ``run_pipeline`` on the CubeRoom
    ring ``sc`` written to a temporary folder; returns its numbers, with
    the launch counts of the run under ``launches``."""
    import tempfile

    import numpy as np
    import torch

    from acmmp_spherical_torch.config import PipelineConfig
    from acmmp_spherical_torch.io import read_depth_dmb, read_ply
    from acmmp_spherical_torch.io.scene import ScenePaths
    from acmmp_spherical_torch.ops.kernels import _lib
    from acmmp_spherical_torch.pipeline import multiscale
    from acmmp_spherical_torch.utils.metrics import (
        cube_surface_distance, depth_error_stats,
    )
    from acmmp_spherical_torch.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
        write_synthetic_scene_to_disk,
    )

    n_views = sc["n_views"]
    room = CubeRoom()
    t0 = time.perf_counter()
    cams = make_ring_of_cameras(n_views, **sc["cameras"], width=sc["width"],
                                height=sc["height"], device="cpu")
    images, gt, _ = render_scene(cams, room, sc["width"], sc["height"])

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp) / "scene"
        write_synthetic_scene_to_disk(root, cams, images)
        scene_s = time.perf_counter() - t0
        scopes = LaunchScopes()
        timings = scopes.timings
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launch_counts()
        with checked_kernels(scopes):
            t0 = time.perf_counter()
            n_points = multiscale.run_pipeline(root, PipelineConfig(),
                                               device=dev, timings=timings)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0 - timings.excluded_s
        if scopes.failures:
            raise AssertionError("; ".join(scopes.failures))
        launches = dict(_lib.LAUNCHES)
        peak = max(scopes.peak, torch.cuda.max_memory_allocated())
        sp = ScenePaths(root)
        manifest = json.loads(sp.manifest_file().read_text())
        expected = [f"{tag}_s{s}" for s in (1, 0) for tag in (
            "photometric" if s == 1 else "hierarchy", "geom0", "geom1")]
        entries = sum(len(set(manifest.get(k, [])) & set(range(n_views)))
                      for k in expected)
        errs = [depth_error_stats(read_depth_dmb(sp.depth_file(v, geom=True)),
                                  gt[v], border=sc["err_border"])
                ["median_rel_err"] for v in range(n_views)]
        pts = read_ply(sp.ply_file())[0]
        on_surface = float(np.mean(cube_surface_distance(pts, room.half)
                                   < sc["tau"])) if len(pts) else 0.0
    by_round = {f"{p} {r}": {k: v for k, v in acc.items() if v}
                for (p, r), acc in scopes.by_round.items()}
    checks = {}
    for (p, r, k, _), err in scopes.checks.items():
        c = checks.setdefault(f"{p} {r} {k}", dict(shapes=0, max_abs_err=0.0))
        c["shapes"] += 1
        c["max_abs_err"] = max(c["max_abs_err"], err)
    out = dict(scene_s=scene_s, wall_s=wall_s, timings_s=timings.totals,
               timing_counts=timings.counts, peak_mem_bytes=peak,
               manifest_entries=entries, median_rel_depth_err=errs,
               fused_points=n_points, on_surface=on_surface,
               launches=launches, launches_by_round=by_round,
               prior_rounds=scopes.prior_rounds, plain_checks=checks,
               plain_check_s=timings.excluded_s)
    log(f"pipeline {sc['label']} {sc['width']}x{sc['height']}x{n_views} "
        f"views: {json.dumps(out)}")
    if entries != len(expected) * n_views:
        raise AssertionError(f"pipeline manifest holds {entries} of "
                             f"{len(expected) * n_views} (pass, view) "
                             f"entries: {manifest}")
    ran = {k: timings.counts.get(k, 0) for k in expected}
    if any(n != n_views for n in ran.values()):
        raise AssertionError(f"pass scopes per pass: {ran}; every view must "
                             "run every pass once, with no retry")
    prior = {k: scopes.prior_rounds.get(k, 0) for k in expected[::3]}
    if any(n != n_views for n in prior.values()):
        raise AssertionError(f"prior rounds that launched a kernel: {prior}; "
                             f"every view's {' and '.join(prior)} pass must "
                             "run its planar-prior round")
    for k in sc["kernels"]:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "pipeline")
    unchecked = [f"{p} {r} {k}" for (p, r), acc in scopes.by_round.items()
                 for k, v in acc.items() if v and k != "window_sample"
                 and f"{p} {r} {k}" not in checks]
    if unchecked:
        raise AssertionError("kernels launched in the pipeline without a "
                             f"check against their plain version: {unchecked}")
    log(f"pipeline {sc['label']} gates: median rel depth err per view "
        f"{errs} < {sc['depth_err_max']}; {n_points} fused points > "
        f"{sc['min_points']}; {on_surface} of them within {sc['tau']} of the "
        f"surface > {sc['on_surface_min']}")
    if not max(errs) < sc["depth_err_max"]:
        raise AssertionError(f"pipeline depth errors {errs}")
    if not (n_points > sc["min_points"]
            and on_surface > sc["on_surface_min"]):
        raise AssertionError(f"fused cloud: {n_points} points, "
                             f"{on_surface} on the surface")
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 2
    try:
        import acmmp_spherical_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    from acmmp_spherical_torch.bench import (
        BENCH_SCENE, GOLDEN_KEY, GOLDEN_SCENE, golden_geom_problem,
        golden_hier_pass, golden_prior_pass, make_problem, source_depths,
    )
    from acmmp_spherical_torch.ops import rng as R
    from acmmp_spherical_torch.ops.kernels import _lib
    from acmmp_spherical_torch.ops.propagate import prepare_inputs
    from acmmp_spherical_torch.ops.sampling import grid_coords
    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    # phase 1: build
    t0 = time.perf_counter()
    lib = _lib.library()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s: {lib._name}")
    ptxas = pathlib.Path(lib._name).with_name("ptxas.log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"ptxas: {line.strip()}")

    # the bench problem and its rectified context
    t0 = time.perf_counter()
    inputs, params, gt, _ = make_problem(**BENCH_SCENE, device=dev)
    log(f"scene render {time.perf_counter() - t0:.1f} s; params "
        f"comp_hw={params.rect_comp_hw} live_n={params.rect_live_n} "
        f"init_win={params.rect_init_win} warp_hw={params.rect_warp_hw} "
        f"inv_attrib={params.rect_inv_attrib}")
    prepared = prepare_inputs(inputs, params)
    ctx_ms = cuda_ms(lambda: prepare_inputs(inputs, params), 2)
    log(f"build_rect_context {ctx_ms:.1f} ms")

    # phase 2: photometric kernels against their plain versions
    results: dict = {}
    check_phot_kernels(prepared, params, results)
    del prepared

    # phase 3: the photometric path
    out, phot = drive("photometric", PHOT_KERNELS,
                      lambda r: run_patchmatch(inputs, params, r))
    rel = median_rel_err(out[0], gt[0])
    log(f"photometric median rel depth err {rel}")
    if rel >= DEPTH_ERR_MAX:
        raise AssertionError(f"median rel depth err {rel} >= {DEPTH_ERR_MAX}")

    # phase 4: the geometric path
    t0 = time.perf_counter()
    geom_inputs = dataclasses.replace(inputs,
                                      src_depths=source_depths(inputs, params))
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    log(f"8 per-view photometric seed passes: {seed_s:.1f} s")
    geom_params = params.with_geom(multi_geometry=False)
    seeds = dict(seed_normal_world=out[1], seed_depth=out[0])
    geom_prepared = prepare_inputs(geom_inputs, geom_params)
    gctx_ms = cuda_ms(lambda: prepare_inputs(geom_inputs, geom_params), 2)
    log(f"build_rect_context with rect_sdisp {gctx_ms:.1f} ms")
    check_geom_kernels(geom_prepared, geom_params, seeds, results)
    del geom_prepared
    gout, geom = drive("geometric", GEOM_KERNELS, lambda r: run_patchmatch(
        geom_inputs, geom_params, 100 + r, **seeds))
    grel = median_rel_err(gout[0], gt[0])
    log(f"geometric median rel depth err {grel} (photometric {rel})")
    if grel >= DEPTH_ERR_MAX or grel >= rel:
        raise AssertionError(f"geometric median rel depth err {grel}: not "
                             f"below {DEPTH_ERR_MAX} and the photometric {rel}")

    # phase 5: golden passes against the reference's fixtures
    ginputs, gparams = make_problem(**GOLDEN_SCENE, device=dev)[:2]
    gparams = dataclasses.replace(gparams, rect_inv_attrib=False)
    worst = check_golden("golden_pass_stats_warp.json",
                         run_patchmatch(ginputs, gparams, GOLDEN_KEY))
    gg_inputs, gg_params, gg_seeds, _ = golden_geom_problem(dev)
    gworst = check_golden("golden_geom_pass_stats_rect.json", run_patchmatch(
        gg_inputs, gg_params, GOLDEN_KEY, **gg_seeds))

    # phase 6: the windowed photometric path (rect_ncc off, fast_ncc on),
    # as the pass runner runs a problem that fails host_rectifiable
    win_params = dataclasses.replace(params, rect_ncc=False, fast_ncc=True)
    cam = inputs.ref_cam
    xs, ys = grid_coords(*inputs.ref_image.shape, dev)
    dmin, dmax = inputs.depth_range[0], inputs.depth_range[1]
    scale = 1.0 + 0.005 * (torch.arange(9, device=dev) - 4)
    n3, w3 = plane_field(cam, out[0], out[1])
    results["ncc_window"] = check_window_kernel("phot", inputs, win_params, {
        "random": [R.random_plane_hypothesis(R.key(200 + i), cam, xs, ys,
                                             dmin, dmax) for i in range(9)],
        "around_phase3": [(n3, w3 * scale[i]) for i in range(9)]}, None)
    results["window_sample"] = check_window_sample(inputs, out[0])
    wout, win = drive("windowed photometric", ("ncc_window",),
                      lambda r: run_patchmatch(inputs, win_params, r))
    if win["launches"]["ncc_window"] != 4 * WIN_PHOT_LAUNCHES:
        raise AssertionError("the windowed photometric pass did not launch "
                             f"ncc_window {WIN_PHOT_LAUNCHES} times")
    wrel = median_rel_err(wout[0], gt[0])
    log(f"windowed photometric median rel depth err {wrel} (rectified {rel})")
    if wrel >= WINDOW_ERR_MAX:
        raise AssertionError(f"windowed median rel depth err {wrel} >= "
                             f"{WINDOW_ERR_MAX}")
    # the windowed sampler's own path: the source views warped into the
    # reference frame through the windowed pass's depth, against the same
    # warp through the ground truth
    (resid, resid_ok), samp = drive(
        "windowed sampler", ("window_sample",),
        lambda r: warp_residual(inputs, wout[0]))
    gt_resid, _ = warp_residual(inputs, torch.as_tensor(gt[0], device=dev))
    log(f"warp residual {resid} on {resid_ok:.3f} of the pixels (ground "
        f"truth depth: {gt_resid})")
    if not resid_ok > 0.5 or not resid <= 2.0 * gt_resid + WARP_RESID_SLACK:
        raise AssertionError(f"warp residual {resid} ({resid_ok}) against "
                             f"{gt_resid} at the ground truth")

    # phase 7: the windowed geometric path, phase 4's source depths, seeded
    # from phase 6
    wg_params = win_params.with_geom(multi_geometry=False)
    nw, ww = plane_field(cam, wout[0], wout[1])
    results["ncc_window_geom"] = check_window_kernel(
        "geom", geom_inputs, wg_params,
        {"around_phase6": [(nw, ww * scale[i]) for i in range(9)]},
        geom_inputs.src_depths)
    wseeds = dict(seed_normal_world=wout[1], seed_depth=wout[0])
    wgout, wgeom = drive("windowed geometric", ("ncc_window_geom",),
                         lambda r: run_patchmatch(geom_inputs, wg_params,
                                                  100 + r, **wseeds))
    if wgeom["launches"]["ncc_window_geom"] != 4 * WIN_GEOM_LAUNCHES:
        raise AssertionError("the windowed geometric pass did not launch "
                             f"ncc_window_geom {WIN_GEOM_LAUNCHES} times")
    wgrel = median_rel_err(wgout[0], gt[0])
    log(f"windowed geometric median rel depth err {wgrel} (windowed "
        f"photometric {wrel})")
    if wgrel >= wrel:
        raise AssertionError(f"windowed geometric median rel depth err "
                             f"{wgrel}: not below the photometric {wrel}")

    # phase 8: the exact and windowed golden passes, and odd-frame passes
    # on each path, against the reference's statistics
    ginputs, gparams = make_problem(**GOLDEN_SCENE, device=dev)[:2]
    eworst = check_golden("golden_pass_stats.json", run_patchmatch(
        ginputs, dataclasses.replace(gparams, rect_ncc=False), GOLDEN_KEY))
    wworst = check_golden("golden_pass_stats_window.json", run_patchmatch(
        ginputs, dataclasses.replace(gparams, rect_ncc=False, fast_ncc=True),
        GOLDEN_KEY))
    oinputs, oparams = make_problem(**ODD_SCENE, device=dev)[:2]
    oworst = {path: check_golden("golden_pass_stats_odd.json", run_patchmatch(
        oinputs, dataclasses.replace(oparams, **change), GOLDEN_KEY), path)
        for path, change in (
            ("rect", dict(rect_inv_attrib=True)),
            ("window", dict(rect_ncc=False, fast_ncc=True)),
            ("exact", dict(rect_ncc=False)))}

    # phase 8b: the golden planar-prior and hierarchy passes
    ginputs, gparams, gdepths, gnormals = make_problem(**GOLDEN_SCENE,
                                                       device=dev)
    pworst = {path: check_golden(
        f"golden_prior_pass_stats_{path}.json",
        golden_prior_pass(ginputs, dataclasses.replace(gparams, **change)))
        for path, change in (("rect", {}),
                             ("window", dict(rect_ncc=False, fast_ncc=True)))}
    hworst = check_golden("golden_hier_pass_stats_rect.json",
                          golden_hier_pass(ginputs, gparams, gdepths, gnormals))

    # phase 9: the pipeline at a real size, every kernel of it also held
    # against its plain version at the pipeline's own operands
    pipe = run_pipeline_phase(dev, PIPELINE_SCENE)

    # phase 10: the sphere passes at 1024x512x6src, kernels 1 and 4 held
    # against their plain versions at their pole-rotated operands
    sphere = run_sphere_phase(dev, results)

    # phase 11: the sphere scene through run_pipeline, and convert
    spipe = run_pipeline_phase(dev, SPHERE_PIPELINE_SCENE)
    conv = check_convert()
    for p_ in (pipe, spipe):
        for key, c in p_["plain_checks"].items():
            e = results[key.rsplit(" ", 1)[1]]
            e["max_abs_err"] = max(e["max_abs_err"], c["max_abs_err"])
            e["pipeline_checks"] = e.get("pipeline_checks", 0) + c["shapes"]

    names = ("rect_ncc", "rect_ncc_geom", "warp_transport", "warp_src_frames",
             "warp_src_disparities", "ncc_window", "ncc_window_geom",
             "window_sample")
    paths = (phot, geom, win, wgeom, samp, pipe, sphere["phot"],
             sphere["geom"], spipe)
    kernels = [dict(name=k, launches=sum(p["launches"][k] for p in paths),
                    **results[k]) for k in names]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} was never launched")
    log("details " + json.dumps({
        "card": card, "build_s": build_s,
        "stages_ms": {"build_rect_context": ctx_ms,
                      "build_rect_context_geom": gctx_ms, **results["cases"]},
        "photometric": phot, "geometric": geom, "seed_passes_s": seed_s,
        "windowed_photometric": win, "windowed_geometric": wgeom,
        "windowed_sampler": samp, "warp_residual": resid,
        "warp_residual_gt": gt_resid,
        "median_rel_depth_err": rel, "geom_median_rel_depth_err": grel,
        "window_median_rel_depth_err": wrel,
        "window_geom_median_rel_depth_err": wgrel,
        "golden_worst_over_tol": worst, "golden_geom_worst_over_tol": gworst,
        "golden_exact_worst_over_tol": eworst,
        "golden_window_worst_over_tol": wworst,
        "golden_odd_worst_over_tol": oworst,
        "golden_prior_worst_over_tol": pworst,
        "golden_hier_worst_over_tol": hworst, "pipeline": pipe,
        "sphere": sphere, "sphere_pipeline": spipe, "convert": conv,
        "smoke_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
