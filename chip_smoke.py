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
   equal its plain version bit for bit.  Phases 2-8 and 10 pin both bf16
   packs off (the f32 variant of kernels 1 and 4); on the operands of each
   rect_ncc case the packed-tap variant (``rect_tap_pack``, kernels 1p and
   4p) reads the pair-word frame that ``pack_src_pairs`` makes of the
   case's source frame (held word for word against its plain version and
   timed with its bytes bound), is held bit for bit against its packed
   plain version, must differ from the f32 variant, and is timed beside it
   (f32, packed, packed, f32);
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
4b. the packed bench points: the photometric and geometric passes of
   phases 3-4 with both bf16 packs on (the defaults), the packed chain
   (seeds and source depths from packed passes), at the same gates, and no
   launch of the f32 kernels; then the photometric pass with each pack
   alone (its error printed, not gated); each through ``drive_checked``
   (the first launch of each kernel at each operand shape held bit for bit
   against its plain version, ``pack_src_pairs`` word for word);
5. the 96x64x3src golden photometric and geometric passes match the
   reference's committed statistics at drift_gate's 2e-2, the photometric
   one with the packs off and on (the fixture was made with them on);
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
   held below the photometric one); then both passes again with both bf16
   packs on, at the same gate, through ``drive_checked``;
11. the sphere scene: ``run_pipeline`` with ``PipelineConfig()`` defaults on
   6 equirect views of the CubeRoom ring at 1024x512 (two scales, 512x256
   then 1024x512), with the same launch sorting and first-launch checks as
   phase 9; every view must run each pass once and every prior round must
   launch kernels; each view's median relative depth error < 0.08, more
   than 1500 fused points, more than 70% of them within 0.2 of the cube
   surface (tests/test_multiscale_sphere.py:77-81); then ``convert`` on a
   small synthetic COLMAP model with a SPHERE camera, whose scene folder
   must read back;
12. the batched pipeline: phase 9's scene through ``run_pipeline`` with
   ``batch_problems="on"`` over a mesh of 3 slots of the one card (chunks
   of 3, 3 and 2 problems, each slot a host thread on a CUDA stream of its
   own) with the serial ``process_problem`` made to raise, twice: once
   with the first launch of each kernel at each operand shape in each
   (pass, round, slot) held bit for bit against its plain version, once
   timed.  Every file of each run (``.dmb``, ``triangulation.png``, the
   manifest, the PLY) must equal phase 9's byte for byte and its launches
   per pass and round phase 9's; then ``fuse_all_views_sharded`` over the
   3 slots on phase 9's results must equal ``fuse_all_views``, and
   ``multichip_step`` on 8 synthetic problems (256x192, 3 sources, the
   windowed path) over the 3 slots: once with its launches counted (both
   ``ncc_window`` and ``ncc_window_geom`` must launch) and the first launch
   of each at each operand shape in each slot held bit for bit against its
   plain version, then again over the 3 slots and over one, all three
   equal bit for bit.  The wall time
   beside phase 9's, the loads and the time waited for them (their
   overlap with device work) and the peak memory are printed;
13. ``python -m acmmp_spherical_torch reconstruct --distributed`` as two
   ranks on the one card (a gloo group on 127.0.0.1, each rank printing
   its launch counts as it exits) on a copy of phase 11's scene: both exit
   0, each runs the round-robin share of every pass, only rank 0 fuses,
   every file equals phase 11's byte for byte (the manifest as sets of
   entries: ranks mark in completion order), the ranks' launches add up to
   phase 11's, and in each rank the first launch of each kernel at each
   operand shape is held bit for bit against its plain version;
14. the discontinuity golden (tests/test_discontinuity.py): an
   OccludedRoom ring of 4 views at 96x64, key 3, through the exact,
   windowed and rectified paths at the defaults (packed), and the
   rectified path with ``rect_prescreen``, median relative depth error <
   0.02 and < 0.06 in the band around the depth steps; each path's first
   launch of each kernel at each operand shape is held bit for bit against
   its plain version, and every kernel a path launches must have been
   checked;
15. the hostile bench pass: ``render_scene_hostile`` of an OccludedRoom on
   the 1024x768x8src ring, one rectified photometric pass with both bf16
   packs off and one with both on, their median errors and shares within
   1% (gated on finite depth only), with the first-launch checks of phase
   14 in each warm pass;
16. the tile-parallel path (``parallel/tile.py``), which forces the exact
   path: the 1024x768x8src photometric pass, the geometric pass seeded
   from it with phase 4's source depths and the 1024x512x6src SPHERE
   photometric pass, at one iteration each, once warm, then timed on one
   slot and in width
   tiles over 2 and 3 slots of the card, with the card's peak memory; each
   tiled pass must equal the one-slot pass bit for bit (else the share of
   identical pixels is printed and rtol 1e-5, atol 1e-4 hold), and no
   kernel may launch; then ``python -m acmmp_spherical_torch reconstruct
   --tile-shard 2 --no-prior`` on a 3-view 256x192 ring beside
   ``run_pipeline`` of the same scene on the exact path: every file equal
   (the manifest as sets), the fused point count within 2%, no kernel
   launched;
17. ``rect_prescreen`` (candidates ranked at the coarse 11x11 stride-5
   pattern, 9 taps, by the 9-tap builds of kernels 1, 1p, 4 and 4p): the
   1024x768x8src photometric pass and the geometric pass seeded from it
   (phase 4's source depths) at the defaults and with both packs off, and
   the 1024x512x6src SPHERE photometric and geometric passes (phase 10's
   source depths) at the defaults, each once through ``drive_checked``
   with its launches at full taps and of the 9-tap build counted exactly
   (13 + 12 per photometric pass, 9 + 4 per geometric one); the packed
   bench passes below 0.0032, the geometric one below the photometric
   one, the SPHERE band errors below 0.02; the 9-tap builds at C = 8, 5,
   2, 1 on the pinhole and SPHERE operands, bit for bit against the plain
   version, timed beside the build with runtime tap bounds and the 36-tap
   build; each default and prescreen pass in turn (a warm one, 3 timed)
   on the host clock, then traced once (device time, idle share); phase
   11's scene through ``run_pipeline`` with prescreen on, checked and gated
   as phase 11, beside phase 11's run.
Phases 9 and 11-13 run ``PipelineConfig()`` defaults, both bf16 packs on:
their first-launch checks hold kernels 1p and 4p against the packed plain
version and ``pack_src_pairs`` (once per context: the prior round reuses
its pass's) against its plain version, and the f32 kernels 1 and 4 must
not launch there.  Every kernel must have been launched by one of the
driven paths.

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
import os
import pathlib
import subprocess
import sys
import tempfile
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
    kernels=("rect_ncc_pk", "rect_ncc_geom_pk", "pack_src_pairs",
             "warp_transport", "warp_src_frames", "warp_src_disparities"))
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
    kernels=("rect_ncc_pk", "rect_ncc_geom_pk", "pack_src_pairs"))
# the pipelines run PipelineConfig() defaults, both bf16 packs on: the f32
# variants of kernels 1 and 4 must not launch there
F32_RECT_KERNELS = ("rect_ncc", "rect_ncc_geom", "rect_ncc_t9",
                    "rect_ncc_geom_t9")
# phase 12: slots of the one card for the batched pipeline (the phase-9
# scene's 8 problems in chunks of 3, 3 and 2) and the view-parallel step's
# synthetic batch
BATCH_SLOTS = 3
MULTICHIP_BATCH = dict(n=8, width=256, height=192, n_src=3, focal=224.0)
ODD_SCENE = dict(width=95, height=64, n_src=3, focal=80.0, radius=0.35)
PHOT_KERNELS = ("rect_ncc", "warp_transport", "warp_src_frames")
GEOM_KERNELS = ("rect_ncc_geom", "warp_transport", "warp_src_frames",
                "warp_src_disparities")
PK_PHOT_KERNELS = ("rect_ncc_pk", "pack_src_pairs", "warp_transport",
                   "warp_src_frames")
PK_GEOM_KERNELS = ("rect_ncc_geom_pk", "pack_src_pairs", "warp_transport",
                   "warp_src_frames", "warp_src_disparities")
# phase 14: the discontinuity golden (tests/test_discontinuity.py: an
# OccludedRoom ring of 4 views at 96x64, focal 80, key 3) and its gates
DISCONTINUITY = dict(width=96, height=64, n_views=4, focal=80.0, key=3,
                     err_max=0.02, band_err_max=0.06)
# phase 16: the tile-parallel pass over slots of the one card (the exact
# path, which tile-shard mode forces) at one iteration per pass (the bench
# passes' 3, and the geometric pass's 2, cut for time: a tile costs the
# card about a whole exact pass of launches), its fallback gate where a
# tiled pass is not bit-identical (tests/test_parallel.py:71), and the tiled
# pipeline's scene: 3 views at 256x192, one scale, the bench ring's focal
# 0.9 W, without the planar-prior round (an exact pass costs ~6-7 s at any
# size; with the prior round the serial run took 86.2 s and the tiled one
# 150.2 s, run at once)
TILE_SLOTS = (2, 3)
TILE_ITERATIONS = 1
TILE_RTOL, TILE_ATOL = 1e-5, 1e-4
TILE_PIPELINE_SCENE = dict(label="tile", n_views=3, width=256, height=192,
                           cameras=dict(focal=230.4, radius=0.25))
# phase 17: rect_prescreen.  Launches of kernel 1 (4 in geometric passes)
# per pass at full taps and of its 9-tap build: a photometric pass runs the
# C=1 init at full taps, then per half-step C=8 coarse, C=2 full, C=5 coarse
# and C=1 full (6 half-steps); a geometric pass the init, then per half-step
# C=9 full, C=5 coarse and C=1 full (4 half-steps)
PRESCREEN_PHOT_LAUNCHES = dict(full=13, coarse=12)
PRESCREEN_GEOM_LAUNCHES = dict(full=9, coarse=4)
PRESCREEN_TIMED = 3      # default and prescreen passes in turn, after a warm
#                          pair
PRESCREEN_TRACED = ("photometric default", "photometric prescreen",
                    "sphere photometric default",
                    "sphere photometric prescreen")   # device-traced
T9_CANDIDATES = (8, 5, 2, 1)   # the candidate counts of a prescreened pass
# the SPHERE scene of phase 11 with prescreen on: its 9-tap builds launch
SPHERE_PRESCREEN_SCENE = dict(
    SPHERE_PIPELINE_SCENE,
    kernels=SPHERE_PIPELINE_SCENE["kernels"] + ("rect_ncc_pk_t9",
                                                "rect_ncc_geom_pk_t9"))


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
        packed=check_packed_case(name, rargs, sd, ncc_bound),
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


def check_src_pairs(name, src):
    """``pack_src_pairs`` on the frame ``src``: word for word against its
    plain version; its CUDA-event time with its bytes bound (one f32 read
    and one word written per element).  Returns (pair frame, numbers)."""
    import torch

    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR

    pk = NR.pack_src_pairs(src)
    pl = NR.pack_src_pairs_plain(src)
    torch.cuda.synchronize()
    if not torch.equal(pk, pl):
        raise AssertionError(f"pack_src_pairs {name}: "
                             f"{int((pk != pl).sum())} words differ from the "
                             "plain version")
    return pk, dict(shape=list(src.shape), max_abs_err=0.0,
                    ms=cuda_ms(lambda: NR.pack_src_pairs(src), 20),
                    plain_ms=cuda_ms(lambda: NR.pack_src_pairs_plain(src), 3),
                    bound=bound(nbytes(src, pk), 0))


def check_packed_case(name, rargs, sd, bnd):
    """Kernel 1p (``sd`` holding sdisp: 4p), the packed-tap variant, on the
    operands ``rargs`` of an f32 case and the pair-word frame of their
    source frame (``check_src_pairs``, under ``pairs``): bit for bit
    against its plain version with the same flag; its CUDA-event time
    beside the f32 variant's on the same operands (in turns f32, packed,
    packed, f32), with kernel 1's bound."""
    import torch

    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR

    *args, p = rargs
    pk, pairs = check_src_pairs(name, args[4])
    pp = dataclasses.replace(p, rect_tap_pack=True)
    fp = dataclasses.replace(p, rect_tap_pack=False)
    k = NR.rect_ncc(*args, pp, **sd, src_pk=pk)
    pl = NR.rect_ncc_plain(*args, pp, **sd)
    f32 = NR.rect_ncc(*args, fp, **sd)
    torch.cuda.synchronize()
    if not _same(k, pl):
        raise AssertionError(f"rect_ncc packed {name}: not bit-identical to "
                             f"the plain version, max err {_max_err(k, pl)}")
    cost, cost32 = (k[0], f32[0]) if sd else (k, f32)
    changed = float((cost != cost32).float().mean())
    t = [cuda_ms(lambda q=q, x=x: NR.rect_ncc(*args, q, **sd, **x), 5)
         for q, x in ((fp, {}), (pp, dict(src_pk=pk)), (pp, dict(src_pk=pk)),
                      (fp, {}))]
    out = dict(ms=(t[1] + t[2]) / 2, f32_ms=(t[0] + t[3]) / 2,
               ms_turns=t, plain_ms=cuda_ms(
                   lambda: NR.rect_ncc_plain(*args, pp, **sd), 1),
               bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=0.0,
               changed_fraction=changed, pairs=pairs)
    log(f"rect_ncc{'_geom' if sd else ''}_pk {name}: bit-identical to its "
        f"plain version; {out}")
    if not changed > 0.0:
        raise AssertionError(f"rect_ncc packed {name}: equals the f32 "
                             "variant everywhere")
    return out


def pairs_entry(cases: dict, ptxas: dict):
    """The kernel entry of ``pack_src_pairs`` over the frames of the packed
    cases {name: case}: the first case's numbers, every frame's under
    ``cases`` and ptxas' registers and spills."""
    first = next(iter(cases.values()))["pairs"]
    e = kernel_entry("pack_src_pairs.cu", "ncc_rect.py:297", 0.0,
                     first["ms"], first["plain_ms"], first["bound"])
    e.update(cases={n: c["pairs"] for n, c in cases.items()},
             ptxas=ptxas.get("pack_src_pairs", {}))
    return e


def ptxas_of(ptxas: dict, variant: str) -> dict:
    """ptxas' numbers of one variant's instantiations but the 9-tap one
    (``rect_ptxas``; ``variant`` "phot", "geom", "phot_pk" or "geom_pk");
    with "_t9" appended, of its 9-tap instantiation alone."""
    if variant.endswith("_t9"):
        return {variant: ptxas.get(variant, {})}
    return {k: v for k, v in ptxas.items()
            if k.rsplit("_", 1)[0] == variant and not k.endswith("_t9")}


def packed_entry(cases: dict, ptxas: dict, variant: str):
    """The kernel entry of 1p or 4p (``variant`` "phot_pk" or "geom_pk")
    over its cases {name: case}: the first case's numbers, every case's
    under ``cases``, and ptxas' registers and spills."""
    first = next(iter(cases.values()))
    e = kernel_entry("rect_ncc.cu", "ncc_rect.py:614", 0.0, first["ms"],
                     first["plain_ms"], (first["bound_ms"], first["bound_by"]))
    e.update(f32_ms=first["f32_ms"], variant="rect_tap_pack=True",
             cases=cases, ptxas=ptxas_of(ptxas, variant))
    return e


def rect_ptxas(path) -> dict:
    """{variant: {registers, spill_stores, spill_loads}} of the
    rect_ncc_kernel instantiations in the build's ptxas log; a variant is
    "phot" or "geom", "_pk" for packed taps, then "_default" (the unrolled
    11x11 stride-2 taps), "_t9" (the unrolled 11x11 stride-5 taps of
    rect_prescreen) or "_runtime" (tap bounds read at run time); and of the
    pair-frame kernel, "pack_src_pairs"."""
    import re

    from acmmp_spherical_torch.ops.kernels.ncc_rect import TAP_BUILDS

    out, cur = {}, None
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            t = re.search(r"rect_ncc_kernelILb(\d)ELb(\d)ELi(\d+)E",
                          m.group(1))
            cur = None if t is None else (
                ("geom" if t.group(1) == "1" else "phot")
                + ("_pk" if t.group(2) == "1" else "")
                + TAP_BUILDS[t.group(3)])
            if "pack_src_pairs_kernel" in m.group(1):
                cur = "pack_src_pairs"
            if cur is not None:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


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
    results["rect_ncc"]["ptxas"] = ptxas_of(results["ptxas"], "phot")
    results["rect_ncc_pk"] = packed_entry(
        {n: results["cases"][n]["packed"] for n in names}, results["ptxas"],
        "phot_pk")
    results["pack_src_pairs"] = pairs_entry(
        {n: results["cases"][n]["packed"] for n in names}, results["ptxas"])


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
    names = ("geom_C9_parity0", "geom_C5_parity1")
    results["rect_ncc_geom"] = rect_entry(results, names, "ncc")
    results["rect_ncc_geom"]["ptxas"] = ptxas_of(results["ptxas"], "geom")
    results["rect_ncc_geom_pk"] = packed_entry(
        {n: results["cases"][n]["packed"] for n in names}, results["ptxas"],
        "geom_pk")
    results["pack_src_pairs"]["geom_cases"] = {
        n: results["cases"][n]["packed"]["pairs"] for n in names}


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
    case["packed"] = check_packed_case(f"sphere {name}", rargs, sd,
                                       case["bound"])
    log(f"sphere {name}: {case}")
    return case


def run_sphere_phase(dev, results):
    """Phase 10: the sphere passes at 1024x512x6src; returns their numbers,
    the photometric and geometric paths under ``phot`` and ``geom``, and
    the problem (inputs, geometric inputs with the packed passes' source
    depths, the f32 parameters, ground truth) for phase 17."""
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
        results[k + "_pk"]["sphere_cases"] = {
            nm: cases[nm]["packed"] for nm in names}
    results["pack_src_pairs"]["sphere_cases"] = {
        nm: c["packed"]["pairs"] for nm, c in cases.items()}

    # the same passes with both bf16 packs on (the defaults), beside the
    # f32 ones: the packed chain (seeds and source depths from packed
    # passes, keys as above)
    pk_params = dataclasses.replace(params, rect_tap_pack=True,
                                    rect_backmap_pack=True)
    pres, pphot = drive_checked(
        "sphere photometric packed", ("rect_ncc_pk", "pack_src_pairs"),
        lambda r: run_patchmatch(inputs, pk_params, r))
    pd = pres[0].cpu().numpy()
    if not np_finite(pd) or pphot["launches"]["rect_ncc"]:
        raise AssertionError("packed sphere pass: depth not finite, or the "
                             "f32 kernel launched")
    pphot["errors"] = sphere_band_errors(pd, gt[0], inputs.ref_cam)
    pphot["pass_ms"] = 1e3 * sum(pphot["pass_s"]) / len(pphot["pass_s"])
    pg_inputs = dataclasses.replace(inputs, src_depths=source_depths(
        inputs, pk_params, key_base=2000))
    pseeds = dict(seed_normal_world=pres[1], seed_depth=pres[0])
    pg_params = pk_params.with_geom(multi_geometry=False)
    pgres, pgeom = drive_checked(
        "sphere geometric packed", ("rect_ncc_geom_pk", "pack_src_pairs"),
        lambda r: run_patchmatch(pg_inputs, pg_params, 50 + r, **pseeds))
    pgd = pgres[0].cpu().numpy()
    if not np_finite(pgd) or pgeom["launches"]["rect_ncc_geom"]:
        raise AssertionError("packed sphere geometric pass: depth not "
                             "finite, or the f32 kernel launched")
    pgeom["errors"] = sphere_band_errors(pgd, gt[0], inputs.ref_cam)
    pgeom["pass_ms"] = 1e3 * sum(pgeom["pass_s"]) / len(pgeom["pass_s"])
    log(f"sphere packed: photometric {pphot}; geometric {pgeom} (f32: "
        f"{phot['errors']}, {geom['errors']})")
    for nm, e in (("photometric", pphot), ("geometric", pgeom)):
        if not e["errors"]["band"] < SPHERE_BAND_ERR_MAX:
            raise AssertionError(f"packed sphere {nm} band error "
                                 f"{e['errors']} >= {SPHERE_BAND_ERR_MAX}")
    out.update(cases=cases, phot=phot, geom=geom, phot_pk=pphot,
               geom_pk=pgeom)
    return out, (inputs, pg_inputs, params, gt)


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
    counters zeroed just before and read just after; returns the last
    run's output and the numbers."""
    import torch

    from acmmp_spherical_torch.ops.kernels import _lib

    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(0)
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
    opens and closes, as a ``prior_build`` scope closes (the prior round
    follows) and as a ``write`` scope closes (a serial problem, or a
    batched chunk, is done: the next one starts with its main round), and
    sorts the launches by pass and round (``main``; ``prior``).  ``check``
    holds the first launch of each kernel at each set of operand shapes in
    each (pass, round, slot) against the kernel's plain version (slot None
    in a serial run; several slots may check at once, one at a time); its
    own time is left out of every scope and its peak memory out of
    ``peak``."""

    def __init__(self):
        import threading

        from acmmp_spherical_torch.utils.log import Timings

        self.timings = Timings(hook=self)
        self.by_round: dict = {}      # (pass, round) -> {kernel: launches}
        self.prior_rounds: dict = {}  # pass -> rounds that launched
        self.checks: dict = {}        # (pass, round, slot, kernel, shapes)
        self.failures: list = []
        self.peak = 0
        self._pass = self._round = None
        self._snap: dict = {}
        self._lock = threading.Lock()

    def _close_round(self):
        """Add the launches since the last reading to the current (pass,
        round); returns them."""
        from acmmp_spherical_torch.ops.kernels import _lib

        now = dict(_lib.LAUNCHES)
        delta = {k: v - self._snap[k] for k, v in now.items()}
        acc = self.by_round.setdefault((self._pass, self._round),
                                       dict.fromkeys(_lib.LAUNCHES, 0))
        for k, v in delta.items():
            acc[k] += v
        self._snap = now
        return delta

    def __call__(self, name: str, entering: bool) -> None:
        import re

        from acmmp_spherical_torch.ops.kernels import _lib

        is_pass = re.fullmatch(PASS_SCOPE, name) is not None
        if entering:
            if is_pass:
                self._pass, self._round = name, "main"
                self._snap = dict(_lib.LAUNCHES)
        elif self._pass is None:
            return
        elif name == "prior_build":
            self._close_round()
            self._round = "prior"
        elif name == "write" or is_pass:
            round_ = self._round
            delta = self._close_round()
            launched = (delta["rect_ncc"] or delta["rect_ncc_pk"]
                        or delta["ncc_window"])
            if round_ == "prior" and launched:
                self.prior_rounds[self._pass] = (
                    self.prior_rounds.get(self._pass, 0) + 1)
            self._round = "main"
            if is_pass:
                self._pass = self._round = None

    def check(self, kernel, shapes, out, plain):
        import torch

        from acmmp_spherical_torch.parallel.mesh import current_slot

        key = (self._pass, self._round, current_slot(), kernel, shapes)
        with self._lock:
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
                    f"{kernel} in {self._pass} ({self._round} round, slot "
                    f"{key[2]}), operands {shapes}: not bit-identical to "
                    f"the plain version, max err {err}")
                raise AssertionError(self.failures[-1])


def _rect_launch_key(params, with_geom: bool) -> str:
    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR

    return NR.launch_key(params, with_geom)


# the kernel each checked wrapper launches, from its bound arguments (a
# build of rect_ncc by its key: the 9-tap one under "_t9")
KERNEL_OF = {
    "coefficient_transport": lambda a: "warp_transport",
    "rect_ncc": lambda a: _rect_launch_key(a["params"],
                                           a.get("sdisp") is not None),
    "pack_src_pairs": lambda a: "pack_src_pairs",
    "warp_src_frames": lambda a: "warp_src_frames",
    "warp_src_disparities": lambda a: "warp_src_disparities",
    "ncc_window": lambda a: ("ncc_window" if a.get("dep") is None
                             else "ncc_window_geom"),
}


@contextlib.contextmanager
def checked_kernels(scopes):
    """Route the wrappers of kernels 1-6 and of ``pack_src_pairs`` through
    ``scopes.check``: the wrapper runs (and counts its launch) as always,
    then its plain version runs on the same operands, uncounted."""
    import inspect

    import torch

    from acmmp_spherical_torch.ops import sphere_rect as SR
    from acmmp_spherical_torch.ops.kernels import _lib
    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR
    from acmmp_spherical_torch.ops.kernels import ncc_window as NW
    from acmmp_spherical_torch.ops.kernels import warp_image as WI

    def checked(name, fn, plain):
        sig = inspect.signature(plain)   # the wrapper's parameters

        def call(*args, **kw):
            kernel = KERNEL_OF[name](sig.bind(*args, **kw).arguments)
            before = _lib.LAUNCHES[kernel]
            out = fn(*args, **kw)
            if _lib.LAUNCHES[kernel] <= before:
                raise AssertionError(f"{name} did not launch {kernel}")
            shapes = tuple(tuple(a.shape) for a in (*args, *kw.values())
                           if torch.is_tensor(a))
            scopes.check(kernel, shapes, out, lambda: plain(*args, **kw))
            return out
        return call

    swaps = [(NR, "coefficient_transport", NR.coefficient_transport_plain),
             (NR, "rect_ncc", NR.rect_ncc_plain),
             (SR, "rect_ncc", NR.rect_ncc_plain),
             (NR, "pack_src_pairs", NR.pack_src_pairs_plain),
             (WI, "warp_src_frames", WI.warp_src_frames_plain),
             (WI, "warp_src_disparities", WI.warp_src_disparities_plain),
             (NW, "ncc_window", NW.ncc_window_plain)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, checked(name, getattr(mod, name), plain))
    try:
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


def drive_checked(name, kernels, fn, reps: int = 3):
    """``drive`` inside ``checked_kernels``: the first launch of each kernel
    at each set of operand shapes (in the warm run) is held bit for bit
    against its plain version, and every kernel the path launched must have
    been checked.  The run's numbers gain ``plain_checks``: per kernel, the
    shapes checked and the largest difference."""
    scopes = LaunchScopes()
    with checked_kernels(scopes):
        out, run = drive(name, kernels, fn, reps)
    if scopes.failures:
        raise AssertionError("; ".join(scopes.failures))
    checks: dict = {}
    for (_, _, _, k, _), err in scopes.checks.items():
        c = checks.setdefault(k, dict(shapes=0, max_abs_err=0.0))
        c["shapes"] += 1
        c["max_abs_err"] = max(c["max_abs_err"], err)
    unchecked = [k for k, v in run["launches"].items()
                 if v and k not in checks]
    if unchecked:
        raise AssertionError(f"{name}: {unchecked} launched but never held "
                             "against the plain version")
    run["plain_checks"] = checks
    log(f"{name}: first-launch checks {checks}, all bit-identical")
    return out, run


@contextlib.contextmanager
def serial_passes_disabled():
    """Make the serial ``process_problem`` raise, so a batched run that
    fell back to it fails."""
    from acmmp_spherical_torch.pipeline import multiscale

    def no_serial(*args, **kw):
        raise AssertionError("a batched pass fell back to process_problem")

    kept = multiscale.process_problem
    multiscale.process_problem = no_serial
    try:
        yield
    finally:
        multiscale.process_problem = kept


def write_pipeline_scene(sc, root):
    """Render the CubeRoom ring ``sc`` and write it to ``root`` in the
    on-disk layout; returns (ground-truth depths, seconds)."""
    from acmmp_spherical_torch.utils.synthetic import (
        CubeRoom, make_ring_of_cameras, render_scene,
        write_synthetic_scene_to_disk,
    )

    t0 = time.perf_counter()
    cams = make_ring_of_cameras(sc["n_views"], **sc["cameras"],
                                width=sc["width"], height=sc["height"],
                                device="cpu")
    images, gt, _ = render_scene(cams, CubeRoom(), sc["width"], sc["height"])
    write_synthetic_scene_to_disk(root, cams, images)
    return gt, time.perf_counter() - t0


def scene_copy(work, sc, name):
    """A fresh copy of the phase's input scene under ``work``."""
    import shutil

    root = work / f"{sc['label']}_{name}"
    shutil.copytree(work / f"{sc['label']}_input", root)
    return root


def outputs_differ(a, b, *, manifest_as_sets=False) -> list:
    """The files under ``a/ACMMP`` and ``b/ACMMP`` that differ (or exist in
    one only); the manifest compared as sets of entries per pass when
    ``manifest_as_sets``."""
    import filecmp

    fa = {p.relative_to(a) for p in (a / "ACMMP").rglob("*") if p.is_file()}
    fb = {p.relative_to(b) for p in (b / "ACMMP").rglob("*") if p.is_file()}
    differ = sorted(str(f) for f in fa ^ fb)
    for f in sorted(fa & fb):
        if manifest_as_sets and f.name == "manifest.json":
            ma, mb = (json.loads((r / f).read_text()) for r in (a, b))
            if {k: sorted(v) for k, v in ma.items()} != {
                    k: sorted(v) for k, v in mb.items()}:
                differ.append(str(f))
        elif not filecmp.cmp(a / f, b / f, shallow=False):
            differ.append(str(f))
    return differ


def run_pipeline_phase(dev, sc, work, gt, name, *, mesh=None, checked=True,
                       patchmatch=None):
    """Phase 9 (pinhole), 11 (SPHERE), 12 (batched over ``mesh``) or 17
    (``patchmatch``: the passes' parameters in place of the defaults'):
    ``run_pipeline`` on a fresh copy ``name`` of the ring ``sc`` under
    ``work``; returns its numbers, with its folder under ``root``, the
    launch counts of the run under ``launches`` and each view's error
    before the geometric passes of the last scale (its ``depths.dmb``, the
    hierarchy pass's) under ``hier_median_rel_depth_err``.  ``checked``:
    hold the first launch of each kernel at each operand shape against its
    plain version (the checks' time is left out of ``wall_s``)."""
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
    from acmmp_spherical_torch.utils.synthetic import CubeRoom

    n_views = sc["n_views"]
    room = CubeRoom()
    root = scene_copy(work, sc, name)
    cfg = PipelineConfig(batch_problems="off" if mesh is None else "on")
    if patchmatch is not None:
        cfg = dataclasses.replace(cfg, patchmatch=patchmatch)
    scopes = LaunchScopes()
    timings = scopes.timings
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        if checked:
            stack.enter_context(checked_kernels(scopes))
        if mesh is not None:
            stack.enter_context(serial_passes_disabled())
        t0 = time.perf_counter()
        n_points = multiscale.run_pipeline(root, cfg, device=dev, mesh=mesh,
                                           timings=timings)
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
    errs, hier = ([depth_error_stats(read_depth_dmb(sp.depth_file(
        v, geom=geom)), gt[v], border=sc["err_border"])["median_rel_err"]
        for v in range(n_views)] for geom in (True, False))
    pts = read_ply(sp.ply_file())[0]
    on_surface = float(np.mean(cube_surface_distance(pts, room.half)
                               < sc["tau"])) if len(pts) else 0.0
    by_round = {f"{p} {r}": {k: v for k, v in acc.items() if v}
                for (p, r), acc in scopes.by_round.items()}
    checks = {}
    for (p, r, slot, k, _), err in scopes.checks.items():
        c = checks.setdefault(f"{p} {r} {k}", dict(shapes=0, max_abs_err=0.0,
                                                   slots=[]))
        c["shapes"] += 1
        c["max_abs_err"] = max(c["max_abs_err"], err)
        if slot not in c["slots"]:
            c["slots"].append(slot)
    out = dict(root=str(root), wall_s=wall_s, timings_s=timings.totals,
               timing_counts=timings.counts, peak_mem_bytes=peak,
               manifest_entries=entries, median_rel_depth_err=errs,
               hier_median_rel_depth_err=hier,
               fused_points=n_points, on_surface=on_surface,
               launches=launches, launches_by_round=by_round,
               prior_rounds=scopes.prior_rounds, plain_checks=checks,
               plain_check_s=timings.excluded_s)
    log(f"pipeline {sc['label']} {name} {sc['width']}x{sc['height']}x"
        f"{n_views} views: {json.dumps(out)}")
    if entries != len(expected) * n_views:
        raise AssertionError(f"pipeline manifest holds {entries} of "
                             f"{len(expected) * n_views} (pass, view) "
                             f"entries: {manifest}")
    if mesh is None:
        ran = {k: timings.counts.get(k, 0) for k in expected}
        if any(n != n_views for n in ran.values()):
            raise AssertionError(f"pass scopes per pass: {ran}; every view "
                                 "must run every pass once, with no retry")
        prior = {k: scopes.prior_rounds.get(k, 0) for k in expected[::3]}
        if any(n != n_views for n in prior.values()):
            raise AssertionError(f"prior rounds that launched a kernel: "
                                 f"{prior}; every view's "
                                 f"{' and '.join(prior)} pass must run its "
                                 "planar-prior round")
    for k in sc["kernels"]:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "pipeline")
    for k in F32_RECT_KERNELS:
        if launches[k]:
            raise AssertionError(f"the f32 kernel {k} launched in a pipeline "
                                 "at the defaults (both bf16 packs on)")
    if checked:
        unchecked = [f"{p} {r} {k}" for (p, r), acc in scopes.by_round.items()
                     for k, v in acc.items() if v and k != "window_sample"
                     and f"{p} {r} {k}" not in checks]
        if unchecked:
            raise AssertionError("kernels launched in the pipeline without a "
                                 f"check against their plain version: "
                                 f"{unchecked}")
    log(f"pipeline {sc['label']} {name} gates: median rel depth err per view "
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


def run_batched_phase(dev, sc, work, gt, serial):
    """Phase 12: the phase-9 scene through ``run_pipeline`` with
    ``batch_problems="on"`` over ``BATCH_SLOTS`` slots of the one card and
    the serial ``process_problem`` made to raise: once with every slot's
    first launches checked, once timed; each run's files must equal phase
    9's byte for byte and its launches per pass and round phase 9's.  Then
    ``fuse_all_views_sharded`` over the slots on phase 9's results, and
    ``multichip_step`` on a synthetic batch over the slots, its launches
    counted and checked, against one slot."""
    import shutil

    import numpy as np
    import torch

    from acmmp_spherical_torch.config import PipelineConfig
    from acmmp_spherical_torch.io.scene import ScenePaths, read_pair_file
    from acmmp_spherical_torch.ops import rng as R
    from acmmp_spherical_torch.ops.fusion import fuse_all_views
    from acmmp_spherical_torch.ops.kernels import _lib
    from acmmp_spherical_torch.parallel import (
        make_view_mesh, multichip_step, shard_batch_over_views,
    )
    from acmmp_spherical_torch.parallel.fusion import fuse_all_views_sharded
    from acmmp_spherical_torch.parallel.synthetic_batch import (
        make_synthetic_batch,
    )
    from acmmp_spherical_torch.pipeline.multiscale import fusion_inputs

    mesh = make_view_mesh(devices=[dev] * BATCH_SLOTS)
    out = {}
    for name, checked in (("batched_checked", True), ("batched", False)):
        run = run_pipeline_phase(dev, sc, work, gt, name, mesh=mesh,
                                 checked=checked)
        differ = outputs_differ(pathlib.Path(serial["root"]),
                                pathlib.Path(run["root"]))
        if checked:
            shutil.rmtree(run["root"])
        if differ:
            raise AssertionError(f"phase 12 ({name}): files differ from "
                                 f"phase 9's: {differ}")
        if run["launches_by_round"] != serial["launches_by_round"]:
            raise AssertionError(
                f"phase 12 ({name}): launches per pass and round "
                f"{run['launches_by_round']}, phase 9 "
                f"{serial['launches_by_round']}")
        if checked:
            slots = {s for c in run["plain_checks"].values()
                     for s in c["slots"]}
            if slots != set(range(BATCH_SLOTS)):
                raise AssertionError(f"phase 12 checked slots {slots}")
        out[name] = run
    timed = out["batched"]
    load = timed["timings_s"].get("load", 0.0)
    wait = timed["timings_s"].get("load_wait", 0.0)
    log(f"phase 12: run_pipeline {timed['wall_s']:.2f} s over {BATCH_SLOTS} "
        f"slots against {serial['wall_s']:.2f} s serial (phase 9); loads "
        f"{load:.2f} s on the loader thread, {wait:.2f} s of it waited for "
        f"(overlap {load - wait:.2f} s); peak {timed['peak_mem_bytes']} "
        f"bytes (phase 9 {serial['peak_mem_bytes']}); files and launches "
        "equal phase 9's")

    # sharded fusion on phase 9's results
    sp = ScenePaths(serial["root"])
    inputs = fusion_inputs(sp, read_pair_file(sp.pair_file), PipelineConfig(),
                           device=dev)
    t0 = time.perf_counter()
    ref = fuse_all_views(*inputs, PipelineConfig().fusion)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = fuse_all_views_sharded(mesh, *inputs, PipelineConfig().fusion)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    if not (len(ref[0]) == serial["fused_points"]
            and all(np.array_equal(a, b) for a, b in zip(got, ref))):
        raise AssertionError(f"sharded fusion: {len(got[0])} points, serial "
                             f"{len(ref[0])}, phase 9 "
                             f"{serial['fused_points']}")
    del inputs, ref, got

    # the view-parallel step over the slots: once with its launches counted
    # and each slot's first launch at each operand shape held against the
    # plain version, then timed over the slots and over one slot
    mc = MULTICHIP_BATCH
    batch, params, mgt = make_synthetic_batch(
        mc["n"], width=mc["width"], height=mc["height"], n_src=mc["n_src"],
        focal=mc["focal"], device=dev)
    # the windowed path (kernel 6, from every slot): the exact path's
    # per-tap launches take minutes under three threads
    params = dataclasses.replace(params, fast_ncc=True)
    scopes = LaunchScopes()
    shards = shard_batch_over_views(mesh, batch)
    _lib.reset_launch_counts()
    with checked_kernels(scopes):
        checked_res = multichip_step(mesh, params)(shards, R.key(0))
    torch.cuda.synchronize()
    step_launches = dict(_lib.LAUNCHES)
    if scopes.failures:
        raise AssertionError("; ".join(scopes.failures))
    step_checks = {}
    for (_, _, slot, k, _), err in scopes.checks.items():
        c = step_checks.setdefault(k, dict(shapes=0, max_abs_err=0.0,
                                           slots=[]))
        c["shapes"] += 1
        c["max_abs_err"] = max(c["max_abs_err"], err)
        if slot not in c["slots"]:
            c["slots"].append(slot)
    launched = sorted(k for k, v in step_launches.items() if v)
    if (launched != ["ncc_window", "ncc_window_geom"]
            or any(sorted(step_checks[k]["slots"]) != list(range(BATCH_SLOTS))
                   for k in launched)):
        raise AssertionError(f"multichip_step launched {step_launches}, "
                             f"checked {step_checks}: each of ncc_window "
                             "and ncc_window_geom must launch and be "
                             "checked in every slot")
    steps = {}
    for n in (BATCH_SLOTS, 1):
        m = make_view_mesh(devices=[dev] * n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = multichip_step(m, params)(shard_batch_over_views(m, batch),
                                        R.key(0))
        steps[n] = ([torch.cat(a) for a in zip(*res)],
                    time.perf_counter() - t0)
    checked_out = [torch.cat(a) for a in zip(*checked_res)]
    same = all(_same(a, b) and _same(a, c) for a, b, c in zip(
        steps[BATCH_SLOTS][0], steps[1][0], checked_out))
    d = steps[BATCH_SLOTS][0][0].cpu().numpy()
    mrel = float(np.median(np.abs(d - mgt) / mgt))
    log(f"phase 12: sharded fusion {serial['fused_points']} "
        f"points equal to fuse_all_views ({sharded_s:.2f} s against "
        f"{fuse_s:.2f} s); multichip_step on {mc['n']} problems "
        f"{mc['width']}x{mc['height']}: launches {step_launches}, "
        f"{sum(c['shapes'] for c in step_checks.values())} first-launch "
        f"checks over {BATCH_SLOTS} slots bit-identical; {BATCH_SLOTS} slots "
        f"{steps[BATCH_SLOTS][1]:.2f} s, 1 slot {steps[1][1]:.2f} s, "
        f"bit-identical {same}, median rel depth err {mrel}")
    if not same or not np.isfinite(d).all() or not mrel < 0.2:
        raise AssertionError("multichip_step over the slots differs from "
                             "one slot, or its depth is off")
    out.update(fusion_s=fuse_s, sharded_fusion_s=sharded_s,
               multichip=dict(launches=step_launches,
                              plain_checks=step_checks),
               multichip_s={str(k): v[1] for k, v in steps.items()},
               multichip_median_rel_err=mrel, load_s=load, load_wait_s=wait)
    return out


def occlusion_band(gt):
    """Pixels within 3 px of a ground-truth depth step > 5% of the depth
    (tests/test_discontinuity.py)."""
    import numpy as np

    band = np.maximum(np.abs(np.diff(gt, axis=0, prepend=gt[:1])),
                      np.abs(np.diff(gt, axis=1, prepend=gt[:, :1]))
                      ) > 0.05 * gt
    for _ in range(3):
        band[1:] |= band[:-1]
        band[:-1] |= band[1:]
        band[:, 1:] |= band[:, :-1]
        band[:, :-1] |= band[:, 1:]
    return band


def run_discontinuity_phase(dev):
    """Phase 14: tests/test_discontinuity.py on the card.  An OccludedRoom
    ring of 4 views at 96x64 (focal 80, key 3) through the exact, windowed
    and rectified paths at the defaults of ``PatchMatchParams`` (both bf16
    packs on), and the rectified path with ``rect_prescreen`` (its 9-tap
    build must launch), each run once with the launch counters zeroed just
    before and read just after and its kernels' first launches checked
    (``drive_checked``).  Median relative depth error over [6:-6, 6:-6] <
    0.02, and < 0.06 in the band within 3 px of a depth step."""
    import numpy as np
    import torch

    from acmmp_spherical_torch.config import PatchMatchParams
    from acmmp_spherical_torch.core.camera import stack_cameras
    from acmmp_spherical_torch.ops.propagate import PatchMatchInputs
    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch
    from acmmp_spherical_torch.utils.synthetic import (
        OccludedRoom, make_ring_of_cameras, render_scene,
    )

    dc = DISCONTINUITY
    W, H, n = dc["width"], dc["height"], dc["n_views"]
    cams = make_ring_of_cameras(n, width=W, height=H, focal=dc["focal"],
                                device=dev)
    images, depths, _ = render_scene(cams, OccludedRoom(), W, H)
    gt = depths[0]
    band = occlusion_band(gt)
    imgs = torch.as_tensor(images, device=dev)
    inputs = PatchMatchInputs(
        ref_image=imgs[0], src_images=imgs[1:], ref_cam=cams[0],
        src_cams=stack_cameras(cams[1:]),
        src_valid=torch.ones(n - 1, dtype=torch.bool, device=dev),
        depth_range=cams[0].depth_range)
    inner = np.s_[6:-6, 6:-6]
    out = dict(band_fraction=float(band.mean()), paths={}, errors={})
    for path, fast, rect, prescreen, kernels in (
            ("exact", False, False, False, ()),
            ("window", True, False, False, ("ncc_window",)),
            ("rect", True, True, False, PK_PHOT_KERNELS),
            ("rect prescreen", True, True, True,
             PK_PHOT_KERNELS + ("rect_ncc_pk_t9",))):
        params = dataclasses.replace(PatchMatchParams(), fast_ncc=fast,
                                     rect_ncc=rect, rect_init=rect,
                                     rect_prescreen=prescreen)
        res, run = drive_checked(
            f"discontinuity {path}", kernels,
            lambda r: run_patchmatch(inputs, params, dc["key"]), reps=0)
        d = res[0].cpu().numpy()
        if not np_finite(d) or d.shape != gt.shape:
            raise AssertionError(f"discontinuity {path}: depth not finite")
        rel = np.abs(d - gt) / gt
        out["paths"][path] = run
        out["errors"][path] = dict(
            median=float(np.median(rel[inner])),
            band=float(np.median(rel[inner][band[inner]])))
    log(f"phase 14: discontinuity golden, band {out['band_fraction']:.4f} "
        f"of the frame; errors {out['errors']} (gates {dc['err_max']} / "
        f"{dc['band_err_max']}); launches "
        f"{ {k: v['launches'] for k, v in out['paths'].items()} }")
    for path in ("rect", "rect prescreen"):
        if any(out["paths"][path]["launches"][k] for k in F32_RECT_KERNELS):
            raise AssertionError(f"the discontinuity golden's {path} path "
                                 "launched an f32 rect kernel")
    for path, e in out["errors"].items():
        if not (e["median"] < dc["err_max"]
                and e["band"] < dc["band_err_max"]):
            raise AssertionError(f"discontinuity {path}: {e}")
    return out


def run_hostile_phase(dev):
    """Phase 15: ``render_scene_hostile`` (seed 0: specular lobe, exposure,
    noise, JPEG q75) of an OccludedRoom on the 1024x768x8src bench ring:
    one photometric rectified pass (key 1, after a warm key-0 pass) with
    both bf16 packs off and one with both on, the launch counters zeroed
    just before and read just after each and the warm pass's first launches
    checked (``drive_checked``).  Median relative depth error and
    the share of pixels within 1% over [8:-8, 8:-8].  First numbers at this
    size, with no reference value: gated only on finite depth."""
    import numpy as np

    from acmmp_spherical_torch.bench import BENCH_SCENE, make_problem
    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch
    from acmmp_spherical_torch.utils.synthetic import (
        OccludedRoom, render_scene_hostile,
    )

    t0 = time.perf_counter()
    inputs, params, gt, _ = make_problem(**BENCH_SCENE, device=dev,
                                         scene=OccludedRoom(),
                                         render=render_scene_hostile)
    out = dict(scene_s=time.perf_counter() - t0, paths={}, errors={})
    g = gt[0][8:-8, 8:-8]
    for tag, packs, kernels in (("f32", False, PHOT_KERNELS),
                                ("packed", True, PK_PHOT_KERNELS)):
        p = dataclasses.replace(params, rect_tap_pack=packs,
                                rect_backmap_pack=packs)
        res, run = drive_checked(f"hostile photometric {tag}", kernels,
                                 lambda r: run_patchmatch(inputs, p, r),
                                 reps=1)
        d = res[0].cpu().numpy()
        if not np_finite(d) or d.shape != gt[0].shape:
            raise AssertionError(f"hostile pass ({tag}): depth not finite")
        rel = np.abs(d[8:-8, 8:-8] - g) / g
        run["pass_ms"] = 1e3 * run["pass_s"][0]
        out["paths"][tag] = run
        out["errors"][tag] = dict(median_rel_err=float(np.median(rel)),
                                  within_1pct=float(np.mean(rel < 0.01)))
    log(f"phase 15: hostile bench pass {out['errors']}; pass ms "
        f"{ {k: v['pass_ms'] for k, v in out['paths'].items()} }")
    return out


def exact_params(params):
    """``params`` on the exact path, as tile-shard mode forces it
    (pass_runner.process_problem(tile_mesh=)), at ``TILE_ITERATIONS``."""
    return dataclasses.replace(params, rect_ncc=False, fast_ncc=False,
                               rect_init=False, rect_comp_hw=None,
                               rect_live_n=None, rect_warp_hw=None,
                               max_iterations=TILE_ITERATIONS)


def tile_case(dev, name, fn, errors):
    """One pass kind of phase 16: ``fn(shard_state)`` once warm on one
    slot, then timed on one slot (the ordinary pass) and tiled over
    ``TILE_SLOTS`` slots of the card, the card's peak memory reset before
    each; every tiled output must equal the one-slot one bit for bit
    (depth, normal, cost), else the share of identical pixels is printed
    and ``TILE_RTOL``/``TILE_ATOL`` holds.  ``errors(out)``: the pass's
    depth errors.  Returns the numbers and the one-slot output."""
    import numpy as np
    import torch

    from acmmp_spherical_torch.parallel import (
        make_state_sharder, make_tile_mesh,
    )

    runs, ref = {}, None
    t0 = time.perf_counter()
    fn(None)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for n in (1,) + TILE_SLOTS:
        sharder = (None if n == 1 else
                   make_state_sharder(make_tile_mesh(n, devices=[dev])))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(sharder)
        torch.cuda.synchronize()
        run = dict(pass_s=time.perf_counter() - t0,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   errors=errors(out))
        if n == 1:
            run["warm_s"] = warm_s
        if n == 1:
            ref = out[:3]
        else:
            same = _same(tuple(out[:3]), tuple(ref))
            pix = ((out[0] == ref[0]) & (out[1] == ref[1]).all(-1)
                   & (out[2] == ref[2]))
            run.update(bit_identical=same,
                       identical_pixels=float(pix.float().mean()))
            if not same:
                log(f"phase 16 {name} over {n} slots: not bit-identical to "
                    f"one slot, {run['identical_pixels']} of the pixels "
                    f"identical, max err {_max_err(tuple(out[:3]), ref)}")
                for a, b in zip(out[:3], ref):
                    np.testing.assert_allclose(a.cpu().numpy(),
                                               b.cpu().numpy(),
                                               rtol=TILE_RTOL, atol=TILE_ATOL)
        runs[n] = run
        del out
    log(f"phase 16 {name}: {json.dumps(runs)}")
    return runs, ref


TILE_RUN_SCRIPT = """
import json, runpy
from acmmp_spherical_torch.ops.kernels import _lib
try:
    runpy.run_module("acmmp_spherical_torch", run_name="__main__",
                     alter_sys=True)
finally:
    print("LAUNCHES " + json.dumps(_lib.LAUNCHES), flush=True)
"""


def run_tile_pipeline(dev, work):
    """The tiled pipeline of phase 16: ``python -m acmmp_spherical_torch
    reconstruct <scene> --tile-shard 2`` (through ``TILE_RUN_SCRIPT``,
    which prints its launch counts as it exits) on a copy of the
    ``TILE_PIPELINE_SCENE`` ring, both without the planar-prior round,
    against ``run_pipeline`` of another copy
    on the exact path, one problem after the other, in this process while
    the tiled run's process runs (both are bound by their hosts' launches;
    their wall times overlap).  The tiled run must
    exit 0 with its passes on the exact path over 2 slots and launch no
    kernel (the serial run neither); its ``.dmb`` files must equal the
    serial run's byte for byte (else view by view its final depth within
    tests/test_parallel.py:150-152's bounds), its manifest hold the same
    entries and its fused cloud within 2% of the serial run's points."""
    import re

    import numpy as np
    import torch

    from acmmp_spherical_torch.config import PipelineConfig
    from acmmp_spherical_torch.io import read_depth_dmb
    from acmmp_spherical_torch.io.scene import ScenePaths
    from acmmp_spherical_torch.ops.kernels import _lib
    from acmmp_spherical_torch.pipeline import multiscale
    from acmmp_spherical_torch.utils.metrics import depth_error_stats

    sc = TILE_PIPELINE_SCENE
    gt, scene_s = write_pipeline_scene(sc, work / f"{sc['label']}_input")
    serial_root = scene_copy(work, sc, "serial")
    tiled_root = scene_copy(work, sc, "tiled")
    cfg = PipelineConfig(fast_ncc="off", rect_ncc="off",
                         batch_problems="off", planar_prior=False)
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", TILE_RUN_SCRIPT, "reconstruct",
         str(tiled_root), "--tile-shard", "2", "--no-prior"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        n_serial = multiscale.run_pipeline(serial_root, cfg, device=dev)
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0
        serial_launches = dict(_lib.LAUNCHES)
        o = proc.communicate(timeout=900)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    tiled_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 16: reconstruct --tile-shard 2 exited "
                             f"{proc.returncode}: {o[-3000:]}")
    launches = json.loads(re.findall(r"^LAUNCHES (.*)$", o, re.M)[-1])
    paths = re.findall(r"pass image=\d+ .* path=(\w+)", o)
    n_tiled = int(re.findall(r"fusion wrote (\d+) points", o)[-1])
    if ("tile-parallel passes: width tiles over 2 slots" not in o
            or not paths or set(paths) != {"exact"}):
        raise AssertionError(f"phase 16: the tiled run's passes ran on "
                             f"{sorted(set(paths))}, not tiled on the exact "
                             "path over 2 slots")
    if any(launches.values()) or any(serial_launches.values()):
        raise AssertionError(f"phase 16: the pipelines launched kernels: "
                             f"tiled {launches}, serial {serial_launches}")
    differ = outputs_differ(serial_root, tiled_root, manifest_as_sets=True)
    if any(f.endswith("manifest.json") for f in differ):
        raise AssertionError("phase 16: the manifests differ")
    dmb_differ = [f for f in differ if f.endswith(".dmb")]
    sp_s, sp_t = ScenePaths(serial_root), ScenePaths(tiled_root)
    bounds = []
    for v in range(sc["n_views"]):
        a = read_depth_dmb(sp_t.depth_file(v, geom=True))
        b = read_depth_dmb(sp_s.depth_file(v, geom=True))
        rel = np.abs(a - b) / np.maximum(b, 1e-6)
        bounds.append((float(np.median(rel)), float(np.mean(rel < 1e-3))))
    errs = [depth_error_stats(read_depth_dmb(sp_t.depth_file(v, geom=True)),
                              gt[v])["median_rel_err"]
            for v in range(sc["n_views"])]
    out = dict(scene_s=scene_s, serial_s=serial_s, tiled_s=tiled_s,
               serial_points=n_serial, tiled_points=n_tiled,
               files_differ=differ, dmb_bytes_equal=not dmb_differ,
               depth_bounds=bounds, median_rel_depth_err=errs,
               passes=len(paths), launches=launches,
               serial_launches=serial_launches)
    log(f"phase 16 pipeline {sc['width']}x{sc['height']}x{sc['n_views']} "
        f"views: {json.dumps(out)}")
    if dmb_differ and not all(m < 1e-5 and f > 0.99 for m, f in bounds):
        raise AssertionError(f"phase 16: tiled depths outside the bounds: "
                             f"{bounds}")
    if not (n_serial > 0 and abs(n_tiled - n_serial) <= 0.02 * n_serial):
        raise AssertionError(f"phase 16: {n_tiled} fused points tiled, "
                             f"{n_serial} serial")
    return out


def run_tile_phase(dev, inputs, params, gt, geom_inputs):
    """Phase 16: the tile-parallel path on the card.  Exact passes at full
    width and ``TILE_ITERATIONS`` iterations, each on one slot and tiled
    over 2 and 3 slots of the card
    (``tile_case``): the photometric bench pass (1024x768x8src), the
    geometric pass seeded from its one-slot output with phase 4's source
    depths, and the SPHERE photometric pass at 1024x512x6src (its ring
    halo crosses the seam), with the launch counters zeroed just before and
    read just after (every count must be 0: no TPU kernel lies on this
    path); then the tiled pipeline (``run_tile_pipeline``)."""
    import torch

    from acmmp_spherical_torch.bench import (
        SPHERE_BENCH_SCENE, make_sphere_problem, sphere_band_errors,
    )
    from acmmp_spherical_torch.ops.kernels import _lib
    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch

    ex = exact_params(params)
    pin_err = lambda o: dict(median_rel_err=median_rel_err(o[0], gt[0]))
    _lib.reset_launch_counts()
    out = dict(passes={})
    out["passes"]["photometric"], phot = tile_case(
        dev, "photometric 1024x768x8src", lambda sh: run_patchmatch(
            inputs, ex, 16, shard_state=sh), pin_err)
    seeds = dict(seed_normal_world=phot[1], seed_depth=phot[0])
    gp = dataclasses.replace(ex.with_geom(multi_geometry=False),
                             max_iterations=TILE_ITERATIONS)
    out["passes"]["geometric"], _ = tile_case(
        dev, "geometric 1024x768x8src", lambda sh: run_patchmatch(
            geom_inputs, gp, 116, shard_state=sh, **seeds), pin_err)
    del phot, seeds
    sinputs, sparams, sgt, _ = make_sphere_problem(**SPHERE_BENCH_SCENE,
                                                   device=dev)
    sph_err = lambda o: sphere_band_errors(o[0].cpu().numpy(), sgt[0],
                                           sinputs.ref_cam)
    out["passes"]["sphere"], _ = tile_case(
        dev, "sphere photometric 1024x512x6src", lambda sh: run_patchmatch(
            sinputs, exact_params(sparams), 17, shard_state=sh), sph_err)
    out["launches"] = dict(_lib.LAUNCHES)
    if any(out["launches"].values()):
        raise AssertionError(f"phase 16 launched kernels: {out['launches']}")
    del sinputs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        out["pipeline"] = run_tile_pipeline(dev, pathlib.Path(work))
    summary = {k: {n: [r["pass_s"], r["peak_mem_bytes"],
                       r.get("bit_identical")] for n, r in v.items()}
               for k, v in out["passes"].items()}
    log(f"phase 16: pass s, peak bytes, bit-identical per slot count "
        f"{json.dumps(summary)}; launches {out['launches']}")
    return out


RANK_SCRIPT = """
import json, runpy, sys
import chip_smoke
from acmmp_spherical_torch.ops.kernels import _lib
scopes = chip_smoke.LaunchScopes()
try:
    with chip_smoke.checked_kernels(scopes):
        runpy.run_module("acmmp_spherical_torch", run_name="__main__",
                         alter_sys=True)
finally:
    print("LAUNCHES " + json.dumps(_lib.LAUNCHES), flush=True)
    checks = {}
    for (_, _, _, k, _), err in scopes.checks.items():
        c = checks.setdefault(k, dict(shapes=0, max_abs_err=0.0))
        c["shapes"] += 1
        c["max_abs_err"] = max(c["max_abs_err"], err)
    print("CHECKS " + json.dumps(dict(checks=checks,
                                      failures=scopes.failures)), flush=True)
"""


def run_distributed_phase(sc, work, serial):
    """Phase 13: ``python -m acmmp_spherical_torch reconstruct
    --distributed`` as two ranks on the one card (a gloo group on
    127.0.0.1) on a copy of the phase-11 scene, each inside
    ``checked_kernels`` (the first launch of each kernel at each operand
    shape held against its plain version); each rank prints its launch
    counts and its checks as it exits.  Both must exit 0, run the
    round-robin share of every pass, and only rank 0 may fuse; the files
    must equal phase 11's byte for byte (the manifest as sets: ranks mark
    in completion order), the two ranks' launches add up to phase 11's,
    and every kernel a rank launched must have been checked there, with no
    check failed."""
    import re
    import socket

    root = scene_copy(work, sc, "distributed")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, "reconstruct", str(root),
         "--distributed", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r)],
        cwd=ROOT, env=dict(os.environ, ACMMP_BARRIER_TIMEOUT_S="300"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    pathlib.Path(ROOT / "chiprun_out").mkdir(exist_ok=True)
    for r, o in enumerate(outs):
        (ROOT / "chiprun_out" / f"phase13_rank{r}.log").write_text(o)
    if rcs != [0, 0]:
        raise AssertionError(f"phase 13 ranks exited {rcs}: "
                             + " | ".join(o[-2000:] for o in outs))
    shares, launches, checks = [], [], {}
    for r, o in enumerate(outs):
        share = {int(m) for m in re.findall(r"pass image=(\d+)", o)}
        shares.append(sorted(share))
        if share != set(range(r, sc["n_views"], 2)):
            raise AssertionError(f"rank {r} ran views {sorted(share)}")
        launches.append(json.loads(re.findall(r"^LAUNCHES (.*)$", o,
                                              re.M)[-1]))
        ck = json.loads(re.findall(r"^CHECKS (.*)$", o, re.M)[-1])
        unchecked = [k for k, v in launches[-1].items()
                     if v and k != "window_sample" and k not in ck["checks"]]
        if ck["failures"] or unchecked:
            raise AssertionError(f"phase 13 rank {r}: check failures "
                                 f"{ck['failures']}, kernels launched but "
                                 f"never checked {unchecked}")
        for k, c in ck["checks"].items():
            t = checks.setdefault(k, dict(shapes=0, max_abs_err=0.0))
            t["shapes"] += c["shapes"]
            t["max_abs_err"] = max(t["max_abs_err"], c["max_abs_err"])
    fused = ["fusion wrote" in o for o in outs]
    if fused != [True, False]:
        raise AssertionError(f"fusion ran on ranks {fused}")
    differ = outputs_differ(pathlib.Path(serial["root"]), root,
                            manifest_as_sets=True)
    if differ:
        raise AssertionError(f"phase 13: files differ from phase 11's: "
                             f"{differ}")
    total = {k: launches[0][k] + launches[1][k] for k in launches[0]}
    if total != serial["launches"]:
        raise AssertionError(f"phase 13 launches {total}, phase 11 "
                             f"{serial['launches']}")
    out = dict(wall_s=wall_s, shares=shares, launches=total,
               rank_launches=launches, plain_checks=checks)
    log(f"phase 13: two ranks on one card {wall_s:.2f} s (processes and "
        f"first-launch checks included) against {serial['wall_s']:.2f} s "
        f"serial (phase 11); shares {shares}; files equal phase 11's; "
        f"launches {total}; first-launch checks {checks}, all "
        "bit-identical")
    return out


def prescreen_pass(name, fn, params, geom: bool):
    """One prescreened pass through ``drive_checked`` (the first launch of
    each kernel at each operand shape held against its plain version), its
    launches of kernel 1 (4 when ``geom``) at full taps and of the 9-tap
    build counted exactly: a pass that ranks through any other build fails.
    Returns the pass's output and numbers."""
    from acmmp_spherical_torch.ops.propagate import coarse_params

    full = _rect_launch_key(params, geom)
    coarse = _rect_launch_key(coarse_params(params), geom)
    if not coarse.endswith("_t9"):
        raise AssertionError(f"{name}: the coarse pattern has no 9-tap build")
    res, run = drive_checked(name, (full, coarse), fn, reps=0)
    got = dict(full=run["launches"][full], coarse=run["launches"][coarse])
    want = PRESCREEN_GEOM_LAUNCHES if geom else PRESCREEN_PHOT_LAUNCHES
    if got != want:
        raise AssertionError(f"{name}: launches of {full} / {coarse} {got}, "
                             f"expected {want}")
    return res, run


def alternate_passes(cases, traced):
    """The passes ``cases`` {label: (inputs, params, seeds)} in turn on the
    host clock: one warm pass each, then ``PRESCREEN_TIMED`` rounds of each
    in turn (keys 1, 2, ...); then one traced pass of each label in
    ``traced`` (``profile_pass.trace``: device time, idle share, device
    kernels).  Returns {label: numbers}."""
    import torch

    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch
    from acmmp_spherical_torch.profile_pass import trace

    out = {k: dict(pass_s=[]) for k in cases}
    for inputs, params, seeds in cases.values():
        run_patchmatch(inputs, params, 0, **seeds)
    torch.cuda.synchronize()
    for r in range(PRESCREEN_TIMED):
        for k, (inputs, params, seeds) in cases.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_patchmatch(inputs, params, r + 1, **seeds)
            torch.cuda.synchronize()
            out[k]["pass_s"].append(time.perf_counter() - t0)
    for k, (inputs, params, seeds) in cases.items():
        out[k]["pass_ms"] = 1e3 * sum(out[k]["pass_s"]) / PRESCREEN_TIMED
        if k in traced:
            trace(out[k], inputs, params, seeds)
    return out


def t9_cases(label, ctx, fields, params, transport):
    """The 9-tap builds of kernels 1, 1p, 4 and 4p on one context: for each
    C of ``T9_CANDIDATES``, C fields around ``fields`` (normal, w; w scaled
    by 1 + 0.005 k) on the parity-0 map, moved onto the live tiles by
    ``transport(ctx, maps, normals, ws)``.  The 9-tap build and the build
    with runtime tap bounds at the same pattern are held bit for bit
    against the plain version; CUDA-event times of the 9-tap, runtime and
    36-tap (the default pattern, same C) builds in turns 9, runtime, 36,
    36, runtime, 9 (5 calls each), the plain version's time and the bound
    of the 9-tap work.  Returns {launch key: {"<label>_C<C>": numbers}}."""
    import torch

    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR
    from acmmp_spherical_torch.ops.propagate import coarse_params

    maps = ctx.maps[1]
    n, w = fields
    out = {}
    for C in T9_CANDIDATES:
        scale = 1.0 + 0.005 * (torch.arange(C, device=w.device) - C // 2)
        nn, ww = packed(n.expand(C, *n.shape), w * scale[:, None, None], 0)
        D, AB = transport(ctx, maps, nn, ww)
        args = (ctx.srow, ctx.tile_oy, ctx.tile_ox, ctx.rect_ref,
                ctx.rect_src, D, AB, maps.fwd_valid)
        S, K8 = D.shape[1:3]
        live = int((maps.fwd_valid.reshape(S, K8 // 8, 1024).amax(-1)
                    > 0.5).sum())
        for pack in (False, True):
            for geom in (False, True):
                full = dataclasses.replace(params, rect_tap_pack=pack)
                coarse = coarse_params(full)
                r = coarse.patch_size // 2
                n_taps = len(range(-r, r + 1, coarse.radius_increment)) ** 2
                sd = dict(sdisp=ctx.rect_sdisp) if geom else {}
                kw = dict(sd, **(dict(src_pk=ctx.rect_src_pk) if pack
                                 else {}))
                key = _rect_launch_key(coarse, geom)
                k = NR.rect_ncc(*args, coarse, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pl = NR.rect_ncc_plain(*args, coarse, **sd)
                torch.cuda.synchronize()
                plain_ms = 1e3 * (time.perf_counter() - t0)
                rt = NR.rect_ncc(*args, coarse, **kw, runtime_taps=True)
                torch.cuda.synchronize()
                if not (_same(k, pl) and _same(rt, pl)):
                    raise AssertionError(
                        f"{key} {label} C={C}: not bit-identical to the plain "
                        f"version (max err {_max_err(k, pl)}; runtime build "
                        f"{_max_err(rt, pl)})")
                calls = dict(
                    t9=lambda: NR.rect_ncc(*args, coarse, **kw),
                    runtime=lambda: NR.rect_ncc(*args, coarse, **kw,
                                                runtime_taps=True),
                    taps36=lambda: NR.rect_ncc(*args, full, **kw))
                turns = {b: [] for b in calls}
                for b in ("t9", "runtime", "taps36", "taps36", "runtime",
                          "t9"):
                    turns[b].append(cuda_ms(calls[b], 5))
                frames = (ctx.rect_ref, ctx.rect_src) + (
                    (ctx.rect_sdisp,) if geom else ())
                bnd = bound(nbytes(D, AB, maps.fwd_valid, ctx.srow,
                                   ctx.tile_oy, ctx.tile_ox, *frames,
                                   *(k if geom else (k,))),
                            live * 1024 * C * n_taps * TAP_FLOPS)
                mean = lambda b: sum(turns[b]) / len(turns[b])
                out.setdefault(key, {})[f"{label}_C{C}"] = dict(
                    ms=mean("t9"), runtime_ms=mean("runtime"),
                    taps36_ms=mean("taps36"), ms_turns=turns,
                    plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                    max_abs_err=0.0, taps=n_taps)
                del k, pl, rt
        del D, AB, nn, ww
    log(f"9-tap builds on {label} operands: {json.dumps(out)}")
    return out


def run_prescreen_phase(dev, bench, sphere_problem, work, sgt, spipe,
                        results):
    """Phase 17: ``rect_prescreen`` on the card, both bf16 packs on (the
    defaults).  ``bench``: (inputs, f32 params, ground truth, geometric
    inputs with phase 4's source depths, with phase 4b's);
    ``sphere_problem``: phase 10's (inputs, geometric inputs with the
    packed passes' source depths, f32 params, ground truth).  The pinhole
    photometric pass and the geometric pass seeded from it, with the source
    depths of the chain it is compared with (phase 4b's packed, phase 4's
    with the packs off: kernels 1 and 4's 9-tap builds), and the SPHERE
    photometric and geometric passes, each once through ``prescreen_pass``;
    gates: each pinhole pair's median relative depth error below
    ``DEPTH_ERR_MAX``, the geometric one below the photometric one, the
    SPHERE band errors below ``SPHERE_BAND_ERR_MAX``.
    Then the 9-tap builds timed on the passes' operands (``t9_cases``), the
    default and prescreen passes of each kind in turn (``alternate_passes``)
    and phase 11's SPHERE scene through ``run_pipeline`` with prescreen on
    (checked as phase 11, at phase 11's gates) beside phase 11's run.
    Returns the numbers, the driven paths under ``paths``."""
    import torch

    from acmmp_spherical_torch.bench import sphere_band_errors
    from acmmp_spherical_torch.config import PatchMatchParams
    from acmmp_spherical_torch.ops import sphere_rect as SR
    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR
    from acmmp_spherical_torch.ops.propagate import prepare_inputs
    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch

    t_phase = time.perf_counter()
    inputs, params, gt, geom_inputs, pk_geom_inputs = bench
    out = dict(paths={}, errors={})
    runs = out["paths"]

    def pinhole(tag, packs):
        p = dataclasses.replace(params, rect_tap_pack=packs,
                                rect_backmap_pack=packs, rect_prescreen=True)
        gp = p.with_geom(multi_geometry=False)
        src = pk_geom_inputs if packs else geom_inputs
        res, runs[f"{tag} photometric"] = prescreen_pass(
            f"prescreen {tag} photometric", lambda r: run_patchmatch(
                inputs, p, r), p, False)
        seeds = dict(seed_normal_world=res[1], seed_depth=res[0])
        gres, runs[f"{tag} geometric"] = prescreen_pass(
            f"prescreen {tag} geometric", lambda r: run_patchmatch(
                src, gp, 100 + r, **seeds), gp, True)
        out["errors"][tag] = dict(
            photometric=median_rel_err(res[0], gt[0]),
            geometric=median_rel_err(gres[0], gt[0]))
        return p, gp, res, seeds

    p, gp, res, seeds = pinhole("packed", True)
    pinhole("f32", False)
    log(f"phase 17: prescreen bench passes, median rel depth err "
        f"{out['errors']} (gates {DEPTH_ERR_MAX}, the geometric pass below "
        "the photometric one)")
    for tag in ("packed", "f32"):
        e = out["errors"][tag]
        if not (e["photometric"] < DEPTH_ERR_MAX and e["geometric"]
                < DEPTH_ERR_MAX and e["geometric"] < e["photometric"]):
            raise AssertionError(f"prescreen {tag} bench passes: {e}")

    s_inputs, s_geom_inputs, s_params, s_gt = sphere_problem
    sp = dataclasses.replace(s_params, rect_tap_pack=True,
                             rect_backmap_pack=True, rect_prescreen=True)
    sgp = sp.with_geom(multi_geometry=False)
    sres, runs["sphere photometric"] = prescreen_pass(
        "prescreen sphere photometric", lambda r: run_patchmatch(
            s_inputs, sp, r), sp, False)
    sseeds = dict(seed_normal_world=sres[1], seed_depth=sres[0])
    sgres, runs["sphere geometric"] = prescreen_pass(
        "prescreen sphere geometric", lambda r: run_patchmatch(
            s_geom_inputs, sgp, 50 + r, **sseeds), sgp, True)
    out["errors"]["sphere"] = {
        k: sphere_band_errors(o[0].cpu().numpy(), s_gt[0], s_inputs.ref_cam)
        for k, o in (("photometric", sres), ("geometric", sgres))}
    log(f"phase 17: prescreen sphere passes {out['errors']['sphere']} (gate "
        f"{SPHERE_BAND_ERR_MAX} on the band)")
    for k, e in out["errors"]["sphere"].items():
        if not e["band"] < SPHERE_BAND_ERR_MAX:
            raise AssertionError(f"prescreen sphere {k}: {e}")

    # the 9-tap builds on the passes' own operands
    t0 = time.perf_counter()
    ctx = prepare_inputs(pk_geom_inputs, gp).rect
    cases = t9_cases("pinhole", ctx, plane_field(inputs.ref_cam, *res[:2]),
                     p, NR.coefficient_transport)
    del ctx
    sctx = prepare_inputs(s_geom_inputs, sgp).rect
    sphere_transport = lambda c, maps, n, w: NR.warp_transport_plain(
        *SR.sphere_coefficient_tables(c, n, w, 0), maps.fwd_idx,
        maps.fwd_valid)
    for key, c in t9_cases("sphere", sctx,
                           plane_field(s_inputs.ref_cam, *sres[:2]), sp,
                           sphere_transport).items():
        cases[key].update(c)
    del sctx
    out["t9_cases_s"] = time.perf_counter() - t0
    for key, c in cases.items():
        # the entry's numbers: the largest coarse call of the key's passes
        # (C=8 photometric, C=5 geometric), pinhole operands
        first = c["pinhole_C5" if "geom" in key else "pinhole_C8"]
        e = kernel_entry("rect_ncc.cu", "ncc_rect.py:614", 0.0, first["ms"],
                         first["plain_ms"], (first["bound_ms"],
                                             first["bound_by"]))
        variant = ("geom" if "geom" in key else "phot") + (
            "_pk" if "_pk" in key else "")
        e.update(runtime_ms=first["runtime_ms"], taps36_ms=first["taps36_ms"],
                 variant=f"{variant}, 9 taps", cases=c,
                 ptxas=ptxas_of(results["ptxas"], variant + "_t9"))
        results[key] = e

    # default and prescreen passes in turn, on the host clock and traced
    t0 = time.perf_counter()
    dp = dataclasses.replace(p, rect_prescreen=False)
    sdp = dataclasses.replace(sp, rect_prescreen=False)
    out["timing"] = alternate_passes({
        "photometric default": (inputs, dp, {}),
        "photometric prescreen": (inputs, p, {}),
        "geometric default": (pk_geom_inputs, dp.with_geom(False), seeds),
        "geometric prescreen": (pk_geom_inputs, gp, seeds),
        "sphere photometric default": (s_inputs, sdp, {}),
        "sphere photometric prescreen": (s_inputs, sp, {}),
        "sphere geometric default": (s_geom_inputs, sdp.with_geom(False),
                                     sseeds),
        "sphere geometric prescreen": (s_geom_inputs, sgp, sseeds)},
        PRESCREEN_TRACED)
    out["timing_s"] = time.perf_counter() - t0
    log("phase 17: passes in turn (ms host clock; device ms, idle share): "
        + json.dumps({k: [v["pass_s"], v["pass_ms"], v.get("device_ms"),
                          v.get("idle_share")]
                      for k, v in out["timing"].items()}))
    del res, sres, sgres, seeds, sseeds
    torch.cuda.empty_cache()

    # the SPHERE scene of phase 11 with prescreen on
    spre = run_pipeline_phase(
        dev, SPHERE_PRESCREEN_SCENE, work, sgt, "prescreen",
        patchmatch=dataclasses.replace(PatchMatchParams(),
                                       rect_prescreen=True))
    out["sphere_scene"] = {k: dict(wall_s=r["wall_s"],
                                   median_rel_depth_err=r[
                                       "median_rel_depth_err"],
                                   hier_median_rel_depth_err=r[
                                       "hier_median_rel_depth_err"],
                                   fused_points=r["fused_points"],
                                   on_surface=r["on_surface"])
                           for k, r in (("default", spipe),
                                        ("prescreen", spre))}
    runs["sphere scene"] = spre
    log(f"phase 17: SPHERE scene, default (phase 11) and prescreen: "
        f"{json.dumps(out['sphere_scene'])}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17: {out['phase_s']:.1f} s")
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
    results: dict = {"ptxas": rect_ptxas(ptxas)}
    log(f"rect_ncc instantiations (registers, spills): {results['ptxas']}")

    # the bench problem and its rectified context
    t0 = time.perf_counter()
    inputs, params, gt, _ = make_problem(**BENCH_SCENE, device=dev)
    bench_gt = gt
    log(f"scene render {time.perf_counter() - t0:.1f} s; params "
        f"comp_hw={params.rect_comp_hw} live_n={params.rect_live_n} "
        f"init_win={params.rect_init_win} warp_hw={params.rect_warp_hw} "
        f"inv_attrib={params.rect_inv_attrib}")
    prepared = prepare_inputs(inputs, params)
    ctx_ms = cuda_ms(lambda: prepare_inputs(inputs, params), 2)
    log(f"build_rect_context {ctx_ms:.1f} ms")

    # phase 2: photometric kernels against their plain versions (and the
    # packed-tap variant of kernel 1 on the same operands)
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

    # phase 4b: the packed bench points -- the photometric and geometric
    # passes with both bf16 packs on (the defaults), the packed chain
    # (seeds and source depths from packed passes), at the f32 gates
    pk_params = dataclasses.replace(params, rect_tap_pack=True,
                                    rect_backmap_pack=True)
    pout, pphot = drive_checked(
        "photometric packed", PK_PHOT_KERNELS,
        lambda r: run_patchmatch(inputs, pk_params, r))
    prel = median_rel_err(pout[0], gt[0])
    pg_inputs = dataclasses.replace(
        inputs, src_depths=source_depths(inputs, pk_params))
    pg_params = pk_params.with_geom(multi_geometry=False)
    pgout, pgeom = drive_checked(
        "geometric packed", PK_GEOM_KERNELS, lambda r: run_patchmatch(
            pg_inputs, pg_params, 100 + r, seed_normal_world=pout[1],
            seed_depth=pout[0]))
    pgrel = median_rel_err(pgout[0], gt[0])
    log(f"packed: photometric median rel depth err {prel} (f32 {rel}), "
        f"geometric {pgrel} (f32 {grel})")
    for e in (pphot, pgeom):
        e["pass_ms"] = 1e3 * sum(e["pass_s"]) / len(e["pass_s"])
    if pphot["launches"]["rect_ncc"] or pgeom["launches"]["rect_ncc_geom"]:
        raise AssertionError("a packed pass launched the f32 rect kernel")
    if prel >= DEPTH_ERR_MAX or pgrel >= DEPTH_ERR_MAX or pgrel >= prel:
        raise AssertionError(f"packed passes: photometric {prel}, geometric "
                             f"{pgrel}, gates {DEPTH_ERR_MAX} and below the "
                             "photometric")
    # each pack alone, on the photometric pass (numbers only, no gate)
    one_pack, one_runs = {}, []
    for flag in ("rect_tap_pack", "rect_backmap_pack"):
        one = dataclasses.replace(params, **{flag: True})
        o, run = drive_checked(f"photometric, {flag} alone",
                               PHOT_KERNELS[1:],
                               lambda r: run_patchmatch(inputs, one, r),
                               reps=1)
        one_pack[flag] = dict(median_rel_depth_err=median_rel_err(o[0], gt[0]),
                              pass_s=run["pass_s"], launches=run["launches"])
        one_runs.append(run)
    log(f"photometric with one pack on: {one_pack}")

    # phase 5: golden passes against the reference's fixtures
    ginputs, gparams = make_problem(**GOLDEN_SCENE, device=dev)[:2]
    gparams = dataclasses.replace(gparams, rect_inv_attrib=False)
    worst = check_golden("golden_pass_stats_warp.json",
                         run_patchmatch(ginputs, gparams, GOLDEN_KEY))
    # the same pass at the reference's defaults, both bf16 packs on, as the
    # fixture was made
    pk_worst = check_golden("golden_pass_stats_warp.json", run_patchmatch(
        ginputs, dataclasses.replace(gparams, rect_tap_pack=True,
                                     rect_backmap_pack=True), GOLDEN_KEY))
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

    work_dir = tempfile.TemporaryDirectory()
    work = pathlib.Path(work_dir.name)
    scenes = {}
    for sc in (PIPELINE_SCENE, SPHERE_PIPELINE_SCENE):
        scenes[sc["label"]] = write_pipeline_scene(
            sc, work / f"{sc['label']}_input")

    # phase 9: the pipeline at a real size, every kernel of it also held
    # against its plain version at the pipeline's own operands
    gt, scene_s = scenes["pinhole"]
    pipe = run_pipeline_phase(dev, PIPELINE_SCENE, work, gt, "serial")
    pipe["scene_s"] = scene_s

    # phase 10: the sphere passes at 1024x512x6src, kernels 1 and 4 held
    # against their plain versions at their pole-rotated operands
    sphere, sphere_problem = run_sphere_phase(dev, results)

    # phase 11: the sphere scene through run_pipeline, and convert
    sgt, sscene_s = scenes["sphere"]
    spipe = run_pipeline_phase(dev, SPHERE_PIPELINE_SCENE, work, sgt,
                               "serial")
    spipe["scene_s"] = sscene_s
    conv = check_convert()

    # phase 12: phase 9's scene in chunks over 3 slots of the card, every
    # slot's kernels held against their plain versions; sharded fusion and
    # the view-parallel step
    bpipe = run_batched_phase(dev, PIPELINE_SCENE, work, gt, pipe)

    # phase 13: phase 11's scene by two ranks of reconstruct --distributed
    dpipe = run_distributed_phase(SPHERE_PIPELINE_SCENE, work, spipe)

    # phase 14: the discontinuity golden on the card, at the defaults
    disc = run_discontinuity_phase(dev)

    # phase 15: the hostile bench pass, packs on and off
    hostile = run_hostile_phase(dev)

    # phase 16: the tile-parallel pass over slots of the card, and the
    # tiled pipeline
    tile = run_tile_phase(dev, inputs, params, bench_gt, geom_inputs)

    # phase 17: rect_prescreen, the bench and SPHERE passes, the 9-tap
    # builds and the SPHERE scene
    pre = run_prescreen_phase(
        dev, (inputs, params, bench_gt, geom_inputs, pg_inputs),
        sphere_problem, work, sgt, spipe, results)
    del sphere_problem, pg_inputs
    work_dir.cleanup()
    for p_ in (pphot, pgeom, *one_runs, sphere["phot_pk"], sphere["geom_pk"],
               pipe, spipe, bpipe["batched_checked"], bpipe["multichip"],
               dpipe, *disc["paths"].values(), *hostile["paths"].values(),
               *pre["paths"].values()):
        for key, c in p_["plain_checks"].items():
            e = results[key.rsplit(" ", 1)[-1]]
            e["max_abs_err"] = max(e["max_abs_err"], c["max_abs_err"])
            e["pipeline_checks"] = e.get("pipeline_checks", 0) + c["shapes"]

    names = ("rect_ncc", "rect_ncc_geom", "rect_ncc_pk", "rect_ncc_geom_pk",
             "rect_ncc_t9", "rect_ncc_geom_t9", "rect_ncc_pk_t9",
             "rect_ncc_geom_pk_t9",
             "pack_src_pairs", "warp_transport", "warp_src_frames",
             "warp_src_disparities", "ncc_window", "ncc_window_geom",
             "window_sample")
    paths = (phot, geom, pphot, pgeom, win, wgeom, samp, pipe,
             sphere["phot"], sphere["geom"], sphere["phot_pk"],
             sphere["geom_pk"], spipe, bpipe["batched_checked"],
             bpipe["batched"], bpipe["multichip"], dpipe,
             *disc["paths"].values(), *hostile["paths"].values(),
             *pre["paths"].values())
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
        "photometric_packed": pphot, "geometric_packed": pgeom,
        "packed_median_rel_depth_err": prel,
        "packed_geom_median_rel_depth_err": pgrel,
        "photometric_one_pack": one_pack,
        "window_median_rel_depth_err": wrel,
        "window_geom_median_rel_depth_err": wgrel,
        "golden_worst_over_tol": worst, "golden_geom_worst_over_tol": gworst,
        "golden_packed_worst_over_tol": pk_worst,
        "golden_exact_worst_over_tol": eworst,
        "golden_window_worst_over_tol": wworst,
        "golden_odd_worst_over_tol": oworst,
        "golden_prior_worst_over_tol": pworst,
        "golden_hier_worst_over_tol": hworst, "pipeline": pipe,
        "sphere": sphere, "sphere_pipeline": spipe, "convert": conv,
        "batched_pipeline": bpipe, "distributed_pipeline": dpipe,
        "discontinuity": disc, "hostile": hostile, "tile": tile,
        "prescreen": pre,
        "smoke_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
