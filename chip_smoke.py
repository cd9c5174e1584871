#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from ``acmmp_spherical_torch/csrc`` (one nvcc per source, all
   started together; build seconds printed);
2. check the photometric pass's kernels against their plain-torch versions
   on the card, at the shapes of the 1024x768x8src photometric pass (the
   C=9 and C=5 parity evaluations and the C=1 init evaluation);
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
5. every kernel launched on one of the two paths, and the 96x64x3src golden
   photometric and geometric passes match the reference's committed
   statistics at drift_gate's 2e-2.

Prints the card's name and power limit, one JSON line of kernel results,
then, last, ``{"ok": true, "device": {...}}``.  Needs CUDA; never falls back
to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
COST_TOL = 1e-4          # |kernel - plain| on costs where both agree on `bad`
BAD_AGREE_MIN = 0.999    # fraction of pixels whose `bad` decision agrees
GEOM_TOL = 1e-4          # |kernel - plain| on geom costs; gok mask identical
WARP_TOL = 1e-4          # greylevels, valid samples; SENTINEL mask identical
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


def check_golden(fixture: str, out) -> float:
    """Worst |stat - fixture| over drift_gate's tolerance of a golden pass."""
    golden = json.loads((ROOT / "tests/fixtures" / fixture).read_text())
    d, n, c = (a.cpu().numpy() for a in out[:3])
    stats = golden_stats(d, n, c)
    worst = max(abs(stats[k] - v) / max(FIXTURE_TOL, FIXTURE_TOL * abs(v))
                for k, v in golden.items())
    log(f"golden pass vs {fixture}: worst {worst:.3f} x tolerance")
    if worst > 1.0:
        raise AssertionError(f"golden pass drifted from {fixture}")
    return worst


def median_rel_err(depth, gt) -> float:
    import numpy as np

    d = depth.cpu().numpy()
    if not np.all(np.isfinite(d)) or d.shape != gt.shape:
        raise AssertionError("depth map is not finite or has the wrong shape")
    g = gt[8:-8, 8:-8]
    return float(np.median(np.abs(d[8:-8, 8:-8] - g) / g))


def packed(normals, ws, parity):
    """(C, H, W[, 3]) plane fields -> that parity's packed half-grids."""
    from acmmp_spherical_torch.ops.sampling import checkerboard_pack

    if parity is None:
        return normals, ws
    return (checkerboard_pack(normals.movedim(-1, 0), parity).movedim(0, -1),
            checkerboard_pack(ws, parity))


def check_rect_case(name, rect, normals, ws, parity, p, with_geom):
    """Transport + rect_ncc (with_geom: its geometric variant) against their
    plain versions on one batched evaluation; returns its numbers."""
    import torch

    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR

    maps = rect.maps[0 if parity is None else 1 + parity]
    tab_d, tab_ab = NR.coefficient_tables(rect, maps, normals, ws)
    targs = (tab_d, tab_ab, maps.fwd_idx, maps.fwd_valid)
    D, AB = NR.warp_transport(*targs)
    Dp, ABp = NR.warp_transport_plain(*targs)
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
    transport_bound = bound(nbytes(*targs, D, AB), 0)
    return dict(
        ncc_max_abs_err=max(err, gerr or 0.0),
        transport_max_abs_err=float((D - Dp).abs().max()),
        transport_ms=cuda_ms(lambda: NR.warp_transport(*targs), 10),
        transport_plain_ms=cuda_ms(lambda: NR.warp_transport_plain(*targs), 3),
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


def check_warp(name, fn, plain, args, valid_flops, tol, results):
    """A source warp against its plain version: SENTINEL masks identical,
    valid samples within ``tol``."""
    import torch

    from acmmp_spherical_torch.ops.rectify import SENTINEL_THRESH

    k, pl = fn(*args), plain(*args)
    torch.cuda.synchronize()
    vk, vp = k > SENTINEL_THRESH, pl > SENTINEL_THRESH
    if not torch.equal(vk, vp):
        raise AssertionError(f"{name}: SENTINEL masks differ")
    err = float((k - pl)[vk].abs().max())
    if err > tol:
        raise AssertionError(f"{name}: max err {err}")
    src = "warp_image.py:215" if name == "warp_src_frames" else \
        "warp_image.py:263"
    results[name] = kernel_entry(
        "warp_image.cu", src, err, cuda_ms(lambda: fn(*args), 10),
        cuda_ms(lambda: plain(*args), 2),
        bound(nbytes(args[0], k), int(vk.sum()) * valid_flops))
    log(f"{name} ok: {results[name]}, valid fraction "
        f"{float(vk.float().mean()):.3f}")


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
               WARP_TOL, results)
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
    c9 = results["cases"]["C9_parity0"]
    results["warp_transport"] = kernel_entry(
        "warp_transport.cu", "ncc_rect.py:460",
        max(c["transport_max_abs_err"] for c in results["cases"].values()),
        c9["transport_ms"], c9["transport_plain_ms"], c9["transport_bound"])
    results["rect_ncc"] = kernel_entry(
        "rect_ncc.cu", "ncc_rect.py:614",
        max(c["ncc_max_abs_err"] for c in results["cases"].values()),
        c9["ncc_ms"], c9["ncc_plain_ms"], c9["ncc_bound"])


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
                rect_shape(H, W), params.rect_warp_hw), DISP_FLOPS, 0.0,
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
    g9 = results["cases"]["geom_C9_parity0"]
    results["rect_ncc_geom"] = kernel_entry(
        "rect_ncc.cu", "ncc_rect.py:614",
        max(results["cases"][k]["ncc_max_abs_err"]
            for k in ("geom_C9_parity0", "geom_C5_parity1")),
        g9["ncc_ms"], g9["ncc_plain_ms"], g9["ncc_bound"])


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
        make_problem, source_depths,
    )
    from acmmp_spherical_torch.ops.kernels import _lib
    from acmmp_spherical_torch.ops.propagate import prepare_inputs
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

    names = ("rect_ncc", "rect_ncc_geom", "warp_transport", "warp_src_frames",
             "warp_src_disparities")
    kernels = [dict(name=k, launches=phot["launches"][k]
                    + geom["launches"][k], **results[k]) for k in names]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} was never launched")
    log("details " + json.dumps({
        "card": card, "build_s": build_s,
        "stages_ms": {"build_rect_context": ctx_ms,
                      "build_rect_context_geom": gctx_ms, **results["cases"]},
        "photometric": phot, "geometric": geom, "seed_passes_s": seed_s,
        "median_rel_depth_err": rel, "geom_median_rel_depth_err": grel,
        "golden_worst_over_tol": worst, "golden_geom_worst_over_tol": gworst,
        "smoke_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
