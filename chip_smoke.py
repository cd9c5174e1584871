#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from ``acmmp_spherical_torch/csrc`` (build seconds printed);
2. check every kernel against its plain-torch version on the card, at the
   shapes of the 1024x768x8src photometric pass (the C=9 and C=5 parity
   evaluations and the C=1 init evaluation);
3. drive the port's main path -- ``pipeline.patchmatch.run_patchmatch`` on
   the CubeRoom 1024x768x8src scene -- once warm and three times timed, with
   the launch counters zeroed just before and read just after;
4. assert every kernel launched on the main path, the median relative depth
   error against ground truth is < 0.0032, and the 96x64x3src golden pass
   matches the reference's committed statistics at drift_gate's 2e-2.

Prints one JSON line of kernel results, then, last,
``{"ok": true, "device": {...}}``.  Needs CUDA; never falls back to the CPU.
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
WARP_TOL = 1e-4          # greylevels, valid samples; SENTINEL mask identical
DEPTH_ERR_MAX = 0.0032   # median relative depth error gate of the bench
FIXTURE_TOL = 2e-2       # scripts/drift_gate.py rtol/atol


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


def check_kernels(inputs, params, results):
    """Phase 2: every kernel against its plain version at bench shapes."""
    import torch

    from acmmp_spherical_torch.ops import rng as R
    from acmmp_spherical_torch.ops.kernels import ncc_rect as NR
    from acmmp_spherical_torch.ops.kernels import warp_image as WI
    from acmmp_spherical_torch.ops.rectify import SENTINEL_THRESH, rect_shape
    from acmmp_spherical_torch.ops.sampling import checkerboard_pack, grid_coords

    rect = inputs.rect
    H, W = inputs.ref_image.shape
    cams = inputs.src_cams
    dev = inputs.ref_image.device

    # kernel 3: source warp
    args = (inputs.src_images, rect.pr.H1inv, cams.width, cams.height,
            rect_shape(H, W), params.rect_warp_hw)
    k3 = WI.warp_src_frames(*args)
    p3 = WI.warp_src_frames_plain(*args)
    torch.cuda.synchronize()
    vk, vp = k3 > SENTINEL_THRESH, p3 > SENTINEL_THRESH
    if not torch.equal(vk, vp):
        raise AssertionError("warp_src_frames: SENTINEL masks differ")
    err3 = float((k3 - p3)[vk].abs().max())
    if err3 > WARP_TOL:
        raise AssertionError(f"warp_src_frames: max err {err3}")
    results["warp_src_frames"] = dict(
        route="cuda", source="acmmp_spherical_torch/csrc/warp_image.cu",
        replaces="acmmp_spherical_tpu/ops/pallas/warp_image.py:215",
        max_abs_err=err3, ms=cuda_ms(lambda: WI.warp_src_frames(*args), 10),
        plain_ms=cuda_ms(lambda: WI.warp_src_frames_plain(*args), 2),
        shape=list(k3.shape))
    log(f"warp_src_frames ok: {results['warp_src_frames']}")

    # plane fields at the pass's shapes: C=9 / C=5 on a parity half-grid,
    # C=1 on the full grid (the init), from random planes
    xs, ys = grid_coords(H, W, dev)
    dmin, dmax = inputs.depth_range[0], inputs.depth_range[1]
    planes = [R.random_plane_hypothesis(R.key(100 + i), inputs.ref_cam, xs,
                                        ys, dmin, dmax) for i in range(9)]
    pack = lambda a, p: checkerboard_pack(a, p)
    packn = lambda a, p: checkerboard_pack(a.movedim(-1, 0), p).movedim(0, -1)
    cases = [
        ("C9_parity0", 9, 0, params),
        ("C5_parity1", 5, 1, params),
        ("C1_init", 1, None, dataclasses.replace(
            params, rect_win_w=params.rect_init_win)),
    ]
    err1 = err2 = 0.0
    for name, C, parity, p in cases:
        if parity is None:
            normals = torch.stack([n for n, _ in planes[:C]])
            ws = torch.stack([w for _, w in planes[:C]])
            maps = rect.maps[0]
        else:
            normals = torch.stack([packn(n, parity) for n, _ in planes[:C]])
            ws = torch.stack([pack(w, parity) for _, w in planes[:C]])
            maps = rect.maps[1 + parity]
        tab_d, tab_ab = NR.coefficient_tables(rect, maps, normals, ws)
        targs = (tab_d, tab_ab, maps.fwd_idx, maps.fwd_valid)
        D, AB = NR.warp_transport(*targs)
        Dp, ABp = NR.warp_transport_plain(*targs)
        torch.cuda.synchronize()
        if not (torch.equal(D, Dp) and torch.equal(AB, ABp)):
            raise AssertionError(f"warp_transport {name}: not bit-identical")
        rargs = (rect.srow, rect.tile_oy, rect.tile_ox, rect.rect_ref,
                 rect.rect_src, D, AB, maps.fwd_valid, p)
        ck = NR.rect_ncc(*rargs)
        cp = NR.rect_ncc_plain(*rargs)
        torch.cuda.synchronize()
        bk, bp = ck >= p.cost_max, cp >= p.cost_max
        agree = float((bk == bp).float().mean())
        both = ~bk & ~bp
        err = float((ck - cp)[both].abs().max()) if bool(both.any()) else 0.0
        log(f"rect_ncc {name}: bad-mask agreement {agree:.6f}, max err "
            f"{err:.3g}, live fraction {float(both.float().mean()):.3f}")
        if agree < BAD_AGREE_MIN or err > COST_TOL:
            raise AssertionError(f"rect_ncc {name}: agreement {agree}, err {err}")
        err1, err2 = max(err1, err), max(err2, float((D - Dp).abs().max()))
        times = dict(
            transport_ms=cuda_ms(lambda: NR.warp_transport(*targs), 10),
            transport_plain_ms=cuda_ms(
                lambda: NR.warp_transport_plain(*targs), 3),
            ncc_ms=cuda_ms(lambda: NR.rect_ncc(*rargs), 5),
            ncc_plain_ms=cuda_ms(lambda: NR.rect_ncc_plain(*rargs), 1),
            batched_ms=cuda_ms(lambda: NR.rect_batched_ncc(
                rect, normals, ws, p, parity=parity), 5))
        results.setdefault("cases", {})[name] = times
        log(f"{name} times (ms): {times}")
    c9 = results["cases"]["C9_parity0"]
    results["warp_transport"] = dict(
        route="cuda", source="acmmp_spherical_torch/csrc/warp_transport.cu",
        replaces="acmmp_spherical_tpu/ops/pallas/ncc_rect.py:460",
        max_abs_err=err2, ms=c9["transport_ms"],
        plain_ms=c9["transport_plain_ms"])
    results["rect_ncc"] = dict(
        route="cuda", source="acmmp_spherical_torch/csrc/rect_ncc.cu",
        replaces="acmmp_spherical_tpu/ops/pallas/ncc_rect.py:614",
        max_abs_err=err1, ms=c9["ncc_ms"], plain_ms=c9["ncc_plain_ms"])


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
    from acmmp_spherical_torch.bench import make_problem
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

    # phase 1: build
    t0 = time.perf_counter()
    lib = _lib.library()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s: {lib._name}")
    ptxas = pathlib.Path(lib._name).with_name("ptxas.log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")

    # the bench problem and its rectified context
    t0 = time.perf_counter()
    inputs, params, gt = make_problem(1024, 768, 8, dev, focal=921.6,
                                      radius=0.25)
    log(f"scene render {time.perf_counter() - t0:.1f} s; params "
        f"comp_hw={params.rect_comp_hw} live_n={params.rect_live_n} "
        f"init_win={params.rect_init_win} warp_hw={params.rect_warp_hw} "
        f"inv_attrib={params.rect_inv_attrib}")
    prepared = prepare_inputs(inputs, params)
    ctx_ms = cuda_ms(lambda: prepare_inputs(inputs, params), 2)
    log(f"build_rect_context {ctx_ms:.1f} ms")

    # phase 2: kernels against their plain versions
    results: dict = {}
    check_kernels(prepared, params, results)

    # phase 3: the main path, counters zeroed just before
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    run_patchmatch(inputs, params, 0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times = []
    for r in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_patchmatch(inputs, params, r + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(_lib.LAUNCHES)
    depth = out[0].cpu().numpy()
    import numpy as np

    g = gt[0][8:-8, 8:-8]
    rel = float(np.median(np.abs(depth[8:-8, 8:-8] - g) / g))
    log(f"pass times (s): warm {warm_s:.3f}, timed {times}; median rel depth "
        f"err {rel:.5f}; launches {launches}")

    # phase 4: assertions
    if not np.all(np.isfinite(depth)) or depth.shape != (768, 1024):
        raise AssertionError("depth map is not finite or has the wrong shape")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the pass")
    if rel >= DEPTH_ERR_MAX:
        raise AssertionError(f"median rel depth err {rel} >= {DEPTH_ERR_MAX}")
    golden = json.loads((ROOT / "tests/fixtures/golden_pass_stats_warp.json")
                        .read_text())
    ginputs, gparams, _ = make_problem(96, 64, 3, dev, focal=80.0,
                                       radius=0.35)
    gparams = dataclasses.replace(gparams, rect_inv_attrib=False)
    gd, gn, gc, _ = run_patchmatch(ginputs, gparams, 2333)
    stats = golden_stats(gd.cpu().numpy(), gn.cpu().numpy(), gc.cpu().numpy())
    worst = max(abs(stats[k] - v) / max(FIXTURE_TOL, FIXTURE_TOL * abs(v))
                for k, v in golden.items())
    log(f"golden pass vs reference fixture: worst {worst:.3f} x tolerance")
    if worst > 1.0:
        raise AssertionError("golden pass drifted from the reference fixture")

    kernels = [dict(name=k, launches=launches[k], **{
        f: results[k][f] for f in ("route", "source", "replaces",
                                   "max_abs_err", "ms", "plain_ms")})
        for k in ("rect_ncc", "warp_transport", "warp_src_frames")]
    log("details " + json.dumps({
        "card": card, "build_s": build_s,
        "stages_ms": {"build_rect_context": ctx_ms, **results["cases"]},
        "pass_s": times, "warm_pass_s": warm_s, "median_rel_depth_err": rel,
        "golden_worst_over_tol": worst}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
