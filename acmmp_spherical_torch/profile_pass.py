"""Where the time of a pass goes on the GPU: stage times and device time.

    python -m acmmp_spherical_torch.profile_pass [--windowed | --sphere]

On the bench scene (CubeRoom 1024x768x8src, rectified path) it runs the
photometric pass and the geometric pass seeded from it (source depths from
the 8 views' own photometric passes, as the bench); with ``--windowed`` the
same two passes on the windowed path (``rect_ncc`` off, ``fast_ncc`` on,
the geometric pass seeded from the windowed photometric one); with
``--sphere`` the two passes of the sphere bench scene (equirect CubeRoom
1024x512x6src, pole-rotated path; source depths from keys 2000 + i).  For
each it prints:

* stage times -- host clock around each stage of ``run_patchmatch``, each
  ended by ``torch.cuda.synchronize()``, mean of 3 passes after a warm one:
  context build, reference tap context (off the rectified path), init,
  every half-step, extraction + median filter;
* the unprofiled pass time (host clock, mean of 3 more passes);
* under ``torch.profiler`` over one more pass: the device time of all
  kernels, the idle share (1 - device time / unprofiled pass time: two
  different runs, so approximate), the number of device kernels, and the
  device time and count of each hand-written kernel and of the 8 largest
  other kernels.

Both pass kinds are timed before either is traced, so the profiler's set-up
cannot slow the timed passes.

Writes one JSON line per pass kind to stdout.  Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from acmmp_spherical_torch.bench import (
    BENCH_SCENE, SPHERE_BENCH_SCENE, make_problem, make_sphere_problem,
    source_depths,
)
from acmmp_spherical_torch.ops import rng as R
from acmmp_spherical_torch.ops.filter import checkerboard_median_filter
from acmmp_spherical_torch.ops.ncc import ref_tap_context
from acmmp_spherical_torch.ops.propagate import (
    checkerboard_halfstep, extract_depth_and_normal, initialize_state,
    needs_tap_context, prepare_inputs,
)
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch

KERNELS = ("rect_ncc_kernel", "warp_transport_kernel", "warp_src_kernel",
           "warp_disp_kernel", "ncc_window_kernel")


def staged_pass(inputs, params, key, seeds):
    """``run_patchmatch`` stage by stage (without ``exact_first_iteration``,
    which the bench parameters leave off); returns {stage: seconds}."""
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return out

    key = R.key(key)
    prep = stage("build_rect_context", lambda: prepare_inputs(inputs, params))
    ctx = None
    if needs_tap_context(prep, params):
        ctx = stage("ref_tap_context", lambda: ref_tap_context(
            prep.ref_image, prep.ref_cam, params))
    k_init, k_iters = R.split(key)
    state = stage("initialize_state", lambda: initialize_state(
        prep, params, k_init, ctx=ctx, **seeds))
    for i in range(params.max_iterations):
        k0, k1 = R.split(R.fold_in(k_iters, i))
        for parity, k in ((0, k0), (1, k1)):
            state = stage("half-steps", lambda: checkerboard_halfstep(
                state, prep, params, k, i, parity, ctx=ctx))

    def finish():
        depth, _ = extract_depth_and_normal(state, prep.ref_cam)
        return checkerboard_median_filter(depth, state.cost,
                                          min_cost=params.filter_min_cost)

    stage("extraction + median filter", finish)
    return times


def timing(kind, inputs, params, seeds, reps=3):
    """Stage times and unprofiled pass times of one pass kind."""
    run = lambda k: run_patchmatch(inputs, params, k, **seeds)
    run(0)
    torch.cuda.synchronize()
    stages = [staged_pass(inputs, params, r + 1, seeds) for r in range(reps)]
    walls = []
    for r in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(r + 1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return dict(
        pass_kind=kind, card=torch.cuda.get_device_name(0),
        stages_ms={k: 1e3 * sum(s[k] for s in stages) / reps
                   for k in stages[0]},
        pass_ms=1e3 * sum(walls) / reps, pass_s=walls)


def trace(result, inputs, params, seeds):
    """Add the device time of one traced pass to ``timing``'s result."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_patchmatch(inputs, params, 4, **seeds)
        torch.cuda.synchronize()
    device = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            device[ev.key] = (us / 1e3, ev.count)
    total_ms = sum(ms for ms, _ in device.values())
    mine = {k: [sum(ms for n, (ms, _) in device.items() if k in n),
                sum(c for n, (_, c) in device.items() if k in n)]
            for k in KERNELS}
    others = sorted(((ms, n, c) for n, (ms, c) in device.items()
                     if not any(k in n for k in KERNELS)), reverse=True)[:8]
    result.update(
        device_ms=total_ms, idle_share=1.0 - total_ms / result["pass_ms"],
        device_kernels=sum(c for _, c in device.values()),
        kernels_ms_count=mine,
        top_other_ms_count=[[n[:80], ms, c] for ms, n, c in others])


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_pass needs a CUDA device")
    windowed = "--windowed" in sys.argv[1:]
    sphere = "--sphere" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    if sphere:
        inputs, params = make_sphere_problem(**SPHERE_BENCH_SCENE,
                                             device=dev)[:2]
    else:
        inputs, params = make_problem(**BENCH_SCENE, device=dev)[:2]
    geom_inputs = dataclasses.replace(inputs, src_depths=source_depths(
        inputs, params, key_base=2000 if sphere else 1000))
    kind = "sphere " if sphere else ""
    if windowed:
        params = dataclasses.replace(params, rect_ncc=False, fast_ncc=True)
        kind = "windowed "
    d, n = run_patchmatch(inputs, params, 3)[:2]
    cases = [(kind + "photometric", inputs, params, {}),
             (kind + "geometric", geom_inputs,
              params.with_geom(multi_geometry=False),
              dict(seed_normal_world=n, seed_depth=d))]
    results = [timing(*case) for case in cases]
    for r, case in zip(results, cases):
        trace(r, *case[1:])
        print(json.dumps(r), flush=True)
    for r in results:
        print(f"[profile_pass] {r['pass_kind']}: pass {r['pass_ms']:.1f} ms, "
              f"device {r['device_ms']:.1f} ms, idle {r['idle_share']:.3f}, "
              f"stages {r['stages_ms']}", file=sys.stderr)


if __name__ == "__main__":
    main()
