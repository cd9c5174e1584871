"""Where the time of a pass goes on the GPU: stage times and device time.

    python -m acmmp_spherical_torch.profile_pass [--windowed | --sphere]
        [--prescreen]

On the bench scene (CubeRoom 1024x768x8src, rectified path) it runs the
photometric pass and the geometric pass seeded from it (source depths from
the 8 views' own photometric passes, as the bench); with ``--windowed`` the
same two passes on the windowed path (``rect_ncc`` off, ``fast_ncc`` on,
the geometric pass seeded from the windowed photometric one); with
``--sphere`` the two passes of the sphere bench scene (equirect CubeRoom
1024x512x6src, pole-rotated path; source depths from keys 2000 + i).
``--prescreen`` turns ``rect_prescreen`` on in both passes (the candidates
ranked at the coarse tap pattern; it acts on the rectified paths only).
For each it prints:

* the pass time (host clock, mean of 3 passes after a warm one) and, from
  the same passes, the host time in each of the program's spans
  (``stages_ms``: ``context``, ``init``, ``halfstep``, ``cost``, ``rng``,
  ``extract``; a span's time includes its children's, and the host runs
  ahead of the device, so a span's host time is its launch time unless it
  waits);
* under ``torch.profiler`` over one more pass: the device time of all
  kernels, the idle share (1 - device time / unprofiled pass time: two
  different runs, so approximate), the number of device kernels, the
  device time and count of each hand-written kernel and of the 8 largest
  other kernels, and the device time and activity count by the innermost
  span open at each activity's launch (``stages_device_ms``,
  ``stages_activities``; ``attributed``: the share of device time put down
  to a span).

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
from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch
from acmmp_spherical_torch.utils.log import Timings
from acmmp_spherical_torch.utils.profiling import (
    SpanClock, by_span, device_activity,
)

KERNELS = ("rect_ncc_kernel", "warp_transport_kernel", "warp_src_kernel",
           "warp_disp_kernel", "ncc_window_kernel")


def timing(kind, inputs, params, seeds, reps=3):
    """Pass times and the host time of each span of one pass kind: a warm
    pass, then ``reps`` passes under a current ``Timings``."""
    run_patchmatch(inputs, params, 0, **seeds)
    torch.cuda.synchronize()
    walls, spans = [], []
    for r in range(reps):
        timings = Timings()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timings.current():
            run_patchmatch(inputs, params, r + 1, **seeds)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        spans.append(timings.totals)
    return dict(
        pass_kind=kind, card=torch.cuda.get_device_name(0),
        stages_ms={k: 1e3 * sum(s.get(k, 0.0) for s in spans) / reps
                   for k in spans[0]},
        pass_ms=1e3 * sum(walls) / reps, pass_s=walls)


def trace(result, inputs, params, seeds):
    """Add the device time of one traced pass to ``timing``'s result (the
    device activity alone is recorded), in all, by kernel and by the span
    that launched it."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    clock = SpanClock()
    with torch.profiler.profile(activities=acts) as prof:
        with Timings(hook=clock).current():
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
    spans = by_span(*device_activity(prof), clock.spans)
    result.update(
        device_ms=total_ms, idle_share=1.0 - total_ms / result["pass_ms"],
        device_kernels=sum(c for _, c in device.values()),
        kernels_ms_count=mine,
        top_other_ms_count=[[n[:80], ms, c] for ms, n, c in others],
        stages_device_ms={k: 1e3 * v for k, v in spans["device_s"].items()},
        stages_activities=spans["count"], attributed=spans["attributed"])


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_pass needs a CUDA device")
    windowed = "--windowed" in sys.argv[1:]
    sphere = "--sphere" in sys.argv[1:]
    prescreen = "--prescreen" in sys.argv[1:]
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
    if prescreen:
        params = dataclasses.replace(params, rect_prescreen=True)
        kind = "prescreen " + kind
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
