#!/usr/bin/env python3
"""Time the port's tile-parallel pass against the one-slot pass on the GPU
host: the exact 1024x768x8src photometric pass (``bench.BENCH_SCENE``,
``rect_ncc`` off, 3 iterations) on one slot, then in width tiles over N
slots laid out as ``--layouts`` says:

* ``turn``: N slots of the first card, run in turn as the sharder runs
  its slots;
* ``threads``: the same slots, one host thread each (``run_slots``'
  threads);
* ``spread``: N slots over N cards (N <= the local device count), in turn;
* ``spread_threads``: N slots over N cards, one host thread each.

One JSON line per run: host-clock seconds of a pass after a warm one-slot
pass, each device's peak memory, and whether depth, normal and cost equal
the one-slot pass bit for bit.  The cards' names and power limits come
first.

    python scripts/time_tile_slots.py [--slots 2 3] [--layouts turn threads]
        [--reps 1]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--layouts", nargs="+", default=["turn", "threads"],
                    choices=["turn", "threads", "spread", "spread_threads"])
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()

    import torch

    from acmmp_spherical_torch.bench import BENCH_SCENE, make_problem
    from acmmp_spherical_torch.parallel import tile as T
    from acmmp_spherical_torch.pipeline.patchmatch import run_patchmatch

    if not torch.cuda.is_available():
        print("time_tile_slots: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    n_dev = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    inputs, params, _, _ = make_problem(**BENCH_SCENE, device=dev)
    params = dataclasses.replace(params, rect_ncc=False, rect_init=False,
                                 rect_comp_hw=None, rect_live_n=None,
                                 rect_warp_hw=None)

    class Threaded(T.TiledPass):
        def _run(self, fn, items):
            return T.run_slots(self.mesh, fn, items, threads=True)

    def timed(shard_state):
        for d in range(n_dev):
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        out = run_patchmatch(inputs, params, 16, shard_state=shard_state)
        for d in range(n_dev):
            torch.cuda.synchronize(d)
        return out, time.perf_counter() - t0, [
            torch.cuda.max_memory_allocated(d) for d in range(n_dev)]

    run_patchmatch(inputs, params, 16)      # warm
    ref, one_s, one_mem = timed(None)
    print(json.dumps(dict(slots=1, layout="one slot", pass_s=one_s,
                          peak_mem_bytes=one_mem)), flush=True)
    for n in args.slots:
        for layout in args.layouts:
            spread = layout.startswith("spread")
            if spread and n > n_dev:
                continue
            mesh = T.make_tile_mesh(n, devices=None if spread else [dev])
            if layout.endswith("threads"):
                make = lambda i, p, mesh=mesh: Threaded(mesh, i, p)
            else:
                make = T.make_state_sharder(mesh)
            for _ in range(args.reps):
                out, s, mem = timed(make)
                same = all(torch.equal(a.to(dev), b)
                           for a, b in zip(out[:3], ref[:3]))
                print(json.dumps(dict(
                    slots=n, layout=layout,
                    devices=[str(d) for d in mesh.devices], pass_s=s,
                    peak_mem_bytes=mem, bit_identical=same)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
