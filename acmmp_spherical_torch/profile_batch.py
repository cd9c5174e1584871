"""Where a batched pipeline run's host time goes on one GPU: the slot
threads against the loader thread.

    python -m acmmp_spherical_torch.profile_batch [--slots 3]

On the pinhole ring of ``chip_smoke.py`` phase 9 (CubeRoom, 1600x1200, 8
views, ``PipelineConfig`` defaults) it runs ``run_pipeline`` on a fresh
copy of the scene for each of these runs, in this order:

* ``serial``: ``batch_problems="off"``;
* ``slots_loader``: batched over ``--slots`` slots of the one card, the
  next chunk loading on the prefetch thread (phase 12's timed run);
* ``slots_no_loader``: the same with the prefetch thread bypassed, each
  chunk loaded on the calling thread when it is needed;
* ``one_slot_loader``: batched over one slot, the prefetch thread on;
* ``serial_2``: the serial run again, for the machine's drift.

For each run it prints one JSON line: the wall time; the process's CPU
time over all its threads and its ratio to the wall time; the pass-kind,
``load``, ``load_wait``, ``prior_build`` and ``write`` scopes; and the lag
of an interpreter-lock probe: a thread that sleeps 1 ms in a loop and
records how late it wakes.  A thread waking while another runs Python
waits for the lock up to the switch interval (``sys.getswitchinterval()``,
5 ms), so the share of wakes more than 1 ms late estimates the share of
the time some thread held the lock.  Every batched run's files must equal
the first serial run's byte for byte.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import json
import pathlib
import shutil
import sys
import tempfile
import threading
import time

import torch

from acmmp_spherical_torch.config import PipelineConfig
from acmmp_spherical_torch.ops.kernels import _lib
from acmmp_spherical_torch.parallel.mesh import make_view_mesh
from acmmp_spherical_torch.pipeline import batch_runner, multiscale
from acmmp_spherical_torch.utils.log import Timings
from acmmp_spherical_torch.utils.synthetic import (
    CubeRoom, make_ring_of_cameras, render_scene,
    write_synthetic_scene_to_disk,
)

# chip_smoke.py phase 9's scene
SCENE = dict(n_views=8, width=1600, height=1200, focal=1440.0, radius=0.25)
PROBE_SLEEP_S = 1e-3
LATE_S = 1e-3


@contextlib.contextmanager
def lock_probe():
    """Yield a dict that, once the scope ends, holds the probe's wakes, mean
    lag and share of wakes later than ``LATE_S``."""
    lags: list = []
    stop = threading.Event()

    def run():
        while not stop.is_set():
            t0 = time.perf_counter()
            time.sleep(PROBE_SLEEP_S)
            lags.append(time.perf_counter() - t0 - PROBE_SLEEP_S)

    out: dict = {}
    t = threading.Thread(target=run, name="lock-probe", daemon=True)
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()
        n = max(len(lags), 1)
        out.update(wakes=len(lags), mean_lag_ms=1e3 * sum(lags) / n,
                   late_share=sum(x > LATE_S for x in lags) / n)


@contextlib.contextmanager
def loader_bypassed():
    """Load each chunk on the calling thread when it is needed."""
    kept = batch_runner._prefetched
    batch_runner._prefetched = lambda it, **kw: it
    try:
        yield
    finally:
        batch_runner._prefetched = kept


def differing_files(a: pathlib.Path, b: pathlib.Path) -> list:
    fa = {p.relative_to(a) for p in (a / "ACMMP").rglob("*") if p.is_file()}
    fb = {p.relative_to(b) for p in (b / "ACMMP").rglob("*") if p.is_file()}
    return sorted({str(f) for f in fa ^ fb} | {
        str(f) for f in fa & fb
        if not filecmp.cmp(a / f, b / f, shallow=False)})


def run(name: str, root: pathlib.Path, dev, mesh=None, loader=True) -> dict:
    cfg = PipelineConfig(batch_problems="off" if mesh is None else "on")
    timings = Timings()
    with contextlib.ExitStack() as stack:
        if not loader:
            stack.enter_context(loader_bypassed())
        probe = stack.enter_context(lock_probe())
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        n_points = multiscale.run_pipeline(root, cfg, device=dev, mesh=mesh,
                                           timings=timings)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        cpu_s = time.process_time() - c0
    return dict(run=name, slots=None if mesh is None else mesh.size,
                loader=loader if mesh is not None else None, wall_s=wall_s,
                cpu_s=cpu_s, cpu_per_wall=cpu_s / wall_s,
                fused_points=n_points, scopes_s=timings.totals,
                lock_probe=probe)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_batch")
    ap.add_argument("--slots", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_batch: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _lib.library()   # the kernels' build stays out of the first run
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        cams = make_ring_of_cameras(
            SCENE["n_views"], focal=SCENE["focal"], radius=SCENE["radius"],
            width=SCENE["width"], height=SCENE["height"], device="cpu")
        images, _, _ = render_scene(cams, CubeRoom(), SCENE["width"],
                                    SCENE["height"])
        write_synthetic_scene_to_disk(work / "input", cams, images)
        runs = [("serial", None, True),
                ("slots_loader", args.slots, True),
                ("slots_no_loader", args.slots, False),
                ("one_slot_loader", 1, True),
                ("serial_2", None, True)]
        ref = None
        for name, slots, loader in runs:
            root = work / name
            shutil.copytree(work / "input", root)
            mesh = (None if slots is None
                    else make_view_mesh(devices=[dev] * slots))
            out = run(name, root, dev, mesh, loader)
            if ref is None:
                ref = root
            else:
                out["files_differ"] = differing_files(ref, root)
                shutil.rmtree(root)
            print(json.dumps(out), flush=True)
            if out.get("files_differ"):
                print(f"profile_batch: {name}'s files differ from the serial "
                      "run's", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
