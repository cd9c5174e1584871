"""One run of one benchmark cell: set-up, the measured window, the traced
stretch, the comparison with the reference, and the result line.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<name>.json``, its mix
in ``traffic/<name>.json``, its limits in ``limits/<cell>.json`` and each
metric's reader in ``metrics/<metric>.py`` (a module with ``read(run)``
that returns the value, or None where it finds nothing to read).

The window drives the pipeline's own per-problem call,
``acmmp_spherical_torch.pipeline.pass_runner.process_problem``, on a scene
workspace written under ``TMPDIR``, one call after the other in the
pipeline's pass-major order (every view once per cycle), at the scale the
mix names, set up as ``run_pipeline`` sets up that scale.  Call ``i`` of
the window gets the seed ``(seed + i) mod 2**31``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

from mvsbench import roofline, tracing, workspace
from mvsbench.reference import errors, judge as J

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "acmmp_spherical_tpu")
SEED_SPAN = 2 ** 31          # the program's keys take seeds in [0, 2**31)
WARM_OFFSET = 2 ** 30        # warm calls draw seeds the window never uses
FRESH_SLACK_NS = 50_000_000  # file clocks tick coarser than time_ns


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell and the files found by its names."""

    entry: dict
    config: dict
    traffic: dict
    limits: dict
    metrics: list            # the BENCHMARK.json metric entries it reports


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, trace: bool) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json) with its files and
    the metrics a run of it reports (``per_layer`` when ``trace``)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    section = bench["per_layer" if trace else "end_to_end"]
    return Cell(entry=entry,
                config=load_json(BENCH_DIR / "configs"
                                 / f"{entry['config']}.json"),
                traffic=load_json(BENCH_DIR / "traffic"
                                  / f"{entry['traffic']}.json"),
                limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
                metrics=[m for m in section if applies(m, name)])


def reader(metric: str):
    return importlib.import_module(f"mvsbench.metrics.{metric}")


@dataclasses.dataclass
class CallRecord:
    view: int
    kwargs: dict
    latency_s: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)
    fresh: bool = False
    failed: bool = False
    depth: object = None
    normal: object = None
    cost: object = None
    seed_normal: object = None


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: Cell
    map_hw: tuple = (0, 0)        # (H, W) of the maps at the cell's scale
    n_src: int = 0                # source views per problem
    params: dict = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    depth_err_median: float = float("nan")
    numbers: dict = dataclasses.field(default_factory=dict)  # reference's
    trace: dict = None            # tracing.reduce() of the traced stretch
    traced_calls: list = dataclasses.field(default_factory=list)


class Session:
    """The program, the workspace and the call loop of one run."""

    def __init__(self, cell: Cell, seed: int, device):
        from acmmp_spherical_torch.config import PipelineConfig
        from acmmp_spherical_torch.io.scene import ScenePaths, read_pair_file
        from acmmp_spherical_torch.pipeline import pass_runner
        from acmmp_spherical_torch.pipeline.multiscale import (
            compute_multiscale_settings,
        )

        self.cell, self.device = cell, torch.device(device)
        self.pass_runner = pass_runner
        cfg = PipelineConfig(**cell.config.get("pipeline", {}))
        self.root = Path(tempfile.mkdtemp(prefix="mvsbench-",
                                          dir=os.environ.get("TMPDIR")))
        self.cams, self.sources = workspace.write_scene(
            self.root, cell.config, self.device)
        self.sp = ScenePaths(self.root)
        self.problems = read_pair_file(self.sp.pair_file)
        # the scale as run_pipeline reaches it (main.cpp:392-482)
        max_k = compute_multiscale_settings(self.sp, self.problems, cfg)
        target = max_k if cell.traffic["scale"] == "coarsest" else 0
        for _ in range(max_k, target - 1, -1):
            for p in self.problems:
                if p.num_downscale >= 0:
                    p.cur_image_size = p.max_image_size // (
                        2 ** p.num_downscale)
                    p.num_downscale -= 1
        self.cfg = dataclasses.replace(
            cfg, rect_unify=pass_runner.compute_scene_rect_settings(
                self.sp, self.problems, cfg))
        size = self.problems[0].cur_image_size
        if cell.traffic.get("seed_fields"):
            workspace.write_seed_fields(self.root, self.cams, size,
                                        cell.traffic["seed_fields"], seed,
                                        self.device)
        w, h = workspace.scaled_size(cell.config["width"],
                                     cell.config["height"], size)
        self.map_hw = (h, w)
        self.cycles = cell.traffic["cycles"]
        self.seed_normals = None

    def keep_seed_normals(self) -> None:
        """In a seeded mix, the normals each view's next call starts from
        (``normals.dmb`` as the warm calls left it); every call then keeps
        what it wrote for the next call of its view."""
        if self.cell.traffic.get("seed_fields"):
            self.seed_normals = [
                workspace.read_dmb(self.sp.normal_file(p.ref_image_id))
                for p in self.problems]

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def plan(self, i: int) -> tuple:
        """(view, process_problem keywords) of call ``i``: pass-major order,
        every view once per cycle, the mix's cycles in turn."""
        n = len(self.problems)
        return i % n, self.cycles[(i // n) % len(self.cycles)]

    def outputs(self, view: int, kwargs: dict) -> list:
        pid = self.problems[view].ref_image_id
        return [self.sp.depth_file(pid, geom=bool(kwargs.get("geom"))),
                self.sp.normal_file(pid), self.sp.cost_file(pid)]

    def call(self, i: int, seed: int, *, hook=None, read=True) -> CallRecord:
        """Run call ``i`` of the order with ``seed``; time it, check that it
        rewrote its files and, with ``read``, keep its depth and normal."""
        from acmmp_spherical_torch.utils.log import Timings

        view, kwargs = self.plan(i)
        rec = CallRecord(view=view, kwargs=kwargs)
        if read and self.seed_normals is not None:
            rec.seed_normal = self.seed_normals[view]
        timings = Timings(hook=hook)
        wall_ns = time.time_ns()
        t0 = time.perf_counter()
        try:
            self.pass_runner.process_problem(
                self.sp, self.problems, view, self.cfg, device=self.device,
                timings=timings, seed=seed, **kwargs)
            self.sync()
        except Exception:
            traceback.print_exc(file=sys.stderr)
            rec.failed = True
        rec.latency_s = time.perf_counter() - t0
        rec.spans = dict(timings.totals)
        files = self.outputs(view, kwargs)
        rec.fresh = not rec.failed and all(
            f.exists() and f.stat().st_mtime_ns >= wall_ns - FRESH_SLACK_NS
            for f in files)
        if read and rec.fresh:
            rec.depth = workspace.read_dmb(files[0])
            rec.normal = workspace.read_dmb(files[1])
            rec.cost = workspace.read_dmb(files[2])
            if self.seed_normals is not None:
                self.seed_normals[view] = rec.normal
        return rec


def call_seed(seed: int, i: int) -> int:
    return (seed + i) % SEED_SPAN


def rect_launches() -> int:
    from acmmp_spherical_torch.ops.kernels import _lib

    return sum(v for k, v in _lib.LAUNCHES.items() if k.startswith("rect_ncc"))


def traced_stretch(ses: Session, first: int, n: int, seed: int) -> tuple:
    """Profile ``n`` whole calls from call ``first`` on; retried up to
    twice when the trace holds fewer rect kernels than were launched (the
    profiler has been seen to drop events).  Returns (reduction, calls)."""
    from acmmp_spherical_torch.ops.kernels import _lib

    for _ in range(3):
        recs = []
        marks = tracing.Marks()

        def stretch():
            for k in range(n):
                t = time.time_ns()
                recs.append(ses.call(first + k, call_seed(seed, first + k),
                                     hook=marks, read=False))
                marks.span(tracing.CALL, t)

        _lib.reset_launch_counts()
        red = tracing.reduce(tracing.profile(stretch), marks)
        launched = rect_launches()
        seen = sum(c for k, c in red.get("kernel_count", {}).items()
                   if "rect_ncc" in k)
        print(f"[mvsbench] traced {n} calls: {seen} rect kernels of "
              f"{launched} launched, device time inside the host's window "
              f"{red.get('aligned')}", file=sys.stderr)
        if seen >= launched:
            return red, recs
        first += n
    return red, recs


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda") -> tuple:
    """Run the cell; returns (result object, [(name, value, limit, ok)])."""
    ses = Session(cell, seed, device)
    try:
        return _run(ses, cell, seed, seconds, trace, t_start)
    finally:
        ses.close()


def _run(ses: Session, cell: Cell, seed: int, seconds: float, trace: bool,
         t_start: float) -> tuple:
    cuda = ses.device.type == "cuda"
    run = Run(cell=cell, map_hw=ses.map_hw,
              n_src=cell.config["sources_per_view"],
              params=dataclasses.asdict(ses.cfg.patchmatch))
    # warm every pass kind the mix runs, on view 0
    for k, kwargs in enumerate(ses.cycles):
        i = len(ses.problems) * k
        rec = ses.call(i, (seed + WARM_OFFSET + k) % SEED_SPAN, read=False)
        if rec.failed:
            raise RuntimeError(f"warm call {kwargs} failed")
    ses.keep_seed_normals()
    if cuda:
        torch.cuda.reset_peak_memory_stats(ses.device)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    i = 0
    while True:
        run.calls.append(ses.call(i, call_seed(seed, i)))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(ses.device)
    if trace:
        run.trace, run.traced_calls = traced_stretch(
            ses, i, cell.traffic["trace_calls"], seed)
    judge = J.Judge(ses.cams, ses.sources, ses.root / "images",
                    cell.limits["tau"], seed, ses.device)
    numbers, pooled = judge.judge(
        [dict(view=c.view, depth=c.depth, normal=c.normal, cost=c.cost,
              seed_normal=c.seed_normal, fresh=c.fresh)
         for c in run.calls if not c.failed])
    run.depth_err_median = errors.median(pooled)
    run.numbers = numbers
    checks = J.verdict(numbers, cell.limits)
    print("[mvsbench] reference numbers: " + json.dumps(numbers),
          file=sys.stderr)
    return run, checks


def roofline_seconds(run: Run, calls: list) -> float:
    """The least time of the rect NCC work of ``calls`` (roofline.py)."""
    p = run.params
    taps = len(range(-(p["patch_size"] // 2), p["patch_size"] // 2 + 1,
                     p["radius_increment"])) ** 2
    H, W = run.map_hw
    return sum(roofline.least_seconds(
        H, W, run.n_src, taps, tap_bytes=2 if p["rect_tap_pack"] else 4,
        **roofline.call_shape(c.kwargs, p)) for c in calls)


def result_line(run: Run, checks: list, trace: bool) -> dict:
    metrics = {}
    for m in run.cell.metrics:
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(run.calls)
    failed = sum(1 for c in run.calls if c.failed or not c.fresh)
    device = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
              "kind": torch.cuda.get_device_name(0)
              if torch.cuda.is_available() else "cpu", "count": 1,
              "memory_peak_bytes": run.peak_bytes}
    out = {"correct": failed == 0 and all(ok for *_, ok in checks),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if trace and run.trace:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        ops = sorted(run.trace["kernel_s"].items(), key=lambda kv: -kv[1])
        gaps = sorted(run.trace["idle_by_scope"].items(),
                      key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [[k[:160], v] for k, v in ops[:10]],
                            "idle_gaps": [[k, v] for k, v in gaps[:10]]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim, _ in checks}
    return out
