"""The cell ``eth3d_pinhole.hierarchy`` on the CPU: it finds its files, a
small run of it is correct, the faults of ``faults.py`` planted under it
make it not correct, and the prior build's span readers read what they
should.

    python -m pytest -q -p no:cacheprovider mvsbench/tests/test_mvsbench_hierarchy.py

About a minute in one process on eight cores (xdist workers that each
take every core oversubscribe the CPU many times over).  The small run is
the cell's mix and configuration at 96x64 (3 views, 2 sources, the
rectified path on the kernels' plain versions) with the seed's depth
perturbed by 30% in place of 1%: at this size 1% moves a disparity by ~0.05
px, which the hierarchy pass's commit guard never acts on, so the pass
returns its seed and a no-op reads like it.  The limits are this size's
own (CPU runs: the sound run's window call reads ``err_med`` 0.0030,
``no_op`` 0.018, ``half_left_out`` 0.015, ``answer_altered`` 0.02); the
cell's limits on the card are in ``limits/eth3d_pinhole.hierarchy.json``.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import pytest

from mvsbench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "eth3d_pinhole.hierarchy"
SEED = 2 ** 31 + 19
LIMITS = {"tau": 0.005, "limits": {"err_med": 0.006, "cost_excess": 0.006,
                                   "stale": 0}}
PRIOR_SPANS = {"prior_support_s": "support", "prior_raster_s": "raster",
               "prior_draw_s": "draw"}


def test_cell_finds_its_files():
    for trace in (False, True):
        cell = harness.find_cell(BENCH, CELL, trace)
        assert cell.config["name"] == "eth3d_pinhole"
        assert cell.traffic["name"] == "hierarchy"
        assert cell.traffic["cycles"] == [{"hierarchy": True,
                                           "planar_prior": True}]
        assert set(cell.limits["limits"]) >= {"err_med", "cost_excess",
                                              "stale"}
        names = {m["name"] for m in cell.metrics}
        if trace:
            assert set(PRIOR_SPANS) <= names
            assert "rect_ncc_roofline" in names
        else:
            assert {"depth_maps_per_s", "setup_s",
                    "peak_mem_gib"} <= names
            assert "map_p90_s" not in names
        for m in cell.metrics:
            assert callable(harness.reader(m["name"]).read)


def small_cell() -> harness.Cell:
    cell = harness.find_cell(BENCH, CELL, False)
    cfg = dict(cell.config, width=96, height=64, views=3, sources_per_view=2,
               ring={"focal": 54.0, "radius": 0.25},
               pipeline={"rect_ncc": "on"})
    traffic = dict(cell.traffic, seed_fields={"depth_perturbation": 0.3})
    return harness.Cell(entry=cell.entry, config=cfg, traffic=traffic,
                        limits=LIMITS, metrics=cell.metrics)


@pytest.mark.parametrize("fault", ["none", "no_op", "half_left_out",
                                   "answer_altered"])
def test_small_run_and_faults(fault):
    plant = (contextlib.nullcontext() if fault == "none"
             else faults.answer_altered(nth=2) if fault == "answer_altered"
             else faults.FAULTS[fault]())
    with plant:
        run, checks = harness.run_cell(small_cell(), SEED, 0.5, False,
                                       time.perf_counter(), device="cpu")
    line = harness.result_line(run, checks, False)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["correct"] == (fault == "none"), (fault, run.numbers)


def _run_with(spans: list) -> harness.Run:
    calls = [harness.CallRecord(view=i, kwargs={}, latency_s=1.0, spans=s)
             for i, s in enumerate(spans)]
    return harness.Run(cell=None, calls=calls)


@pytest.mark.parametrize("metric", sorted(PRIOR_SPANS))
def test_prior_span_readers(metric):
    read = harness.reader(metric).read
    span = PRIOR_SPANS[metric]
    assert read(_run_with([])) is None
    assert read(_run_with([{"prior_build": 1.0, "fetch": 0.1}] * 2)) is None
    got = read(_run_with([{span: 0.5, "prior_build": 2.0}, {span: 1.5}]))
    assert got == pytest.approx(1.0)
    failed = _run_with([{span: 0.5}, {span: 9.0}])
    failed.calls[1].failed = True
    assert read(failed) == pytest.approx(0.5)
