"""The comparison that decides ``correct``, with the timed path broken
underneath: a run of a small cell on the CPU (the harness's look for a
chip skipped, the kernels' plain versions on the exact path) comes out
correct, and comes out not correct with each fault of ``faults.py``
planted, and with the control.

    python -m pytest -q -p no:cacheprovider mvsbench/tests/test_mvsbench_faults.py

About four minutes on eight cores.  The limits here are this size's own
(readings of the sound run on the CPU, with room); the cells' limits on
the card are in ``limits/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import pytest

from mvsbench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 77
# sound readings at this size (my CPU runs): err_med 0.0016, bad_share
# 0.050, cost_excess 7e-6; the control and the faults read 0.01 or more
LIMITS = {"tau": 0.005, "limits": {"err_med": 0.005, "bad_share": 0.15,
                                   "cost_excess": 0.005, "stale": 0}}


def small_cell(workload: str) -> harness.Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, workload, False)
    cfg = dict(cell.config, width=64, height=48, views=3, sources_per_view=2,
               ring={"focal": 57.6, "radius": 0.25})
    return harness.Cell(entry=cell.entry, config=cfg, traffic=cell.traffic,
                        limits=LIMITS, metrics=cell.metrics)


def run_small(fault: str):
    cell = small_cell("dtu_pinhole.prior")
    plant = (contextlib.nullcontext() if fault == "none"
             else faults.answer_altered(nth=2) if fault == "answer_altered"
             else faults.FAULTS[fault]())
    with plant:
        run, checks = harness.run_cell(cell, SEED, 0.5, False,
                                       time.perf_counter(), device="cpu")
    return harness.result_line(run, checks, False), run


def test_sound_run_is_correct():
    line, run = run_small("none")
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("fault", ["fp8_taps", "no_op", "half_left_out",
                                   "answer_altered"])
def test_fault_is_not_correct(fault):
    line, run = run_small(fault)
    assert not line["correct"], (fault, run.numbers)
