"""The control on the card at a size a test run holds: a small pinhole
prior cell on the rectified path comes out correct, and not correct with
the source taps in fp8 (``faults.fp8_taps``).

    python -m pytest -q -p no:cacheprovider -m gpu \
        mvsbench/tests/test_mvsbench_control.py

The cells' own readings of the control, at their sizes, come from
``python3 mvsbench/control.py --fault fp8_taps`` (PERF.md).  The limits
here are this size's own.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import pytest
import torch

from mvsbench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
LIMITS = {"tau": 0.005, "limits": {"err_med": 0.01, "cost_excess": 0.02,
                                   "stale": 0}}


def small_cell() -> harness.Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, "dtu_pinhole.prior", False)
    cfg = dict(cell.config, width=640, height=480, views=4,
               sources_per_view=3, ring={"focal": 576.0, "radius": 0.25})
    return harness.Cell(entry=cell.entry, config=cfg, traffic=cell.traffic,
                        limits=LIMITS, metrics=cell.metrics)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["none", "fp8_taps"])
def test_control_fails_where_the_program_passes(fault, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plant = (contextlib.nullcontext() if fault == "none"
             else faults.FAULTS[fault]())
    with plant:
        run, checks = harness.run_cell(small_cell(), seed, 3.0, False,
                                       time.perf_counter())
    line = harness.result_line(run, checks, False)
    assert line["correct"] == (fault == "none"), run.numbers
