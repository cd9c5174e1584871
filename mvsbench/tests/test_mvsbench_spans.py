"""The readers of the program's spans inside the pass and of the traced
stretch's activity count: each returns None where it finds nothing (a
program without the span, a run without a trace) and the mean per call,
or per traced call, where it does.

    python -m pytest -q -p no:cacheprovider mvsbench/tests/test_mvsbench_spans.py
"""

from __future__ import annotations

import pytest

from mvsbench import harness

SPANS = {"context_s": "context", "halfstep_s": "halfstep",
         "host_wait_s": "fetch"}


def run_with(spans: list, trace=None) -> harness.Run:
    calls = [harness.CallRecord(view=i, kwargs={}, latency_s=1.0, spans=s)
             for i, s in enumerate(spans)]
    return harness.Run(cell=None, calls=calls, trace=trace)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_readers(metric):
    read = harness.reader(metric).read
    span = SPANS[metric]
    assert read(run_with([])) is None
    assert read(run_with([{"load": 0.2, "write": 0.1}] * 3)) is None
    got = read(run_with([{span: 0.25, "load": 0.5}, {span: 0.75}]))
    assert got == pytest.approx(0.5)
    failed = run_with([{span: 0.25}, {span: 9.0}])
    failed.calls[1].failed = True
    assert read(failed) == pytest.approx(0.25)


def test_launches_per_map():
    read = harness.reader("launches_per_map").read
    assert read(run_with([{}])) is None
    assert read(run_with([{}], trace={})) is None
    empty = {"calls": 2, "kernel_count": {}, "busy_s": 0.0}
    assert read(run_with([{}], trace=empty)) is None
    trace = {"calls": 2, "kernel_count": {"rect_ncc": 26, "Memcpy HtoD": 4,
                                          "Memset": 2}}
    assert read(run_with([{}], trace=trace)) == 16.0
