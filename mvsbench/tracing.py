"""The traced stretch of a ``--trace 1`` run: whole calls under
``torch.profiler`` with CUDA activity alone, reduced to device busy time,
idle gaps by the host scope that was open, and device time by kernel.

Host activity is not traced: recording every host op made the
launch-bound calls some 40% slower (PR 16), which read as device idle
time.  The host's calls and pass runner scopes are marked instead on the
host's wall clock (``time.time_ns``), the clock the profiler converts its
device timestamps to, and each idle gap is put down to the innermost
scope open at its middle.
"""

from __future__ import annotations

import time

import torch

CALL = "call"


class Marks:
    """Host intervals on the wall clock: ``span(name, start_ns)`` closes
    an interval the caller opened, and the instance itself is a
    ``Timings`` hook for the pass runner's scopes."""

    def __init__(self):
        self.spans: list = []      # (name, start_ns, end_ns)
        self._open: dict = {}

    def __call__(self, name: str, opened: bool) -> None:
        if opened:
            self._open[name] = time.time_ns()
        else:
            self.span(name, self._open.pop(name))

    def span(self, name: str, start_ns: int) -> None:
        self.spans.append((name, start_ns, time.time_ns()))


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(device: list, marks: Marks) -> dict:
    """Busy and idle time of the stretch: ``window_s`` (first call's start
    to last call's end), ``busy_s`` (the union of device activity inside
    it), ``calls``, ``kernel_s`` and ``kernel_count`` by name,
    ``idle_by_scope`` (idle seconds by the innermost host scope open at
    each gap's middle: a pass runner scope, else ``pass``) and
    ``aligned`` (the share of device time inside the window: below 1 the
    two clocks disagree).  ``device``: ``(name, start_ns, end_ns)``."""
    calls = [(s, e) for n, s, e in marks.spans if n == CALL]
    scopes = [(s, e, n) for n, s, e in marks.spans if n != CALL]
    if not calls:
        return {}
    t0 = min(s for s, _ in calls)
    t1 = max(e for _, e in calls)
    kernel_s, kernel_count = {}, {}
    inside, total = [], 0
    for name, s, e in device:
        total += e - s
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-9
        kernel_count[name] = kernel_count.get(name, 0) + 1
        s, e = max(s, t0), min(e, t1)
        if e > s:
            inside.append((s, e))
    busy = _union(inside)
    idle = {}
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        best = None
        for s, e, name in scopes:
            if s <= mid <= e and (best is None or s > best[0]):
                best = (s, name)
        label = best[1] if best is not None else "pass"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return {"window_s": (t1 - t0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "calls": len(calls), "kernel_s": kernel_s,
            "kernel_count": kernel_count, "idle_by_scope": idle,
            "aligned": (sum(e - s for s, e in inside) / total
                        if total else 1.0)}


def profile(fn) -> list:
    """Run ``fn()``, which ends in a device synchronise, under the
    profiler; returns the device events as ``(name, start_ns, end_ns)``,
    read from the profiler's raw results."""
    if not torch.cuda.is_available():
        fn()
        return []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.name(), ev.start_ns(), ev.end_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda]
