"""Tracing and timing utilities (counterpart of
acmmp_spherical_tpu/utils/profiling.py).

The reference's only instrumentation is one cudaEvent timer around the JBU
kernel (ACMMP.cu:1631-1648).  Here:

* :func:`trace` wraps a scope in a ``torch.profiler`` trace of the host and,
  where there is one, the CUDA device, exported as a Chrome trace (viewable
  in Perfetto);
* :class:`SpanClock`, a ``Timings`` hook, keeps each span's interval on
  the host's wall clock (``time.time_ns``), the clock the profiler puts
  its events on;
* :func:`device_activity` reads a CUDA trace's device activity and the
  host times of the runtime calls that launched it, joined by the CUDA
  correlation id, and :func:`by_span` puts each activity down to the
  innermost span open at its launch.

The JAX package's ``compiled_stats`` reads XLA's cost model of a compiled
program; eager PyTorch has no such model, so it is not ported.
"""

from __future__ import annotations

import contextlib
import pathlib
import threading
import time

import torch

UNATTRIBUTED = "unattributed"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the scope and write ``<log_dir>/trace.json``; yields the
    profiler (``key_averages()`` for sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


class SpanClock:
    """A ``Timings`` hook: ``spans`` holds ``(name, start_ns, end_ns)`` of
    every scope that closed, on ``time.time_ns``.  Open scopes are keyed
    by thread and name, so the slots' threads may open the same name at
    once."""

    def __init__(self):
        self.spans: list = []
        self._open: dict = {}

    def __call__(self, name: str, opened: bool) -> None:
        key = (threading.get_ident(), name)
        if opened:
            self._open[key] = time.time_ns()
        else:
            self.spans.append((name, self._open.pop(key), time.time_ns()))


def device_activity(prof) -> tuple:
    """The device activity of a finished ``torch.profiler`` trace with
    CUDA activity: ``(device, launches)``, ``device`` as ``(name, start_ns,
    end_ns, correlation_id)`` of every kernel, copy and set, ``launches``
    as {correlation_id: earliest host start_ns} of the host's events that
    carry one: the runtime and driver calls (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ``cudaGraphLaunch``, ...) and what they start."""
    cuda = torch.autograd.DeviceType.CUDA
    device, launches = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            device.append((ev.name(), ev.start_ns(), ev.end_ns(),
                           ev.correlation_id()))
        elif ev.correlation_id():
            t = launches.get(ev.correlation_id())
            launches[ev.correlation_id()] = (ev.start_ns() if t is None
                                             else min(t, ev.start_ns()))
    return device, launches


def by_span(device: list, launches: dict, spans: list) -> dict:
    """Device activity by the innermost span open at its launch:
    ``device_s`` and ``count`` by span name, and ``attributed``, the share
    of device time put down to a span.  Activity whose correlation id has
    no launch, or launched while no span was open, goes under
    ``UNATTRIBUTED``.  ``device``, ``launches`` as :func:`device_activity`
    gives them; ``spans``: ``(name, start_ns, end_ns)``."""
    opened = sorted(spans, key=lambda s: s[1])
    timed = sorted((launches.get(corr), end - start)
                   for _, start, end, corr in device
                   if corr in launches)
    device_s = {UNATTRIBUTED: 1e-9 * sum(
        end - start for _, start, end, corr in device
        if corr not in launches)}
    count = {UNATTRIBUTED: sum(1 for *_, corr in device
                               if corr not in launches)}
    active, k = [], 0
    for t, dur in timed:
        while k < len(opened) and opened[k][1] <= t:
            active.append(opened[k])
            k += 1
        active = [s for s in active if s[2] >= t]
        name = active[-1][0] if active else UNATTRIBUTED
        device_s[name] = device_s.get(name, 0.0) + 1e-9 * dur
        count[name] = count.get(name, 0) + 1
    total = sum(device_s.values())
    return {"device_s": device_s, "count": count,
            "attributed": (1.0 - device_s[UNATTRIBUTED] / total
                           if total > 0 else 0.0)}
