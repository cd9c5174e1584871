"""Tracing and timing utilities (counterpart of
acmmp_spherical_tpu/utils/profiling.py).

The reference's only instrumentation is one cudaEvent timer around the JBU
kernel (ACMMP.cu:1631-1648).  Here:

* :func:`trace` wraps a scope in a ``torch.profiler`` trace of the host and,
  where there is one, the CUDA device, exported as a Chrome trace (viewable
  in Perfetto);
* :func:`time_fn` measures the steady-state wall clock of a callable,
  fenced with ``torch.cuda.synchronize`` on a CUDA device, with the first
  call apart.

The JAX package's ``compiled_stats`` reads XLA's cost model of a compiled
program; eager PyTorch has no such model, so it is not ported.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Callable

import torch


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


def time_fn(fn: Callable, args: tuple = (), *, reps: int = 3,
            warmup: int = 1, device=None) -> dict[str, float]:
    """Steady-state wall clock of ``fn(*args)``: ``first_s`` (the warm-up
    calls), ``best_s`` and ``mean_s`` over ``reps`` calls, each fenced with
    a synchronise of ``device`` when it is a CUDA device."""
    device = torch.device(device) if device is not None else None
    sync = ((lambda: torch.cuda.synchronize(device))
            if device is not None and device.type == "cuda" else lambda: None)
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn(*args)
    sync()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return {"first_s": first, "best_s": min(times),
            "mean_s": sum(times) / len(times)}
