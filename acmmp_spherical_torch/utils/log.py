"""Structured logging and wall-clock scopes (counterpart of
acmmp_spherical_tpu/utils/log.py): every pass logs through the standard
logging module, with per-scope timings the pipeline reports at its end."""

from __future__ import annotations

import contextlib
import logging
import time

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    """A logger under the root configuration (INFO, one line per record),
    which ``basicConfig`` sets up on first use unless the program did."""
    logging.basicConfig(level=logging.INFO, format=_FORMAT)
    return logging.getLogger(name)


class Timings:
    """Accumulates named wall-clock durations (seconds).

    ``hook``, when given, is called as ``hook(name, True)`` as each scope
    opens and ``hook(name, False)`` as it closes (after its time is
    recorded), so a caller can take its own readings per scope.  Seconds
    added to ``excluded_s`` while a scope is open are left out of it."""

    def __init__(self, hook=None):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.hook = hook
        self.excluded_s = 0.0

    @contextlib.contextmanager
    def scope(self, name: str):
        if self.hook is not None:
            self.hook(name, True)
        t0, x0 = time.perf_counter(), self.excluded_s
        try:
            yield
        finally:
            dt = time.perf_counter() - t0 - (self.excluded_s - x0)
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if self.hook is not None:
                self.hook(name, False)

    def summary(self) -> str:
        return ", ".join(
            f"{k}={v:.3f}s/{self.counts[k]}"
            for k, v in sorted(self.totals.items()))
