"""Structured logging and wall-clock scopes (counterpart of
acmmp_spherical_tpu/utils/log.py): every pass logs through the standard
logging module, with per-scope timings the pipeline reports at its end.

The pass runner, and each slot thread of the batched one, make their
``Timings`` current for the calling thread (``Timings.current``); code
below them opens its scopes with :func:`span`, which does nothing where
no ``Timings`` is current."""

from __future__ import annotations

import contextlib
import logging
import threading
import time

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_CURRENT = threading.local()


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
    added to ``excluded_s`` while a scope is open are left out of it.
    Scopes may open in several threads at once (the batched pass runner's
    loader and slots); each records its own duration."""

    def __init__(self, hook=None):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.hook = hook
        self.excluded_s = 0.0
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def scope(self, name: str):
        if self.hook is not None:
            self.hook(name, True)
        t0, x0 = time.perf_counter(), self.excluded_s
        try:
            yield
        finally:
            dt = time.perf_counter() - t0 - (self.excluded_s - x0)
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1
            if self.hook is not None:
                self.hook(name, False)

    @contextlib.contextmanager
    def current(self):
        """Make this ``Timings`` the calling thread's current one for the
        ``with`` block (the one it replaces is current again after it)."""
        prev = getattr(_CURRENT, "timings", None)
        _CURRENT.timings = self
        try:
            yield self
        finally:
            _CURRENT.timings = prev

    def summary(self) -> str:
        return ", ".join(
            f"{k}={v:.3f}s/{self.counts[k]}"
            for k, v in sorted(self.totals.items()))


@contextlib.contextmanager
def span(name: str):
    """``scope(name)`` of the calling thread's current ``Timings``; nothing
    where none is current.  A span never opens inside a span of the same
    name (a hook may key its open scopes by name)."""
    timings = getattr(_CURRENT, "timings", None)
    if timings is None:
        yield
        return
    with timings.scope(name):
        yield
