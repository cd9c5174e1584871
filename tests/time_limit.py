"""A time limit of its own for every test (tests/conftest.py imports the hook).

``pytest_runtest_protocol`` arms a SIGALRM timer of ``LIMIT_S`` seconds
around a test's setup, call and teardown.  If it fires, every thread's
stack goes to stderr (the test's captured output) and the test fails with
a message that names the limit; the run goes on with the next test.  The
limit is twice the 600 s that the slowest test of the fast suite,
test_torch_pipeline.py (the port's own work), ran past under the fast
suite's 6-worker command on a loaded 8-core CPU; the same test took 311-401
s in other such runs and 665 s alone.  So no honest test comes near it, and
a test that hangs early in a run costs its own limit rather than the whole
run's.  A test that hangs later than the run's own limit less this one is
still cut with the run.

The signal reaches Python code only: a test stuck inside one C call (an
XLA compile, a torch op) fails once that call returns.  Under xdist each
worker runs its tests in its main thread, where the signal is delivered.
"""

from __future__ import annotations

import faulthandler
import signal
import sys
import threading

import pytest

LIMIT_S = 1200


def _expired(signum, frame):
    faulthandler.dump_traceback(sys.__stderr__, all_threads=True)
    pytest.fail(f"the test ran past its time limit of {LIMIT_S} s "
                f"(tests/time_limit.py LIMIT_S)")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    previous = signal.signal(signal.SIGALRM, _expired)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
