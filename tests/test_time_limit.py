"""tests/time_limit.py: a test that runs past its limit fails with the
limit's message, every thread's stack is printed, and the run goes on.

A tiny file runs in its own pytest process under the limit lowered to 1 s
(in that process only, without the installed plugins, which take seconds
to load): its first test sleeps for 30 s, its second passes.
"""

import os
import pathlib
import subprocess
import sys
import textwrap
import time

TESTS = pathlib.Path(__file__).resolve().parent


def test_a_test_past_its_limit_fails_and_the_next_runs(tmp_path):
    (tmp_path / "conftest.py").write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(TESTS)!r})
        import time_limit
        time_limit.LIMIT_S = 1
        from time_limit import pytest_runtest_protocol
    """))
    (tmp_path / "test_tiny.py").write_text(textwrap.dedent("""
        import time

        def test_sleeps_past_the_limit():
            time.sleep(30)

        def test_runs_after():
            assert True
    """))
    t0 = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "--rootdir", str(tmp_path), str(tmp_path)], cwd=tmp_path,
        env=dict(os.environ, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1"),
        capture_output=True, text=True, timeout=60)
    elapsed = time.monotonic() - t0
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert "ran past its time limit of 1 s" in out, out
    assert "most recent call first" in out, out       # faulthandler's stacks
    assert "test_sleeps_past_the_limit" in out, out
    assert elapsed < 20, elapsed
