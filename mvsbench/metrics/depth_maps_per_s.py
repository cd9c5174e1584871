"""Depth maps per second: the window's completed ``process_problem`` calls
over the window's wall time (all the work over all the time)."""


def read(run):
    done = sum(1 for c in run.calls if not c.failed)
    return done / run.window_s if run.window_s > 0 else None
