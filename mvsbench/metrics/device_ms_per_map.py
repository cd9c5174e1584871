"""Milliseconds of device activity per map over the traced stretch (the
union of kernel, copy and set intervals, over the calls traced)."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["calls"]
