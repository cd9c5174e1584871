"""Seconds per map in the passes themselves: each call's latency less its
``load``, ``prior_build`` and ``write`` scopes (the pass driver, context
build, init, half-step glue and kernels, and the prior round)."""

OUTSIDE = ("load", "prior_build", "write")


def read(run):
    v = [c.latency_s - sum(c.spans.get(k, 0.0) for k in OUTSIDE)
         for c in run.calls if not c.failed]
    return sum(v) / len(v) if v else None
