"""The 90th percentile of the window's per-call latencies (host clock
around each ``process_problem`` call, ended by a device synchronise),
linear between order statistics as numpy's ``percentile`` takes it."""

import numpy as np


def read(run):
    lat = [c.latency_s for c in run.calls if not c.failed]
    return float(np.percentile(lat, 90)) if len(lat) >= 10 else None
