"""The device's idle share over the traced stretch of whole calls:
1 - (union of device activity) / (the stretch's wall time), both from one
torch.profiler trace."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
