"""Device activities (kernels, copies and sets) per map over the traced
stretch, counted on the device's side of the trace, so that the kernels of
a replayed CUDA graph count one by one."""


def read(run):
    t = run.trace
    if not t or not t["calls"]:
        return None
    n = sum(t["kernel_count"].values())
    return n / t["calls"] if n else None
