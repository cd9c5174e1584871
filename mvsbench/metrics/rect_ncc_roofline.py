"""The rect NCC kernels' share of their roofline, in %: the least time of
the NCC work the traced calls need (``mvsbench/roofline.py``, counted from
the algorithm at the calls' shapes) over the device time of the kernels
named ``rect_ncc*`` in the trace.  Nothing where no such kernel ran."""

from mvsbench.harness import roofline_seconds


def read(run):
    t = run.trace
    if not t:
        return None
    measured = sum(v for k, v in t["kernel_s"].items() if "rect_ncc" in k)
    if measured <= 0:
        return None
    return 100.0 * roofline_seconds(run, run.traced_calls) / measured
