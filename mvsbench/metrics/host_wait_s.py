"""Seconds per map in the program's ``fetch`` spans: the copies of the
fields to the host inside ``prior_build`` and ``write``, where the host
waits for the device's queue to drain; from the ``Timings`` of the
window's calls, nothing where the program opens no such span."""


def read(run):
    v = [c.spans["fetch"] for c in run.calls
         if not c.failed and "fetch" in c.spans]
    return sum(v) / len(v) if v else None
