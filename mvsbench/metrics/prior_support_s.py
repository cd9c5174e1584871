"""Seconds per map in the program's ``support`` spans (the prior build's
support points: the minimum-cost pixel of every 5x5 cell), from the
``Timings`` of the window's calls; nothing where the program opens no
such span."""


def read(run):
    v = [c.spans["support"] for c in run.calls
         if not c.failed and "support" in c.spans]
    return sum(v) / len(v) if v else None
