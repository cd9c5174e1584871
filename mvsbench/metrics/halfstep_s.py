"""Seconds per map in the program's ``halfstep`` spans (every half-step of
both rounds, with the ``cost`` and ``rng`` spans inside them), from the
``Timings`` of the window's calls; nothing where the program opens no such
span."""


def read(run):
    v = [c.spans["halfstep"] for c in run.calls
         if not c.failed and "halfstep" in c.spans]
    return sum(v) / len(v) if v else None
