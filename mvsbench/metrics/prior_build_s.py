"""Seconds per map in the pass runner's ``prior_build`` scope (the host's
Delaunay planar prior and ``triangulation.png``), from the ``Timings`` of
the window's calls; nothing where no call builds a prior."""


def read(run):
    v = [c.spans["prior_build"] for c in run.calls
         if not c.failed and "prior_build" in c.spans]
    return sum(v) / len(v) if v else None
