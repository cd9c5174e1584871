"""Seconds per map in the pass runner's ``load`` scope (``load_problem``
and ``load_seeds``: image decode and rescale, cameras, source depths,
seeds), from the ``Timings`` of the window's calls."""


def read(run):
    v = [c.spans.get("load") for c in run.calls if not c.failed]
    v = [x for x in v if x is not None]
    return sum(v) / len(v) if v else None
