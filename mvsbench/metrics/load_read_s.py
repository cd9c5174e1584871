"""Seconds per map in the pass runner's ``read`` spans (inside ``load``:
the thread pool's image decodes and ``.dmb`` reads into the host stacks,
for the problem and for a seeded pass's fields), from the ``Timings`` of
the window's calls; nothing where the program opens no such span."""


def read(run):
    v = [c.spans["read"] for c in run.calls
         if not c.failed and "read" in c.spans]
    return sum(v) / len(v) if v else None
