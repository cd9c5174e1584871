"""Seconds per map in the program's ``draw`` spans (the prior build's
``triangulation.png``: three ``cv2.line`` calls per triangle and the PNG
write), from the ``Timings`` of the window's calls; nothing where the
program opens no such span."""


def read(run):
    v = [c.spans["draw"] for c in run.calls
         if not c.failed and "draw" in c.spans]
    return sum(v) / len(v) if v else None
