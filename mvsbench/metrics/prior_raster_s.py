"""Seconds per map in the program's ``raster`` spans (the prior build's
plane fit per triangle, the ``cv2.fillPoly`` loop over the triangles and
the prior's fields), from the ``Timings`` of the window's calls; nothing
where the program opens no such span."""


def read(run):
    v = [c.spans["raster"] for c in run.calls
         if not c.failed and "raster" in c.spans]
    return sum(v) / len(v) if v else None
