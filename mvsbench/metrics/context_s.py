"""Seconds per map in the program's ``context`` spans (``prepare_inputs``:
the rectified context, ``ops/rectify`` or ``ops/sphere_rect``, and its
pair-word source frame; ``ref_tap_context``), from the ``Timings`` of the
window's calls; nothing where the program opens no such span."""


def read(run):
    v = [c.spans["context"] for c in run.calls
         if not c.failed and "context" in c.spans]
    return sum(v) / len(v) if v else None
