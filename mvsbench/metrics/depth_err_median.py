"""The median relative depth error against the exact ground truth over the
interior pixels of every map the window wrote (pinhole: an 8-pixel border
left out; SPHERE: the latitude band ``LAT_CAP_DEG`` leaves)."""


def read(run):
    v = run.depth_err_median
    return v if v == v else None
