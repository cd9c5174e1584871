"""The worst map's median angle, in degrees, between the written world
normal and the exact one over the same interior pixels as the depth error
(the reference's ``normal_deg``): the planes the half-steps leave."""


def read(run):
    v = run.numbers.get("normal_deg")
    return v if v is not None and v == v else None
