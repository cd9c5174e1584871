"""The least time the card could take for the multi-view NCC a call needs,
counted from the algorithm at the call's shapes, whatever implements it.

ACMMP evaluates its bilateral NCC (reference ACMMP.cu:398-563) per
(candidate plane, pixel, source view, tap).  Per iteration a round of a
pass makes two checkerboard half-steps over half the pixels each, each
scoring the 8 propagation candidates and the current plane (9) and then
the 5 refinement candidates (ACMMP.cu:1210-1340).  A prior call runs two
rounds of ``iterations`` (the photometric pass and the planar-prior round),
a geometric call one round of 2 iterations with the geometric term.  The
initial evaluation of each round is left out: depending on the scale's
init window it runs in the rect kernel or on the exact path, so counting
it could only put the share above what the kernels did.

Per launch the least time is the larger of its operations over the fp32
peak and its bytes over the HBM peak, with every input read once and every
output written once: the reference frame (f32), the source frames (at the
tap precision), the planes evaluated (4 f32 each) and one cost per (plane,
view); a geometric launch also reads the source depth frames and writes a
geometric cost per (plane, view).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# fp32 operations of one tap of one (plane, pixel, view) evaluation: the
# source coordinate, the interpolated sample and the weighted moment sums,
# as the kernel gate of chip_smoke.py counts them; the per-pixel and
# per-view ends are left out, so the share is a lower bound
TAP_FLOPS = 30
CANDIDATES = (9, 5)       # per half-step: propagation + current, refinement


def launches(H: int, W: int, *, rounds: int, iterations: int) -> list:
    """[(pixels, planes)] of the half-steps' NCC launches of one call."""
    return [((H * W) // 2, c) for _ in range(rounds * 2 * iterations)
            for c in CANDIDATES]


def least_seconds(H: int, W: int, S: int, taps: int, *, rounds: int,
                  iterations: int, geom: bool, tap_bytes: int = 2) -> float:
    """The least device time of a call's NCC launches at an H x W map
    with S source views and ``taps`` taps per patch."""
    total = 0.0
    for pixels, planes in launches(H, W, rounds=rounds,
                                   iterations=iterations):
        evals = pixels * planes * S
        flops = evals * taps * TAP_FLOPS
        nbytes = (H * W * 4 + S * H * W * tap_bytes + pixels * planes * 16
                  + evals * 4)
        if geom:
            nbytes += S * H * W * 4 + evals * 4
        total += max(flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
    return total


def call_shape(traffic_kwargs: dict, params) -> dict:
    """The rounds, iterations and geometric term of a call of a mix, from
    its ``process_problem`` keywords and the configuration's
    PatchMatchParams fields (``max_iterations``)."""
    if traffic_kwargs.get("geom"):
        return dict(rounds=1, iterations=2, geom=True)
    rounds = 2 if traffic_kwargs.get("planar_prior") else 1
    return dict(rounds=rounds, iterations=params["max_iterations"],
                geom=False)
