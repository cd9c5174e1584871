"""Faults planted under the timed path, for the checks of the comparison
that decides ``correct`` (``control.py`` on the card, ``tests/`` on the
CPU).  None of them is used by a benchmark run.

* ``fp8_taps``: the control.  The configuration states bfloat16 source taps
  (``rect_tap_pack``); the nearest precision below is fp8, so the control
  rounds the source frames a call loads to float8 e4m3, which the bf16 tap
  pack then carries exactly: the kernels read fp8 source taps.
* ``no_op``: every pass returns the state it started from (no iteration:
  the random or seeded initial planes, extracted and filtered).
* ``half_left_out``: the red half-steps leave their half of the pixels
  unchanged.
* ``answer_altered``: the depth map of the ``nth`` call (warm calls
  counted) is scaled by ``1 + ALTER_BY`` where the pass runner writes it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

ALTER_BY = 0.02


@contextlib.contextmanager
def _patched(module, name: str, make):
    kept = getattr(module, name)
    setattr(module, name, make(kept))
    try:
        yield
    finally:
        setattr(module, name, kept)


def fp8_taps():
    from acmmp_spherical_torch.pipeline import pass_runner

    def make(load_problem):
        def load(*args, **kw):
            lp, params = load_problem(*args, **kw)
            src = lp.inputs.src_images
            fp8 = src.to(torch.float8_e4m3fn).to(src.dtype)
            lp.inputs = dataclasses.replace(lp.inputs, src_images=fp8)
            return lp, params
        return load

    return _patched(pass_runner, "load_problem", make)


def no_op():
    from acmmp_spherical_torch.pipeline import pass_runner

    def make(run_patchmatch):
        def run(inputs, params, key, **kw):
            return run_patchmatch(
                inputs, dataclasses.replace(params, max_iterations=0), key,
                **kw)
        return run

    return _patched(pass_runner, "run_patchmatch", make)


def half_left_out():
    from acmmp_spherical_torch.pipeline import patchmatch

    def make(halfstep):
        def step(state, inputs, params, key, it, parity, **kw):
            if parity == 1:
                return state
            return halfstep(state, inputs, params, key, it, parity, **kw)
        return step

    return _patched(patchmatch, "checkerboard_halfstep", make)


def answer_altered(nth: int = 6):
    from acmmp_spherical_torch.pipeline import pass_runner

    def make(write_results):
        count = [0]

        def write(sp, image_id, depth, normal_world, cost, **kw):
            count[0] += 1
            if count[0] == nth:
                depth = depth * (1.0 + ALTER_BY)
            return write_results(sp, image_id, depth, normal_world, cost,
                                 **kw)
        return write

    return _patched(pass_runner, "write_results", make)


FAULTS = {"fp8_taps": fp8_taps, "no_op": no_op,
          "half_left_out": half_left_out, "answer_altered": answer_altered}
