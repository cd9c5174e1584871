"""Checkerboard median depth filter (counterpart of
acmmp_spherical_tpu/ops/filter.py; reference ACMMP.cu:1366-1504).
``wrap_x`` (SPHERE depth maps) wraps the taps around the longitude seam:
only the rows bound the stencil there."""

from __future__ import annotations

import torch

from acmmp_spherical_torch.ops.sampling import (
    grid_coords, shift2d, shift_valid_mask,
)

# (dy, dx) stencil in reference read order; index 0 is the centre
_STENCIL = [
    (0, 0),
    (-1, 0), (-3, 0), (-5, 0),
    (1, 0), (3, 0), (5, 0),
    (0, -1), (0, -3), (0, -5),
    (0, 1), (0, 3), (0, 5),
    (-1, 2), (1, 2), (-1, -2), (1, -2),
    (-2, -1), (-2, 1), (2, -1), (2, 1),
]


def _median_halfstep(depth, cost, parity, min_cost, wrap_x):
    H, W = depth.shape
    dev = depth.device
    inf = float("inf")
    valid = torch.stack([shift_valid_mask(H, W, dy, 0 if wrap_x else dx, dev)
                         for dy, dx in _STENCIL])
    taps = torch.stack([shift2d(depth, dy, dx, fill=inf, wrap_x=wrap_x)
                        for dy, dx in _STENCIL])
    taps = torch.where(valid, taps, torch.full_like(taps, inf))
    count = valid.sum(0)
    s = torch.sort(taps, 0).values
    mid = count // 2
    hi = torch.gather(s, 0, mid[None])[0]
    lo = torch.gather(s, 0, torch.clamp(mid - 1, min=0)[None])[0]
    med = torch.where(count % 2 == 0, 0.5 * (lo + hi), hi)
    xs, ys = grid_coords(H, W, dev)
    par = ((xs.to(torch.int32) + ys.to(torch.int32)) % 2) == parity
    return torch.where(par & (cost >= min_cost), med, depth)


def checkerboard_median_filter(depth, cost, *, min_cost: float = 0.001,
                               wrap_x: bool = False):
    """Black then red half-step median filtering of the depth map."""
    depth = _median_halfstep(depth, cost, 0, min_cost, wrap_x)
    return _median_halfstep(depth, cost, 1, min_cost, wrap_x)
