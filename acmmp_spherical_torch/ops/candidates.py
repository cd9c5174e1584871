"""Adaptive checkerboard candidate sampling (counterpart of
acmmp_spherical_tpu/ops/candidates.py; reference ACMMP.cu:956-1144).

Each pixel takes the min-stored-cost neighbour of 8 regions (4 V-shaped near
regions, 4 strided far strips).  Pinhole only: the x axis never wraps.
"""

from __future__ import annotations

import dataclasses

import torch

from acmmp_spherical_torch.ops.sampling import shift2d

_UP_NEAR = [(-1, 0)] + [(-(2 + i), -i) for i in range(3)] + [(-(2 + i), i) for i in range(3)]
_DOWN_NEAR = [(1, 0)] + [((2 + i), -i) for i in range(3)] + [((2 + i), i) for i in range(3)]
_LEFT_NEAR = [(0, -1)] + [(-i, -(2 + i)) for i in range(3)] + [(i, -(2 + i)) for i in range(3)]
_RIGHT_NEAR = [(0, 1)] + [(-i, (2 + i)) for i in range(3)] + [(i, (2 + i)) for i in range(3)]
_UP_FAR = [(-(3 + 2 * i), 0) for i in range(11)]
_DOWN_FAR = [((3 + 2 * i), 0) for i in range(11)]
_LEFT_FAR = [(0, -(3 + 2 * i)) for i in range(11)]
_RIGHT_FAR = [(0, (3 + 2 * i)) for i in range(11)]

# region order of the reference cost_array (ACMMP.cu:958)
REGIONS = [_UP_NEAR, _UP_FAR, _DOWN_NEAR, _DOWN_FAR,
           _LEFT_NEAR, _LEFT_FAR, _RIGHT_NEAR, _RIGHT_FAR]
NEAR_REGION_INDICES = (0, 2, 4, 6)
NEAR_BASE_OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1))


@dataclasses.dataclass(frozen=True)
class Candidates:
    normal: torch.Tensor  # (8, H, W, 3)
    w: torch.Tensor       # (8, H, W)
    valid: torch.Tensor   # (8, H, W) bool


def gather_candidates(normal, w, cost) -> Candidates:
    """The min-cost neighbour hypothesis of each of the 8 regions."""
    normal_cf = normal.movedim(-1, 0)
    cand_n, cand_w, cand_valid = [], [], []
    for offsets in REGIONS:
        shifted = torch.stack([shift2d(cost, dy, dx, fill=float("inf"))
                               for dy, dx in offsets])
        best = torch.argmin(shifted, 0)          # first minimum, like jnp
        sel_n = torch.zeros_like(normal_cf)
        sel_w = torch.zeros_like(w)
        for k, (dy, dx) in enumerate(offsets):
            m = best == k
            sel_n = torch.where(m[None], shift2d(normal_cf, dy, dx), sel_n)
            sel_w = torch.where(m, shift2d(w, dy, dx), sel_w)
        cand_n.append(sel_n.movedim(0, -1))
        cand_w.append(sel_w)
        cand_valid.append(torch.isfinite(shifted.amin(0)))
    return Candidates(normal=torch.stack(cand_n), w=torch.stack(cand_w),
                      valid=torch.stack(cand_valid))


def neighbor_selected_views(selected: torch.Tensor) -> torch.Tensor:
    """Shifted selected-view masks of the 4 adjacent pixels, (4, S, H, W)."""
    return torch.stack([shift2d(selected, dy, dx, fill=False)
                        for dy, dx in NEAR_BASE_OFFSETS])
