"""Plane-hypothesis state (counterpart of acmmp_spherical_tpu/core/plane.py)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PlaneState:
    normal: torch.Tensor    # (H, W, 3), ref-cam frame
    w: torch.Tensor         # (H, W) plane offset (n . X + w = 0)
    cost: torch.Tensor      # (H, W)
    selected: torch.Tensor  # (S, H, W) bool
    pre_cost: torch.Tensor  # (H, W) hierarchy-mode commit threshold
