"""Initial multi-view cost aggregation (counterpart of the
``topk_cost_and_selection`` part of acmmp_spherical_tpu/ops/ncc.py).

The exact-path NCC (``multiview_ncc``, ``ref_tap_context``) is not on the
rectified slice: the kernel takes every evaluation there.
"""

from __future__ import annotations

import torch

from acmmp_spherical_tpu.config import PatchMatchParams


def topk_cost_and_selection(cost_vector, src_valid, params: PatchMatchParams):
    """Mean of the best ``min(#valid views, top_k)`` costs and the views at
    or below the k-th best (reference ACMMP.cu:519-556).
    Returns (cost (H, W), selected (S, H, W) bool)."""
    cost_max = params.cost_max
    cv = torch.where(src_valid[:, None, None], cost_vector,
                     torch.full_like(cost_vector, cost_max))
    num_valid = (cv < cost_max).sum(0)
    k = torch.clamp(num_valid, max=params.top_k)
    sorted_cv = torch.sort(cv, 0).values
    csum = torch.cumsum(sorted_cv, 0)
    k_idx = torch.clamp(k - 1, 0, cv.shape[0] - 1)
    topk_sum = torch.gather(csum, 0, k_idx[None])[0]
    cost = torch.where(k > 0, topk_sum / torch.clamp(k, min=1),
                       torch.full_like(topk_sum, cost_max))
    threshold = torch.gather(sorted_cv, 0, k_idx[None])[0]
    selected = ((cv <= threshold[None]) & (k > 0)[None]
                & src_valid[:, None, None])
    return cost, selected
