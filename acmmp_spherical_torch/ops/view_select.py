"""Multi-hypothesis joint view selection (counterpart of
acmmp_spherical_tpu/ops/view_select.py; reference ACMMP.cu:1146-1208)."""

from __future__ import annotations

import dataclasses

import torch

from acmmp_spherical_torch.config import PatchMatchParams
from acmmp_spherical_torch.ops import rng as R
from acmmp_spherical_torch.ops.candidates import neighbor_selected_views


@dataclasses.dataclass(frozen=True)
class ViewSelection:
    weights: torch.Tensor        # (S, ...) vote counts
    weight_norm: torch.Tensor    # (...)
    temp_selected: torch.Tensor  # (S, ...) bool


def view_selection_priors(selected_prev, near_valid, params: PatchMatchParams,
                          *, wrap_x: bool = False):
    """0.9/0.1 neighbour priors on the full grid (ACMMP.cu:1149-1160);
    ``wrap_x`` takes the neighbours across the longitude seam.
    Returns (S, H, W)."""
    neigh = neighbor_selected_views(selected_prev, wrap_x=wrap_x)
    contrib = torch.where(neigh, params.view_prior_selected,
                          params.view_prior_unselected).float()
    return (contrib * near_valid[:, None]).sum(0)


def joint_view_selection(cost_arrays, cand_valid, priors, src_valid,
                         params: PatchMatchParams, key, iteration: int
                         ) -> ViewSelection:
    """Per-view scores over the 8 candidates, then ``num_votes``
    importance-sampled votes from the per-pixel CDF."""
    S = cost_arrays.shape[1]
    spatial = tuple(cost_arrays.shape[2:])
    dev = cost_arrays.device
    it = torch.tensor(float(iteration), dtype=torch.float32)
    thr = float(params.cost_threshold_base
                * torch.exp(-(it * it) / params.cost_threshold_anneal))
    thr32 = torch.tensor(thr, dtype=torch.float32)
    ca = cost_arrays
    cv = cand_valid[:, None]
    good = (ca < thr) & cv
    bad = (ca > params.bad_cost) & cv
    n_good = good.sum(0).float()
    n_bad = bad.sum(0)
    gw = torch.where(good, torch.exp(ca * ca / (-params.view_weight_beta)),
                     torch.zeros((), device=dev))
    sum_gw = gw.sum(0)
    mean_path = sum_gw / torch.clamp(n_good, min=1.0)
    fallback = float(torch.exp(thr32 * thr32 / (-params.view_fallback_beta)))
    probs = torch.where(
        n_bad < params.max_bad_views,
        torch.where(n_good > params.min_good_candidates, mean_path,
                    torch.full_like(mean_path, fallback)),
        torch.zeros_like(mean_path))
    probs = probs * priors * src_valid.reshape((S,) + (1,) * len(spatial))

    total = probs.sum(0)
    cdf = torch.cumsum(probs, 0) / torch.clamp(total, min=1e-30)
    anyprob = total > 0.0
    u = R.uniform(key, (params.num_votes,) + spatial, dev)
    view_ids = torch.arange(S, device=dev).reshape((S,) + (1,) * len(spatial))
    weights = torch.zeros((S,) + spatial, dtype=torch.float32, device=dev)
    for v in range(params.num_votes):
        idx = (cdf <= u[v][None]).sum(0)
        hit = (view_ids == idx[None]) & anyprob[None] & (idx < S)[None]
        weights = weights + hit.float()
    return ViewSelection(weights, weights.sum(0), weights > 0.0)
