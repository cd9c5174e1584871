"""Quality metrics: depth-map error and fused-cloud accuracy/completeness
(counterpart of acmmp_spherical_tpu/utils/metrics.py): ETH3D-style accuracy
(fraction of fused points within tau of the ground-truth surface) and
completeness (fraction of ground-truth samples with a fused point within
tau)."""

from __future__ import annotations

import numpy as np


def depth_error_stats(depth: np.ndarray, gt: np.ndarray, *, border: int = 6):
    """Relative depth-error statistics over the interior."""
    s = np.s_[border:-border, border:-border] if border else np.s_[:, :]
    rel = np.abs(depth[s] - gt[s]) / np.maximum(gt[s], 1e-9)
    return {
        "median_rel_err": float(np.median(rel)),
        "mean_rel_err": float(np.mean(rel)),
        "frac_below_1pct": float(np.mean(rel < 0.01)),
        "frac_below_2pct": float(np.mean(rel < 0.02)),
    }


def cloud_accuracy_completeness(points: np.ndarray, gt_points: np.ndarray,
                                tau: float):
    """Accuracy = P(dist(fused -> GT) < tau); completeness = P(dist(GT ->
    fused) < tau), by KD-tree; both clouds are (N, 3)."""
    from scipy.spatial import cKDTree

    if len(points) == 0 or len(gt_points) == 0:
        return {"accuracy": 0.0, "completeness": 0.0,
                "n_points": int(len(points))}
    d_acc, _ = cKDTree(gt_points).query(points, k=1)
    d_com, _ = cKDTree(points).query(gt_points, k=1)
    return {
        "accuracy": float(np.mean(d_acc < tau)),
        "completeness": float(np.mean(d_com < tau)),
        "n_points": int(len(points)),
    }


def cube_surface_distance(points: np.ndarray, half: float) -> np.ndarray:
    """Distance of points to the surface of the cube [-half, half]^3 (the
    synthetic scene, whose surface is analytic)."""
    return np.abs(np.max(np.abs(points), axis=1) - half)
