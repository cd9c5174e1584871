"""Error arithmetic of a depth map against the ground truth (frozen copies
of ``utils/metrics.depth_error_stats`` and ``bench.sphere_band_errors`` of
the PyTorch package, in plain torch).

The pixels compared are a map's interior: a pinhole map without a border of
``PINHOLE_BORDER`` pixels, a SPHERE map over the rows of the latitude band
that ``LAT_CAP_DEG`` leaves (every column: the longitude wraps), where the
pole-rotated path does not cap the patch.
"""

from __future__ import annotations

import torch

PINHOLE_BORDER = 8
LAT_CAP_DEG = 78.0   # ops/sphere_rect.LAT_CAP_DEG of the program


def interior(model: str, height: int, width: int, cy: float = 0.0):
    """(row slice, column slice) of the pixels a map is judged on."""
    if model == "sphere":
        # |lat| <= the cap, lat = -(y - cy) / H * 180 degrees
        span = LAT_CAP_DEG / 180.0 * height
        y0 = max(0, int(torch.ceil(torch.tensor(cy - span)).item()))
        y1 = min(height, int(torch.floor(torch.tensor(cy + span)).item()) + 1)
        return slice(y0, y1), slice(0, width)
    b = PINHOLE_BORDER
    return slice(b, height - b), slice(b, width - b)


def rel_errors(depth: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """|d - gt| / gt, float64, flattened."""
    d = depth.to(torch.float64).reshape(-1)
    g = gt.to(torch.float64).reshape(-1)
    rel = (d - g).abs() / g.clamp(min=1e-9)
    # a non-finite depth is as wrong as can be
    return torch.where(torch.isfinite(rel), rel,
                       torch.full_like(rel, float("inf")))


def normal_angles_deg(normal: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Angle in degrees between each written world normal and the truth's,
    flattened; a zero or non-finite normal reads 180."""
    n = normal.to(torch.float64).reshape(-1, 3)
    g = gt.to(torch.float64).reshape(-1, 3)
    norm = n.norm(dim=-1)
    cos = (n * g).sum(-1) / norm.clamp(min=1e-30)
    ang = torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))
    bad = ~torch.isfinite(cos) | (norm < 1e-12)
    return torch.where(bad, torch.full_like(ang, 180.0), ang)


def median(x: torch.Tensor) -> float:
    """The median as numpy takes it (the mean of the two middle values)."""
    n = x.numel()
    if n == 0:
        return float("nan")
    s = torch.sort(x.reshape(-1)).values
    return float((s[(n - 1) // 2] + s[n // 2]) / 2)
