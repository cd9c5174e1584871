"""Joint bilateral upsampling (counterpart of acmmp_spherical_tpu/ops/jbu.py),
plain torch on the tensors' device.

Used between pyramid scales on depth maps (``JBU_cu``, ACMMP.cu:1558-1616)
and on the coarse normal field of a hierarchy pass's seed (ACMMP.cu:713-779).
For fine pixel p the coarse source is sampled at truncated integer
coordinates around ``o = p * scale`` in a ``(2k+1)^2`` window with
``k = (s^2 + 1) // 2``, ``s = max(W // w, H // h)`` (25 taps at s = 2);
the weights are a spatial gaussian between ``o`` and the truncated coarse
coordinates (sigma 0.5) times a range gaussian on the fine guide image
(sigma 25.5).
"""

from __future__ import annotations

import torch

from acmmp_spherical_torch.ops.sampling import grid_coords


def jbu_window_radius(fine_w: int, fine_h: int, coarse_w: int,
                      coarse_h: int) -> int:
    image_scale = max(fine_w // coarse_w, fine_h // coarse_h)
    return (image_scale * image_scale + 1) // 2


def joint_bilateral_upsample(coarse: torch.Tensor, guide: torch.Tensor, *,
                             sigma_spatial: float = 0.5,
                             sigma_range: float = 25.5,
                             radius: int | None = None) -> torch.Tensor:
    """Upsample ``coarse`` ((h, w) or (h, w, C)) to the resolution of
    ``guide`` ((H, W) grayscale 0..255, same device).  Returns (H, W[, C])."""
    H, W = guide.shape
    coarse3 = coarse[..., None] if coarse.ndim == 2 else coarse
    h, w = coarse3.shape[:2]
    if radius is None:
        radius = jbu_window_radius(W, H, w, h)
    scale = w / W  # the x ratio for both axes, as the reference (ACMMP.cu:1572)
    xs, ys = grid_coords(H, W, guide.device)
    ox, oy = xs * scale, ys * scale
    xi, yi = xs.to(torch.int64), ys.to(torch.int64)
    num = torch.zeros((H, W) + coarse3.shape[2:], dtype=torch.float32,
                      device=guide.device)
    den = torch.zeros((H, W), dtype=torch.float32, device=guide.device)
    two_ss = 2.0 * sigma_spatial * sigma_spatial
    two_sr = 2.0 * sigma_range * sigma_range
    for j in range(-radius, radius + 1):
        # truncated and clamped coarse row (ACMMP.cu:1591-1592)
        ry = torch.clamp(torch.trunc(oy + j).to(torch.int64), 0, h - 1)
        gy = torch.clamp(yi + j, 0, H - 1)
        for i in range(-radius, radius + 1):
            rx = torch.clamp(torch.trunc(ox + i).to(torch.int64), 0, w - 1)
            gx = torch.clamp(xi + i, 0, W - 1)
            src = coarse3[ry, rx]
            neighbor = guide[gy, gx]
            sdist2 = (ox - rx.float()) ** 2 + (oy - ry.float()) ** 2
            wgt = (torch.exp(-sdist2 / two_ss)
                   * torch.exp(-((guide - neighbor) ** 2) / two_sr))
            num = num + src * wgt[..., None]
            den = den + wgt
    out = num / torch.clamp(den, min=1e-20)[..., None]
    return out[..., 0] if coarse.ndim == 2 else out
