"""The photometric cost of a plane field, worked out again in plain torch:
ACMMP's bilateral-weighted NCC (reference ACMMP.cu:398-563) of each
sampled pixel's plane against every source view, by exact projection of
each tap (no rectification, no packing), in float64, and the mean of the
best ``top_k`` views (the cost the pass starts from, ACMMP.cu:519-556).

The images are the files the program reads, decoded with OpenCV and
rescaled as the pipeline rescales them (``cv2.resize`` INTER_LINEAR:
source coordinate ``(x + 0.5) s - 0.5``, edges clamped), here in torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mvsbench.reference import scene as S

PATCH = 11
STEP = 2
SIGMA_SPATIAL = 5.0
SIGMA_COLOR = 3.0
COST_MAX = 2.0
TOP_K = 4


def load_gray(path, width: int, height: int, device) -> torch.Tensor:
    """An image file as float64 gray at (height, width), resized with
    bilinear weights at half-pixel centres (OpenCV's INTER_LINEAR)."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    src = torch.as_tensor(img.astype(np.float64), device=device)
    h0, w0 = src.shape
    if (h0, w0) == (height, width):
        return src

    def axis(n_out, n_in):
        s = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) \
            * (n_in / n_out) - 0.5
        s = s.clamp(0, n_in - 1)
        i0 = s.floor().long().clamp(max=n_in - 2)
        return i0, s - i0

    y0, fy = axis(height, h0)
    x0, fx = axis(width, w0)
    top = src[y0][:, x0] * (1 - fx) + src[y0][:, x0 + 1] * fx
    bot = src[y0 + 1][:, x0] * (1 - fx) + src[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy[:, None]) + bot * fy[:, None]


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
              wrap: bool):
    """(values, inside) of ``img`` at pixel-centre coordinates; SPHERE
    wraps x and clamps y, every sample inside."""
    H, W = img.shape
    if wrap:
        x = torch.remainder(x, W)
        y = y.clamp(0, H - 1)
        inside = torch.ones_like(x, dtype=torch.bool)
    else:
        inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x0 = x.floor()
    y0 = y.floor()
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    if wrap:
        x1 = (x0 + 1) % W
        y1 = (y0 + 1).clamp(max=H - 1)
    else:
        x0, y0 = x0.clamp(0, W - 1), y0.clamp(0, H - 1)
        x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    v = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
         + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)
    return v, inside


def _project(cam: S.RingCamera, X: torch.Tensor):
    """World points -> (x, y, valid) in the camera's image."""
    R = torch.as_tensor(cam.R, dtype=torch.float64, device=X.device)
    t = torch.as_tensor(cam.t, dtype=torch.float64, device=X.device)
    Xc = X @ R.T + t
    if cam.model == "sphere":
        d = Xc.norm(dim=-1).clamp(min=1e-12)
        lat = -torch.arcsin((Xc[..., 1] / d).clamp(-1, 1))
        lon = torch.atan2(Xc[..., 0], Xc[..., 2])
        _, cx, cy = cam.sphere
        return (lon / (2 * math.pi) * cam.width + cx,
                -lat / math.pi * cam.height + cy, d > 1e-9)
    z = Xc[..., 2]
    zs = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return (cam.K[0, 0] * Xc[..., 0] / zs + cam.K[0, 2],
            cam.K[1, 1] * Xc[..., 1] / zs + cam.K[1, 2], z > 0)


def _rays(cam: S.RingCamera, x: torch.Tensor, y: torch.Tensor):
    if cam.model == "sphere":
        _, cx, cy = cam.sphere
        lon = (x - cx) / cam.width * (2 * math.pi)
        lat = -(y - cy) / cam.height * math.pi
        cl = torch.cos(lat)
        return torch.stack([cl * torch.sin(lon), -torch.sin(lat),
                            cl * torch.cos(lon)], -1)
    return torch.stack([(x - cam.K[0, 2]) / cam.K[0, 0],
                        (y - cam.K[1, 2]) / cam.K[1, 1],
                        torch.ones_like(x)], -1)


def plane_costs(ref_cam: S.RingCamera, src_cams: list, ref_img, src_imgs,
                xs: torch.Tensor, ys: torch.Tensor, depth: torch.Tensor,
                normal_world: torch.Tensor) -> torch.Tensor:
    """(S, N) bilateral NCC costs of the planes through ``depth`` along the
    rays of pixels (xs, ys) with world normals ``normal_world`` (N, 3),
    against each source view; ``cam`` objects at the images' sizes."""
    dev = xs.device
    wrap = ref_cam.model == "sphere"
    R = torch.as_tensor(ref_cam.R, dtype=torch.float64, device=dev)
    t = torch.as_tensor(ref_cam.t, dtype=torch.float64, device=dev)
    C = -R.T @ t
    n = normal_world.to(torch.float64) @ R.T            # camera frame
    w = -depth.to(torch.float64) * (n * _rays(ref_cam, xs, ys)).sum(-1)
    center, _ = _bilinear(ref_img, xs, ys, wrap)
    r = PATCH // 2
    offs = [(dx, dy) for dy in range(-r, r + 1, STEP)
            for dx in range(-r, r + 1, STEP)]
    if wrap:
        lat_c = -(ys - ref_cam.sphere[2]) / ref_cam.height * math.pi
        sx = (2 * math.pi / ref_cam.width) * torch.cos(lat_c)
        sy = math.pi / ref_cam.height
        two_ss = 2 * (SIGMA_SPATIAL * math.pi / ref_cam.height) ** 2
    else:
        two_ss = 2 * SIGMA_SPATIAL ** 2
    two_sc = 2 * SIGMA_COLOR ** 2
    pc = C + (_rays(ref_cam, xs, ys) * depth.to(torch.float64)[:, None]) @ R
    valid_c = []
    for cam in src_cams:
        u, v, ok = _project(cam, pc)
        if not wrap:
            ok = ok & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        valid_c.append(ok)
    # per view: sums of w, w r, w r^2, w s, w s^2, w r s over the taps
    sums = [[torch.zeros_like(xs) for _ in range(6)] for _ in src_cams]
    for dx, dy in offs:
        ref_pix, _ = _bilinear(ref_img, xs + dx, ys + dy, wrap)
        if wrap:
            sdist = torch.sqrt((dx * sx) ** 2 + (dy * sy) ** 2)
        else:
            sdist = torch.full_like(xs, math.sqrt(dx * dx + dy * dy))
        wt = torch.exp(-sdist / two_ss - (ref_pix - center).abs() / two_sc)
        ray = _rays(ref_cam, xs + dx, ys + dy)
        denom = (n * ray).sum(-1)
        d = -w / torch.where(denom.abs() < 1e-12,
                             torch.full_like(denom, 1e-12), denom)
        X = C + (ray * d[:, None]) @ R
        for k, cam in enumerate(src_cams):
            u, v, ok = _project(cam, X)
            val, inside = _bilinear(src_imgs[k], u, v, wrap)
            wv = torch.where(ok & inside, wt, torch.zeros_like(wt))
            for acc, term in zip(sums[k], (wv, wv * ref_pix,
                                           wv * ref_pix * ref_pix, wv * val,
                                           wv * val * val,
                                           wv * ref_pix * val)):
                acc += term
    s_w, s_r, s_rr, s_s, s_ss, s_rs = (torch.stack(a) for a in zip(*sums))
    valid_c = torch.stack(valid_c)
    inv = 1.0 / s_w.clamp(min=1e-12)
    m_r, m_s = s_r * inv, s_s * inv
    var_r = s_rr * inv - m_r * m_r
    var_s = s_ss * inv - m_s * m_s
    cov = s_rs * inv - m_r * m_s
    ncc = 1.0 - cov / torch.sqrt((var_r * var_s).clamp(min=1e-30))
    cost = ncc.clamp(0.0, COST_MAX)
    bad = (s_w < 1e-6) | (var_r < 1e-5) | (var_s < 1e-5) | ~valid_c
    return torch.where(bad, torch.full_like(cost, COST_MAX), cost)


def top_k_mean(costs: torch.Tensor, k: int = TOP_K) -> torch.Tensor:
    """Mean of the best ``min(k, #views below COST_MAX)`` costs per pixel
    (COST_MAX where no view is valid)."""
    n_ok = (costs < COST_MAX).sum(0)
    kk = n_ok.clamp(max=k)
    s = torch.sort(costs, 0).values.cumsum(0)
    idx = (kk - 1).clamp(min=0)
    total = s.gather(0, idx[None])[0]
    return torch.where(kk > 0, total / kk.clamp(min=1),
                       torch.full_like(total, COST_MAX))
