"""Sampling and grid primitives (counterpart of
acmmp_spherical_tpu/ops/sampling.py).

The TPU's packed gather tables (``pack_bilinear``, ``pack_bicubic``) exist
for XLA's per-row gather cost; here samples are indexed directly, with the
same edge-clamp semantics and the same accumulation order.
"""

from __future__ import annotations

import torch


def grid_coords(height: int, width: int, device):
    """Pixel-centre coordinate grids (xs, ys), each (H, W) float32."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return xs, ys


def catmull_rom_weights(t):
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t3 + t2 - 0.5 * t,
            1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t,
            0.5 * t3 - 0.5 * t2)


def sample_bicubic(img: torch.Tensor, x, y, width: int, height: int):
    """Catmull-Rom bicubic sample with edge-clamped neighbours, equal to the
    reference's ``sample_bicubic_packed16(pack_bicubic(img))`` (row sums in
    column order, then rows in order).  ``img`` (Hp, Wp) with logical size
    (width, height).  Returns (value, valid)."""
    valid = (x >= 0.0) & (x < width) & (y >= 0.0) & (y < height)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.to(torch.int64).clamp(0, width - 1)
    y0 = y0f.to(torch.int64).clamp(0, height - 1)
    wx = catmull_rom_weights(fx)
    wy = catmull_rom_weights(fy)
    wp = img.shape[-1]
    flat = img.reshape(-1)
    cols = [(x0 + (c - 1)).clamp(0, width - 1) for c in range(4)]
    val = torch.zeros_like(x)
    for r in range(4):
        row = (y0 + (r - 1)).clamp(0, height - 1) * wp
        rowv = torch.zeros_like(x)
        for c in range(4):
            rowv = rowv + wx[c] * flat[row + cols[c]]
        val = val + wy[r] * rowv
    return val, valid


def shift2d(arr: torch.Tensor, dy: int, dx: int, *, fill=None) -> torch.Tensor:
    """Static shift ``out[y, x] = arr[y + dy, x + dx]`` over the last two
    axes; ``fill=None`` edge-clamps, else out-of-range reads give ``fill``."""
    h, w = arr.shape[-2:]
    out = arr
    if dx != 0:
        if dx > 0:
            body = out[..., dx:]
            pad = (body[..., -1:].expand(*out.shape[:-1], dx) if fill is None
                   else torch.full((*out.shape[:-1], dx), fill,
                                   dtype=out.dtype, device=out.device))
            out = torch.cat([body, pad], -1)
        else:
            body = out[..., :dx]
            pad = (body[..., :1].expand(*out.shape[:-1], -dx) if fill is None
                   else torch.full((*out.shape[:-1], -dx), fill,
                                   dtype=out.dtype, device=out.device))
            out = torch.cat([pad, body], -1)
    if dy != 0:
        if dy > 0:
            body = out[..., dy:, :]
            pad = (body[..., -1:, :].expand(*out.shape[:-2], dy, w)
                   if fill is None else
                   torch.full((*out.shape[:-2], dy, w), fill,
                              dtype=out.dtype, device=out.device))
            out = torch.cat([body, pad], -2)
        else:
            body = out[..., :dy, :]
            pad = (body[..., :1, :].expand(*out.shape[:-2], -dy, w)
                   if fill is None else
                   torch.full((*out.shape[:-2], -dy, w), fill,
                              dtype=out.dtype, device=out.device))
            out = torch.cat([pad, body], -2)
    return out


def checkerboard_pack(arr: torch.Tensor, parity: int) -> torch.Tensor:
    """Pack the colour ``(x + y) % 2 == parity`` into a dense half-grid
    ``(..., H, W) -> (..., H, W//2)``, rows preserved."""
    H, W = arr.shape[-2], arr.shape[-1]
    if H % 2 or W % 2:
        raise ValueError(f"checkerboard_pack needs even dims, got {(H, W)}")
    even = arr[..., 0::2, parity::2]
    odd = arr[..., 1::2, (1 - parity)::2]
    return torch.stack([even, odd], -2).reshape(*arr.shape[:-2], H, W // 2)


def checkerboard_unpack(packed: torch.Tensor, full: torch.Tensor,
                        parity: int) -> torch.Tensor:
    """Write a packed half-grid back into a copy of ``full`` at its colour."""
    H, W = full.shape[-2], full.shape[-1]
    pr = packed.reshape(*packed.shape[:-2], H // 2, 2, W // 2)
    out = full.clone()
    out[..., 0::2, parity::2] = pr[..., 0, :]
    out[..., 1::2, (1 - parity)::2] = pr[..., 1, :]
    return out


def checkerboard_coords(height: int, width: int, parity: int, device):
    """(xs, ys) of the packed half-grid, (H, W//2) each."""
    xs, ys = grid_coords(height, width, device)
    return checkerboard_pack(xs, parity), checkerboard_pack(ys, parity)


def shift_valid_mask(height: int, width: int, dy: int, dx: int, device):
    """Pixels whose (y+dy, x+dx) neighbour is in bounds."""
    ys = torch.arange(height, device=device)[:, None]
    xs = torch.arange(width, device=device)[None, :]
    return ((ys + dy >= 0) & (ys + dy < height)
            & (xs + dx >= 0) & (xs + dx < width))
