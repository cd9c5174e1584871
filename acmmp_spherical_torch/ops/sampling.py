"""Sampling and grid primitives (counterpart of
acmmp_spherical_tpu/ops/sampling.py).

The TPU's packed gather tables (``pack_bilinear``, ``pack_bicubic``) exist
for XLA's per-row gather cost; here samples are indexed directly, with the
same edge-clamp semantics and the same accumulation order.  ``wrap_x``
(SPHERE frames) wraps x modulo the view width, the +1 neighbours included,
and clamps y, as the reference's longitude seam does (ACMMP.cu:465-474).
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


def to_index(v: torch.Tensor) -> torch.Tensor:
    """int64 of a float tensor truncated toward zero (C's cast), clamped to
    +-2^30 first so far-off coordinates stay defined (callers mask them
    out), as the CUDA kernels' casts."""
    return v.clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64)


def _gather2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor):
    """``img[..., yi, xi]``: img (Hp, Wp), or (B, Hp, Wp) with index tensors
    of a leading B axis."""
    if img.dim() == 2:
        return img[yi, xi]
    B, _, wp = img.shape
    idx = (yi * wp + xi).reshape(B, -1)
    return torch.gather(img.reshape(B, -1), 1, idx).reshape(yi.shape)


def _wrap(x, width):
    """x modulo the view width (the reference's longitude wrap,
    ACMMP.cu:467)."""
    return x - torch.floor(x / width) * width


def sample_bilinear(img: torch.Tensor, x, y, width, height, *,
                    wrap_x: bool = False):
    """Bilinear sample at float coordinates (pixel centres at integers, the
    reference's ``tex2D(img, x + 0.5, y + 0.5)``).  Pinhole: the +1 corners
    are edge-clamped at the logical size (width, height), which may be
    tensors broadcasting against ``x``, and valid is the in-image test;
    ``wrap_x``: x wraps (corners included), y clamps, every sample is valid.
    ``img`` is (Hp, Wp) storage, or (B, Hp, Wp) for coordinates with a
    leading B axis.  Returns (value, valid).  Equal to the reference's
    ``sample_bilinear_packed(pack_bilinear(img))``."""
    if wrap_x:
        x = _wrap(x, width)
        y = torch.minimum(y.clamp(min=0.0), torch.as_tensor(
            height - 1.0, dtype=y.dtype, device=y.device))
        valid = torch.ones(torch.broadcast_shapes(x.shape, y.shape),
                           dtype=torch.bool, device=x.device)
    else:
        valid = (x >= 0.0) & (x < width) & (y >= 0.0) & (y < height)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    wi = torch.as_tensor(width, device=x.device).to(torch.int64)
    hi = torch.as_tensor(height, device=x.device).to(torch.int64)
    if wrap_x:
        x0 = torch.remainder(to_index(x0f), wi)
        x1 = torch.remainder(x0 + 1, wi)
    else:
        x0 = torch.minimum(to_index(x0f).clamp(min=0), wi - 1)
        x1 = torch.minimum((x0 + 1).clamp(min=0), wi - 1)
    y0 = torch.minimum(to_index(y0f).clamp(min=0), hi - 1)
    y1 = torch.minimum((y0 + 1).clamp(min=0), hi - 1)
    v00 = _gather2d(img, y0, x0)
    v01 = _gather2d(img, y0, x1)
    v10 = _gather2d(img, y1, x0)
    v11 = _gather2d(img, y1, x1)
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy, valid


def sample_nearest_trunc(img: torch.Tensor, x, y, width, height, *,
                         wrap_x: bool = False):
    """Nearest sample at C-truncated indices, the reference's depth reads
    ``tex2D(depth, (int)x + 0.5, (int)y + 0.5)`` (ACMMP.cu:656).  Returns
    (value, valid) with valid the truncated index in bounds; ``wrap_x``:
    the truncated x wraps modulo the width and valid is ``y >= 0`` and the
    truncated y below the height (the sphere's source-depth lookup, JAX
    package sphere_rect.py:311-315).  Shapes as :func:`sample_bilinear`."""
    xi = to_index(x)
    yi = to_index(y)
    wi = torch.as_tensor(width, device=x.device).to(torch.int64)
    hi = torch.as_tensor(height, device=x.device).to(torch.int64)
    if wrap_x:
        xi = torch.remainder(xi, wi.clamp(min=1))
        valid = (y >= 0.0) & (yi < hi)
    else:
        valid = (xi >= 0) & (xi < wi) & (yi >= 0) & (yi < hi)
    xi = torch.minimum(xi.clamp(min=0), wi - 1)
    yi = torch.minimum(yi.clamp(min=0), hi - 1)
    return _gather2d(img, yi, xi), valid


def catmull_rom_weights(t):
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t3 + t2 - 0.5 * t,
            1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t,
            0.5 * t3 - 0.5 * t2)


def sample_bicubic(img: torch.Tensor, x, y, width, height, *,
                   wrap_x: bool = False):
    """Catmull-Rom bicubic sample with edge-clamped neighbours, equal to the
    reference's ``sample_bicubic_packed16(pack_bicubic(img))`` (row sums in
    column order, then rows in order); ``wrap_x`` wraps x and its
    neighbours modulo the width (valid is then the y test alone).  ``img``
    (Hp, Wp) with logical size (width, height), ints or 0-d tensors.
    Returns (value, valid)."""
    if wrap_x:
        x = _wrap(x, width)
        valid = (y >= 0.0) & (y < height)
    else:
        valid = (x >= 0.0) & (x < width) & (y >= 0.0) & (y < height)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    wi = torch.as_tensor(width, device=x.device).to(torch.int64)
    hi = torch.as_tensor(height, device=x.device).to(torch.int64)
    clamp = lambda v, n: torch.minimum(v.clamp(min=0), n - 1)
    x0 = to_index(x0f)
    x0 = torch.remainder(x0, wi.clamp(min=1)) if wrap_x else clamp(x0, wi)
    y0 = clamp(to_index(y0f), hi)
    wx = catmull_rom_weights(fx)
    wy = catmull_rom_weights(fy)
    wp = img.shape[-1]
    flat = img.reshape(-1)
    cols = [torch.remainder(x0 + (c - 1), wi) if wrap_x
            else clamp(x0 + (c - 1), wi) for c in range(4)]
    val = torch.zeros_like(x)
    for r in range(4):
        row = clamp(y0 + (r - 1), hi) * wp
        rowv = torch.zeros_like(x)
        for c in range(4):
            rowv = rowv + wx[c] * flat[row + cols[c]]
        val = val + wy[r] * rowv
    return val, valid


def shift2d(arr: torch.Tensor, dy: int, dx: int, *, fill=None,
            wrap_x: bool = False) -> torch.Tensor:
    """Static shift ``out[y, x] = arr[y + dy, x + dx]`` over the last two
    axes; ``fill=None`` edge-clamps, else out-of-range reads give ``fill``.
    ``wrap_x`` wraps the x axis (the sphere's longitude ring)."""
    h, w = arr.shape[-2:]
    out = arr
    if dx != 0 and wrap_x:
        out = torch.roll(out, -dx, -1)
    elif dx != 0:
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
