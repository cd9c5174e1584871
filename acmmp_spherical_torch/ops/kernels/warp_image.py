"""Source warps for the rectified context build (counterpart of
acmmp_spherical_tpu/ops/pallas/warp_image.py, both modes).

``warp_src_frames`` (bicubic mode: source images) and
``warp_src_disparities`` (disp mode: source depth maps, geometric passes)
launch ``csrc/warp_image.cu`` on CUDA tensors and run their ``*_plain``
versions on CPU tensors.
"""

from __future__ import annotations

import torch

from acmmp_spherical_torch.ops.kernels import _lib
from acmmp_spherical_torch.ops.rectify import (
    PAD_X, PAD_Y, SENTINEL, rect_coords, rect_frame_coords,
)
from acmmp_spherical_torch.ops.sampling import sample_bicubic


def _tile_gate(Hinv, width, height, rect_hw, warp_win, device):
    """(ty, tx) bool: the Pallas kernel's per-tile gate (warp_image.py:89-105)
    -- every corner in front of the frame, the corner bbox near the image,
    and the bbox inside the (WR, WC) DMA window."""
    hr, wr = rect_hw
    WR, WC = warp_win
    ty, tx = (hr + 2 * PAD_Y) // 8, (wr + 2 * PAD_X) // 128
    y00 = 8.0 * torch.arange(ty, dtype=torch.float32, device=device)[:, None] - PAD_Y
    x00 = 128.0 * torch.arange(tx, dtype=torch.float32, device=device)[None, :] - PAD_X
    y00, x00 = torch.broadcast_tensors(y00, x00)
    cz = [rect_coords(Hinv, x_, y_) for x_ in (x00, x00 + 127.0)
          for y_ in (y00, y00 + 7.0)]
    stack = lambda i: torch.stack([c[i] for c in cz])
    ox, oy, z = stack(0), stack(1), stack(2)
    cx_lo, cx_hi = ox.amin(0), ox.amax(0)
    cy_lo, cy_hi = oy.amin(0), oy.amax(0)
    return ((z.amin(0) > 1e-6) & (cx_hi >= -2.0) & (cx_lo < width + 2.0)
            & (cy_hi >= -2.0) & (cy_lo < height + 2.0)
            & (cx_hi - cx_lo < WC - 8.0) & (cy_hi - cy_lo < WR - 8.0))


def warp_src_frames_plain(src_images, Hinv, widths, heights, rect_hw,
                          warp_win):
    """Plain torch: (S, Hp, Wp) sources -> (S, hr+16, wr+256) rect frames,
    SENTINEL outside each footprint and on gated tiles."""
    S = src_images.shape[0]
    dev = src_images.device
    xs, ys = rect_frame_coords(rect_hw, dev)
    out = []
    for s in range(S):
        wd, ht = int(widths[s]), int(heights[s])
        ox, oy, z = rect_coords(Hinv[s], xs, ys)
        val, ok = sample_bicubic(src_images[s], ox, oy, wd, ht)
        keep = ok & (z > 0)
        if warp_win is not None:
            gate = _tile_gate(Hinv[s], float(widths[s]), float(heights[s]),
                              rect_hw, warp_win, dev)
            keep = keep & gate.repeat_interleave(8, 0).repeat_interleave(128, 1)
        out.append(torch.where(keep, val, torch.full_like(val, SENTINEL)))
    return torch.stack(out)


def warp_src_frames(src_images, Hinv, widths, heights, rect_hw, warp_win):
    """Sentinel-variant Catmull-Rom warp of every source into its pair's
    rect frame.  ``warp_win`` (WR, WC) enables the per-tile gate of the TPU
    kernel; None disables it (the reference's XLA warp has no gate)."""
    if src_images.device.type == "cpu":
        return warp_src_frames_plain(src_images, Hinv, widths, heights,
                                     rect_hw, warp_win)
    S, Hp, Wp = src_images.shape
    hr, wr = rect_hw
    HpR, WpR = hr + 2 * PAD_Y, wr + 2 * PAD_X
    dev = src_images.device
    _lib.require(src_images, "src_images", torch.float32, device=dev)
    consts = torch.cat([Hinv.reshape(S, 9), widths.reshape(S, 1),
                        heights.reshape(S, 1)], 1).to(torch.float32).contiguous()
    _lib.require(consts, "consts", torch.float32, (S, 11), dev)
    if HpR % 8 or WpR % 128:
        raise ValueError(f"rect frame {(HpR, WpR)} is not (8, 128)-tiled")
    out = torch.empty((S, HpR, WpR), dtype=torch.float32, device=dev)
    WR, WC = warp_win if warp_win is not None else (0, 0)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.acmmp_warp_src_frames(
            src_images.data_ptr(), consts.data_ptr(), out.data_ptr(), S, Hp,
            Wp, HpR, WpR, WR, WC, int(warp_win is not None),
            _lib.stream_ptr(out))
    _lib.check(err, "warp_src_frames")
    _lib.count_launch("warp_src_frames")
    return out


def warp_src_disparities_plain(src_depths, Hinv, R_sr, K_s, fB, widths,
                               heights, rect_hw, warp_win):
    """Plain torch: (S, Hp, Wp) source depth maps -> (S, hr+16, wr+256)
    implied rect disparities ``fB / z_rect`` of the trunc-nearest source
    depth (reference rectify.warp_disp), SENTINEL where the pixel falls off
    the source image or behind the frame, the depth is not positive, or the
    tile fails the gate."""
    S = src_depths.shape[0]
    dev = src_depths.device
    xs, ys = rect_frame_coords(rect_hw, dev)
    out = []
    for s in range(S):
        wd, ht = int(widths[s]), int(heights[s])
        ox, oy, z = rect_coords(Hinv[s], xs, ys)
        # int(ox) < wd  <=>  ox < wd  for ox >= 0 and an integer wd
        keep = (z > 0) & (ox >= 0.0) & (oy >= 0.0) & (ox < wd) & (oy < ht)
        xi = ox.clamp(0, wd - 1).to(torch.int64)         # C truncation
        yi = oy.clamp(0, ht - 1).to(torch.int64)
        zs = src_depths[s][yi, xi]
        u = (ox - K_s[s, 0, 2]) / K_s[s, 0, 0]
        v = (oy - K_s[s, 1, 2]) / K_s[s, 1, 1]
        z_rect = zs * (R_sr[s, 2, 0] * u + R_sr[s, 2, 1] * v + R_sr[s, 2, 2])
        disp = fB[s] / torch.clamp(z_rect, min=1e-6)
        keep = keep & (zs > 0) & (z_rect > 0)
        if warp_win is not None:
            gate = _tile_gate(Hinv[s], float(widths[s]), float(heights[s]),
                              rect_hw, warp_win, dev)
            keep = keep & gate.repeat_interleave(8, 0).repeat_interleave(128, 1)
        out.append(torch.where(keep, disp, torch.full_like(disp, SENTINEL)))
    return torch.stack(out)


def warp_src_disparities(src_depths, Hinv, R_sr, K_s, fB, widths, heights,
                         rect_hw, warp_win):
    """Implied rect disparity frames of the source depth maps (the
    geometric pass's ``rect_sdisp``).  ``warp_win`` (WR, WC) enables the
    per-tile gate of the TPU kernel; None disables it (the reference's XLA
    ``warp_disp`` has no gate)."""
    if src_depths.device.type == "cpu":
        return warp_src_disparities_plain(src_depths, Hinv, R_sr, K_s, fB,
                                          widths, heights, rect_hw, warp_win)
    S, Hp, Wp = src_depths.shape
    hr, wr = rect_hw
    HpR, WpR = hr + 2 * PAD_Y, wr + 2 * PAD_X
    dev = src_depths.device
    _lib.require(src_depths, "src_depths", torch.float32, device=dev)
    consts = torch.cat([
        Hinv.reshape(S, 9), widths.reshape(S, 1), heights.reshape(S, 1),
        fB.reshape(S, 1), R_sr[:, 2, :], K_s[:, 0, 0, None], K_s[:, 1, 1, None],
        K_s[:, 0, 2, None], K_s[:, 1, 2, None]], 1).to(torch.float32).contiguous()
    _lib.require(consts, "consts", torch.float32, (S, 19), dev)
    if HpR % 8 or WpR % 128:
        raise ValueError(f"rect frame {(HpR, WpR)} is not (8, 128)-tiled")
    out = torch.empty((S, HpR, WpR), dtype=torch.float32, device=dev)
    WR, WC = warp_win if warp_win is not None else (0, 0)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.acmmp_warp_src_disparities(
            src_depths.data_ptr(), consts.data_ptr(), out.data_ptr(), S, Hp,
            Wp, HpR, WpR, WR, WC, int(warp_win is not None),
            _lib.stream_ptr(out))
    _lib.check(err, "warp_src_disparities")
    _lib.count_launch("warp_src_disparities")
    return out
