"""Source-frame warp for the rectified context build (counterpart of
acmmp_spherical_tpu/ops/pallas/warp_image.py, bicubic mode).

``warp_src_frames`` launches ``csrc/warp_image.cu`` on CUDA tensors and runs
``warp_src_frames_plain`` on CPU tensors.
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
    _lib.LAUNCHES["warp_src_frames"] += 1
    return out
