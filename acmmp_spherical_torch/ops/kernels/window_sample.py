"""Standalone windowed bilinear sampler (counterpart of
acmmp_spherical_tpu/ops/pallas/window_sample.py).

Per 8x128 tile of the sample grid a WIN_H x WIN_W source window is placed
``margin`` pixels before the tile's minimum coordinate, in the reference's
int32 arithmetic (``compute_window_offsets``); a sample is ``ok`` where it
lies in the logical image and its floored corner in the window, and its
value is the bilinear interpolation read from the window (0 where not ok),
with the window rule of kernel 6 (``ncc_window.window_bilinear_plain``).

* ``windowed_sample_plain`` -- plain torch: the origins, then
  ``sample_window_plain``;
* ``windowed_sample`` -- kernel ``window_sample`` (csrc/window_sample.cu,
  one launch that computes each tile's origin itself) on CUDA tensors, the
  plain version on CPU tensors.
"""

from __future__ import annotations

import torch

from acmmp_spherical_torch.ops.kernels import _lib
from acmmp_spherical_torch.ops.kernels.ncc_window import (
    TILE_H, TILE_W, WIN_H, WIN_W, _window_origin, pad_to_window,
    window_bilinear_plain,
)


MARGIN = 2  # pixels kept before each tile's minimum coordinate


def compute_window_offsets(x: torch.Tensor, y: torch.Tensor, src_h: int,
                           src_w: int, *, margin: int = MARGIN):
    """Per-tile window origins (off_y, off_x), int32 (H/8, W/128), from the
    sample coordinates (H, W): the tile's minimum finite coordinate sits
    ``margin`` px inside the window, which is aligned to the tile grid and
    clamped inside the (src_h, src_w) storage (``_window_origin``: the
    reference's int32 arithmetic).  Plain torch; the kernel computes the
    same origins itself."""
    H, W = x.shape
    ty, tx = H // TILE_H, W // TILE_W
    tmin = lambda v: torch.where(torch.isfinite(v), v, 1e9).reshape(
        ty, TILE_H, tx, TILE_W).amin((1, 3))
    off_y = _window_origin(tmin(y), margin, TILE_H, src_h, WIN_H)
    off_x = _window_origin(tmin(x), margin, TILE_W, src_w, WIN_W)
    return (off_y.to(torch.int32).contiguous(),
            off_x.to(torch.int32).contiguous())


def _check_grid(x):
    H, W = x.shape
    if H % TILE_H or W % TILE_W:
        raise ValueError(f"the sample grid {(H, W)} must be a multiple of "
                         f"the {TILE_H}x{TILE_W} tile")


def sample_window_plain(src, off_y, off_x, x, y, src_h: int, src_w: int):
    """Plain torch kernel 7 at given window origins: (value, ok) of each
    sample, value 0 where not ok."""
    H, W = x.shape
    ty, tx = off_y.shape
    tile = lambda off: off.to(torch.int64).reshape(ty, 1, tx, 1).expand(
        ty, TILE_H, tx, TILE_W).reshape(1, H, W)
    val, in_win = window_bilinear_plain(src.reshape(1, -1), src.shape[1],
                                        tile(off_y), tile(off_x), x[None],
                                        y[None])
    ok = in_win[0] & (x >= 0.0) & (x < src_w) & (y >= 0.0) & (y < src_h)
    return torch.where(ok, val[0], 0.0), ok


def windowed_sample(src, x, y, *, src_h: int, src_w: int):
    """Bilinear samples of ``src`` (Hp, Wp) at (x, y) (H, W), H and W
    multiples of 8 and 128, through per-tile windows: (value, ok), ok False
    where the sample left its window or the logical (src_h, src_w) image.
    Kernel 7 on CUDA tensors: one launch, the window origins included."""
    if src.device.type == "cpu":
        return windowed_sample_plain(src, x, y, src_h=src_h, src_w=src_w)
    _check_grid(x)
    src = pad_to_window(src[None])[0]
    x, y = x.contiguous(), y.contiguous()
    Hp, Wp = src.shape
    H, W = x.shape
    dev = src.device
    if (H // TILE_H) * (W // TILE_W) >= 2 ** 31:
        raise ValueError(f"window_sample: grid {(H, W)} is not supported")
    _lib.require(src, "src", torch.float32, (Hp, Wp), dev)
    _lib.require(x, "x", torch.float32, (H, W), dev)
    _lib.require(y, "y", torch.float32, (H, W), dev)
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("window_sample: x and y must be 16-byte aligned")
    val = torch.empty((H, W), dtype=torch.float32, device=dev)
    ok = torch.empty((H, W), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _lib.library().acmmp_window_sample(
            src.data_ptr(), x.data_ptr(), y.data_ptr(), val.data_ptr(),
            ok.data_ptr(), H, W, Hp, Wp, MARGIN, float(src_h), float(src_w),
            _lib.stream_ptr(val))
    _lib.check(err, "window_sample")
    _lib.LAUNCHES["window_sample"] += 1
    return val, ok


def windowed_sample_plain(src, x, y, *, src_h: int, src_w: int):
    """``windowed_sample`` through the plain version on any device."""
    _check_grid(x)
    src = pad_to_window(src[None])[0]
    off_y, off_x = compute_window_offsets(x, y, *src.shape)
    return sample_window_plain(src, off_y, off_x, x, y, src_h, src_w)
