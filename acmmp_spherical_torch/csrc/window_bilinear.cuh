// The windowed bilinear sample of window_sample.cu (kernel 7), after the
// Pallas kernels' `extract`/`_extract_bilinear`
// (ops/pallas/ncc_window.py:182-237, ops/pallas/window_sample.py:69-104),
// and the tile and window constants it shares with ncc_window.cu (kernel
// 6), whose tap loop applies the same rule with the in-image test merged
// into the window test.
//
// A sample at (px, py) belongs to the kWinH x kWinW window at storage origin
// (y0, x0) when its floored corner lies in [0, kWinW - 2] x [0, kWinH - 2]
// of it.  The value is read at the corner clamped into that range, so every
// read stays inside the window (which lies inside the padded frame); the +1
// corners are the next storage column and row, not clamped at the logical
// image border.  Interpolation runs within each row first, then across the
// two rows, as the Pallas kernels do.  The TPU stages the window in VMEM
// because its gathers are slow; on Hopper the frames stay in the 50 MB L2
// and the window is a predicate on direct loads at the same addresses.

#pragma once

#include <cuda_runtime.h>

namespace acmmp_window {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kWinH = 40;
constexpr int kWinW = 384;

// (int) of v after clamping to +-2^30, so far-off coordinates stay defined
// (they are rejected by the window test); truncates toward zero like C.
__device__ __forceinline__ int clamp_to_int(float v) {
  return (int)fminf(fmaxf(v, -1073741824.0f), 1073741824.0f);
}

__device__ __forceinline__ float window_bilinear(
    const float* __restrict__ frame, int Wp, int y0, int x0, float px,
    float py, bool& in_win) {
  const float pxf = floorf(px);
  const float pyf = floorf(py);
  const float fx = px - pxf;
  const float fy = py - pyf;
  const int relx = clamp_to_int(pxf) - x0;
  const int rely = clamp_to_int(pyf) - y0;
  in_win = relx >= 0 && relx <= kWinW - 2 && rely >= 0 && rely <= kWinH - 2;
  const int cx = min(max(relx, 0), kWinW - 2);
  const int cy = min(max(rely, 0), kWinH - 2);
  const float* p = frame + (long long)(y0 + cy) * Wp + (x0 + cx);
  const float g00 = __ldg(p), g01 = __ldg(p + 1);
  const float g10 = __ldg(p + Wp), g11 = __ldg(p + Wp + 1);
  const float a0 = g00 + (g01 - g00) * fx;
  const float a1 = g10 + (g11 - g10) * fx;
  return a0 + (a1 - a0) * fy;
}

}  // namespace acmmp_window
