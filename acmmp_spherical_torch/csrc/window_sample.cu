// Standalone windowed bilinear sampler on (8, 128) tiles of a sample grid.
//
// Replaces: acmmp_spherical_tpu/ops/pallas/window_sample.py::windowed_sample
// (kernel _sample_kernel).  Per tile the window origin comes from the
// plain-torch pre-pass (compute_window_offsets, margin 2); per sample the
// value follows the window rule of window_bilinear.cuh (shared with
// ncc_window.cu), ok = in the window and in the logical image, value 0
// where not ok.
//
// Bound on the H100: per sample 2 coordinates read, 4 gathered source reads
// (from L2: one frame), ~12 fp32 operations, 5 bytes written -- a memory
// kernel, ~13 bytes per sample of device traffic.  Design: one block per
// tile, 256 threads with 4 samples each, coalesced coordinate reads and
// output writes; the window is a predicate on direct loads, not a copy.

#include <cuda_runtime.h>
#include <cstdint>

#include "window_bilinear.cuh"

namespace {

using acmmp_window::kTileH;
using acmmp_window::kTileW;
using acmmp_window::kWinH;
using acmmp_window::kWinW;
using acmmp_window::window_bilinear;

constexpr int kThreads = 256;
constexpr int kPixPerThread = kTileH * kTileW / kThreads;

__global__ void __launch_bounds__(kThreads)
window_sample_kernel(const float* __restrict__ src,
                     const int32_t* __restrict__ off_y,
                     const int32_t* __restrict__ off_x,
                     const float* __restrict__ xs,
                     const float* __restrict__ ys,
                     float* __restrict__ out, uint8_t* __restrict__ ok_out,
                     int W, int Wp, float src_h, float src_w) {
  const int tile = blockIdx.x;
  const int tx = W / kTileW;
  const int ti = tile / tx, tj = tile - ti * tx;
  const int y0 = off_y[tile], x0 = off_x[tile];
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = k * kThreads + threadIdx.x;
    const int r = p / kTileW, l = p - r * kTileW;
    const long long pix = (long long)(ti * kTileH + r) * W + tj * kTileW + l;
    const float x = xs[pix], y = ys[pix];
    bool in_win;
    const float val = window_bilinear(src, Wp, y0, x0, x, y, in_win);
    const bool ok = in_win && x >= 0.0f && x < src_w && y >= 0.0f &&
                    y < src_h;
    out[pix] = ok ? val : 0.0f;
    ok_out[pix] = ok ? 1 : 0;
  }
}

}  // namespace

// src (Hp, Wp) f32 padded frame (Hp >= 40, Wp >= 384); off_y, off_x
// (H/8, W/128) int32 window origins; xs, ys (H, W) f32 sample coordinates;
// out (H, W) f32 and ok (H, W) bool (one byte each); (src_h, src_w) the
// logical image size.
extern "C" int acmmp_window_sample(const float* src, const int32_t* off_y,
                                   const int32_t* off_x, const float* xs,
                                   const float* ys, float* out, uint8_t* ok,
                                   int H, int W, int Hp, int Wp, float src_h,
                                   float src_w, cudaStream_t stream) {
  if (H % kTileH || W % kTileW || Hp < kWinH || Wp < kWinW)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (H / kTileH) * (W / kTileW);
  if (n_tiles > 0)
    window_sample_kernel<<<n_tiles, kThreads, 0, stream>>>(
        src, off_y, off_x, xs, ys, out, ok, W, Wp, src_h, src_w);
  return (int)cudaGetLastError();
}
