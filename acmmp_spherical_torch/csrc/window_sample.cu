// Standalone windowed bilinear sampler on (8, 128) tiles of a sample grid,
// with each tile's window origin computed in the kernel.
//
// Replaces: acmmp_spherical_tpu/ops/pallas/window_sample.py::windowed_sample
// (kernel _sample_kernel) together with its XLA pre-pass
// compute_window_offsets.  Per tile the window origin is the tile's minimum
// finite coordinate (1e9 for a non-finite one) floored, saturated to int32
// (XLA's convert), less the margin with int32 wraparound, floored to the
// tile grid and clipped inside the padded frame; per sample the value
// follows the window rule of window_bilinear.cuh (shared with
// ncc_window.cu), ok = in the window and in the logical image, value 0
// where not ok.
//
// Bound on the H100: per sample 2 coordinates read, 4 gathered source reads
// (one frame, from L2), ~17 fp32 operations, 5 bytes written -- bytes: x, y,
// the frame and the outputs, 13.4 MB and 0.004 ms for a 1024x768 frame.
// Design: one 256-thread block per tile, each thread 4 neighbouring samples
// of one row, read as two 16-byte vectors (x, y) and written as a 16-byte
// vector (values) and a 4-byte word (ok).  The block reduces the tile's
// minima by warp shuffles and one shared-memory step, so the origins cost no
// launches of their own (the reference's pre-pass is about 20 device
// kernels per call in plain torch).  The window is a predicate on direct
// loads, not a copy.  At 1024x768 the kernel runs within 10% of its bound
// (PERF.md section 6); a call of its wrapper costs ten times the kernel, in
// the host's argument checks and launch.

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
constexpr int kPerThread = kTileH * kTileW / kThreads;  // 4: one float4
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e9f;  // stands in for a non-finite coordinate

static_assert(kPerThread == 4 && kTileW / kPerThread == 32,
              "a warp covers one tile row as float4 vectors");

__device__ __forceinline__ float finite_or_big(float v) {
  // finite <=> the exponent bits are not all ones
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u ? v : kBig;
}

// The reference's origin: floor, XLA's saturating convert to int32, minus
// ``margin`` with int32 wraparound (done on unsigned values: signed
// overflow is undefined), floored to a multiple of the power-of-two
// ``tile`` (two's complement: v & -tile), clipped to [0, max_off].
__device__ __forceinline__ int window_origin(float vmin, int margin, int tile,
                                             int max_off) {
  const float f = floorf(vmin);
  const int v = f >= 2147483648.0f    ? 2147483647
                : f <= -2147483648.0f ? (-2147483647 - 1)
                                      : (int)f;
  const int m = (int)((unsigned)v - (unsigned)margin);
  return min(max(m & -tile, 0), max_off);
}

__global__ void __launch_bounds__(kThreads)
window_sample_kernel(const float* __restrict__ src,
                     const float* __restrict__ xs,
                     const float* __restrict__ ys,
                     float* __restrict__ out, uint8_t* __restrict__ ok_out,
                     int W, int Wp, int max_y, int max_x, int margin,
                     float src_h, float src_w) {
  __shared__ float s_min[2][kWarps];
  const int tx = W / kTileW;
  const int ti = blockIdx.x / tx, tj = blockIdx.x - ti * tx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pix =
      (long long)(ti * kTileH + warp) * W + tj * kTileW + lane * kPerThread;
  const float4 x4 = *reinterpret_cast<const float4*>(xs + pix);
  const float4 y4 = *reinterpret_cast<const float4*>(ys + pix);
  const float px[kPerThread] = {x4.x, x4.y, x4.z, x4.w};
  const float py[kPerThread] = {y4.x, y4.y, y4.z, y4.w};

  float xmin = finite_or_big(px[0]), ymin = finite_or_big(py[0]);
#pragma unroll
  for (int k = 1; k < kPerThread; ++k) {
    xmin = fminf(xmin, finite_or_big(px[k]));
    ymin = fminf(ymin, finite_or_big(py[k]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    xmin = fminf(xmin, __shfl_xor_sync(0xffffffffu, xmin, o));
    ymin = fminf(ymin, __shfl_xor_sync(0xffffffffu, ymin, o));
  }
  if (lane == 0) {
    s_min[0][warp] = xmin;
    s_min[1][warp] = ymin;
  }
  __syncthreads();
  xmin = s_min[0][0];
  ymin = s_min[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    xmin = fminf(xmin, s_min[0][w]);
    ymin = fminf(ymin, s_min[1][w]);
  }
  const int y0 = window_origin(ymin, margin, kTileH, max_y);
  const int x0 = window_origin(xmin, margin, kTileW, max_x);

  float val[kPerThread];
  uint32_t ok_word = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    bool in_win;
    const float v = window_bilinear(src, Wp, y0, x0, px[k], py[k], in_win);
    const bool ok = in_win && px[k] >= 0.0f && px[k] < src_w &&
                    py[k] >= 0.0f && py[k] < src_h;
    val[k] = ok ? v : 0.0f;
    ok_word |= (ok ? 1u : 0u) << (8 * k);  // little-endian bytes
  }
  *reinterpret_cast<float4*>(out + pix) =
      make_float4(val[0], val[1], val[2], val[3]);
  *reinterpret_cast<uint32_t*>(ok_out + pix) = ok_word;
}

}  // namespace

// src (Hp, Wp) f32 padded frame (Hp >= 40, Wp >= 384); xs, ys (H, W) f32
// sample coordinates and out (H, W) f32, 16-byte aligned; ok (H, W) bool
// (one byte each), 4-byte aligned; (src_h, src_w) the logical image size;
// ``margin`` the pixels kept before each tile's minimum coordinate.
extern "C" int acmmp_window_sample(const float* src, const float* xs,
                                   const float* ys, float* out, uint8_t* ok,
                                   int H, int W, int Hp, int Wp, int margin,
                                   float src_h, float src_w,
                                   cudaStream_t stream) {
  if (H % kTileH || W % kTileW || Hp < kWinH || Wp < kWinW)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (H / kTileH) * (W / kTileW);
  const int max_y = (Hp - kWinH) / kTileH * kTileH;
  const int max_x = (Wp - kWinW) / kTileW * kTileW;
  if (n_tiles > 0)
    window_sample_kernel<<<n_tiles, kThreads, 0, stream>>>(
        src, xs, ys, out, ok, W, Wp, max_y, max_x, margin, src_h, src_w);
  return (int)cudaGetLastError();
}
