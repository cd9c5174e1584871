// Sentinel-variant Catmull-Rom warp of the source images into their
// rectified frames, and the disparity warp of the source depth maps.
//
// Replaces: acmmp_spherical_tpu/ops/pallas/warp_image.py::warp_src_frames
// (kernel _warp_kernel, mode "bicubic") and ::warp_src_disparities (mode
// "disp", below).  Per rect pixel: apply Hinv in f32
// (the formula of rectify.rect_coords), take the edge-clamped 4x4
// Catmull-Rom sample, accumulate each tap row's column sum in tap-row order,
// and write SENTINEL where the pixel falls outside the source image or
// behind the rotated frame.  The Pallas kernel also writes SENTINEL for
// whole (8, 128) tiles that fail its gate (a corner behind the frame, corner
// bbox off-image, or corner bbox wider than its DMA window); the gate is
// kept here per tile, so every tile the TPU leaves SENTINEL stays SENTINEL.
//
// Bound on the H100: 16 gathered reads + 1 write per output pixel; the reads
// of neighbouring pixels overlap heavily (one output row walks a band of
// 4 source rows), so the traffic that reaches device memory is about one
// read of the source band per frame -- bytes, 0.03 ms at the bench point.
// Two thirds of the bench frames are SENTINEL, so the gate (four homographies,
// eight IEEE divisions) must not be paid per pixel: evaluated by every
// thread it costs more than the warp itself.  Design of the bicubic warp:
// one block per (8, 128) tile, each thread the 8 rows of one column; each
// warp evaluates the gate once, one corner per lane (mod 4), combined with
// two shuffle steps; a dead tile is filled with 16-byte SENTINEL stores; on
// a live tile each thread computes its pixels' coordinates (two IEEE
// divisions each) and reads the 16 taps through L1, its rows sharing three
// of their four source rows.  No window staging: the footprint of a tile in
// the source varies with the homography, and the caches already hold the
// band.  The disparity warp below has the same layout.

#include <cuda_runtime.h>

namespace {

constexpr float kSentinel = -1.0e4f;
constexpr int kPadY = 8;
constexpr int kPadX = 128;

struct Coords {
  float ox, oy, z;
};

__device__ __forceinline__ Coords rect_coords(const float* h, float x,
                                              float y) {
  Coords c;
  c.z = h[6] * x + h[7] * y + h[8];
  const float zs = fabsf(c.z) < 1e-9f ? 1e-9f : c.z;
  c.ox = (h[0] * x + h[1] * y + h[2]) / zs;
  c.oy = (h[3] * x + h[4] * y + h[5]) / zs;
  return c;
}

__device__ __forceinline__ void catmull_rom(float t, float w[4]) {
  const float t2 = t * t;
  const float t3 = t2 * t;
  w[0] = -0.5f * t3 + t2 - 0.5f * t;
  w[1] = 1.5f * t3 - 2.5f * t2 + 1.0f;
  w[2] = -1.5f * t3 + 2.0f * t2 + 0.5f * t;
  w[3] = 0.5f * t3 - 0.5f * t2;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floor_to_int(float v) {
  // clamp before the cast so far-off coordinates stay defined
  return (int)fminf(fmaxf(floorf(v), -1073741824.0f), 1073741824.0f);
}

// The Pallas kernel's per-tile gate (warp_image.py:89-105): every corner in
// front of the frame, the corner bbox near the image and inside the
// (WR, WC) window.  Uniform over the (8, 128) tile at (x00, y00); evaluated
// once per warp: lane k (mod 4) maps corner k and two shuffle steps combine
// the four.  Needs every lane of the warp.
__device__ __forceinline__ bool tile_live_warp(const float* h, float x00,
                                               float y00, float wi, float hi,
                                               int WR, int WC) {
  const int k = threadIdx.x & 3;
  const Coords c = rect_coords(h, (k & 2) ? x00 + 127.0f : x00,
                               (k & 1) ? y00 + 7.0f : y00);
  float z_lo = c.z, cx_lo = c.ox, cx_hi = c.ox, cy_lo = c.oy, cy_hi = c.oy;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    z_lo = fminf(z_lo, __shfl_xor_sync(0xffffffffu, z_lo, o));
    cx_lo = fminf(cx_lo, __shfl_xor_sync(0xffffffffu, cx_lo, o));
    cx_hi = fmaxf(cx_hi, __shfl_xor_sync(0xffffffffu, cx_hi, o));
    cy_lo = fminf(cy_lo, __shfl_xor_sync(0xffffffffu, cy_lo, o));
    cy_hi = fmaxf(cy_hi, __shfl_xor_sync(0xffffffffu, cy_hi, o));
  }
  return z_lo > 1e-6f && cx_hi >= -2.0f && cx_lo < wi + 2.0f &&
         cy_hi >= -2.0f && cy_lo < hi + 2.0f &&
         (cx_hi - cx_lo < (float)WC - 8.0f) && (cy_hi - cy_lo < (float)WR - 8.0f);
}

constexpr int kRows = 8;                   // tile rows per thread
constexpr int kSrcThreads = 128 * 8 / kRows;

__global__ void __launch_bounds__(kSrcThreads)
warp_src_kernel(const float* __restrict__ imgs, const float* __restrict__ consts,
                float* __restrict__ out, int Hp, int Wp, int HpR, int WpR,
                int WR, int WC, int gate) {
  const int s = blockIdx.z;
  float h[11];
#pragma unroll
  for (int i = 0; i < 11; ++i) h[i] = consts[s * 11 + i];
  const float wi = h[9], hi = h[10];
  const float x00 = 128.0f * (float)blockIdx.x - (float)kPadX;
  const float y00 = 8.0f * (float)blockIdx.y - (float)kPadY;
  float* tile = out + ((long long)s * HpR + blockIdx.y * 8) * WpR +
                blockIdx.x * 128;

  if (gate && !tile_live_warp(h, x00, y00, wi, hi, WR, WC)) {
    const float4 sv = make_float4(kSentinel, kSentinel, kSentinel, kSentinel);
    for (int i = threadIdx.y * 128 + threadIdx.x; i < 256; i += kSrcThreads)
      reinterpret_cast<float4*>(tile + (i >> 5) * WpR)[i & 31] = sv;
    return;
  }

  const float xs = (float)threadIdx.x + x00;
  const int wi_i = (int)wi, hi_i = (int)hi;
  const float* img = imgs + (long long)s * Hp * Wp;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = threadIdx.y * kRows + r;
    const Coords c = rect_coords(h, xs, (float)row + y00);
    const bool valid = (c.z > 0.0f) && (c.ox >= 0.0f) && (c.ox < wi) &&
                       (c.oy >= 0.0f) && (c.oy < hi);
    float acc = kSentinel;
    if (valid) {
      const float x0f = floorf(c.ox), y0f = floorf(c.oy);
      const int xa = clampi(floor_to_int(c.ox), 0, wi_i - 1);
      const int ya = clampi(floor_to_int(c.oy), 0, hi_i - 1);
      float wx[4], wy[4];
      catmull_rom(c.ox - x0f, wx);
      catmull_rom(c.oy - y0f, wy);
      int cols[4];
      for (int k = 0; k < 4; ++k) cols[k] = clampi(xa + k - 1, 0, wi_i - 1);
      acc = 0.0f;
      for (int q = 0; q < 4; ++q) {
        const float* src = img + (long long)clampi(ya + q - 1, 0, hi_i - 1) * Wp;
        float rsum = wx[0] * src[cols[0]];
        for (int k = 1; k < 4; ++k) rsum = rsum + wx[k] * src[cols[k]];
        acc = acc + wy[q] * rsum;
      }
    }
    tile[row * WpR + threadIdx.x] = acc;
  }
}

// Disparity warp (mode "disp"): per rect pixel, the source depth at the
// truncated source pixel of Hinv (x, y) (the reference's depth reads,
// ACMMP.cu:657), turned into the implied rect disparity fB / z_rect with
// z_rect = depth * (R_sr[2] . ((ox - cx) / fx, (oy - cy) / fy, 1)) -- the
// float ox, oy, not the truncated ones.  SENTINEL where z <= 0, the pixel is
// off the source image (ox, oy >= 0 first, then the truncated index below
// the width/height), the depth or z_rect is not positive, or the tile fails
// the gate.
//
// Bound on the H100: one gathered read + one write per output pixel -- at
// the bench point 75 MB of output (8 x 1312 x 1792 f32) and 25 MB of source
// depths (8 x 768 x 1024 f32), 0.030 ms (bytes).  Design: the bicubic
// warp's -- one block per (8, 128) tile, each thread kDispRows rows of one
// column, the pair's 19 constants in registers, the gate once per warp,
// 16-byte SENTINEL stores for a dead tile.  A live pixel costs its
// coordinates (two IEEE divisions), the in-image test, one truncated-nearest
// depth read through L1/L2, u and v (two IEEE divisions by fx and fy, as the
// plain version divides, not reciprocals), z_rect and fB / max(z_rect,
// 1e-6).  Measured at 1.6x the bound (PERF.md section 6: 8 rows per thread
// the fastest of 1-8): the 100 MB move at about 2 TB/s, while a live
// tile's threads run five dependent IEEE divisions per row before its
// store; no counter here tells the two apart.
constexpr int kDispRows = 8;                 // tile rows per thread
constexpr int kDispThreads = 128 * 8 / kDispRows;

__global__ void __launch_bounds__(kDispThreads)
warp_disp_kernel(const float* __restrict__ depths,
                 const float* __restrict__ consts, float* __restrict__ out,
                 int Hp, int Wp, int HpR, int WpR, int WR, int WC, int gate) {
  const int s = blockIdx.z;
  float h[19];
#pragma unroll
  for (int i = 0; i < 19; ++i) h[i] = consts[s * 19 + i];
  const float wi = h[9], hi = h[10];
  const float x00 = 128.0f * (float)blockIdx.x - (float)kPadX;
  const float y00 = 8.0f * (float)blockIdx.y - (float)kPadY;
  float* tile = out + ((long long)s * HpR + blockIdx.y * 8) * WpR +
                blockIdx.x * 128;

  if (gate && !tile_live_warp(h, x00, y00, wi, hi, WR, WC)) {
    const float4 sv = make_float4(kSentinel, kSentinel, kSentinel, kSentinel);
    for (int i = threadIdx.y * 128 + threadIdx.x; i < 256; i += kDispThreads)
      reinterpret_cast<float4*>(tile + (i >> 5) * WpR)[i & 31] = sv;
    return;
  }

  const float xs = (float)threadIdx.x + x00;
  const float* dep = depths + (long long)s * Hp * Wp;
#pragma unroll
  for (int r = 0; r < kDispRows; ++r) {
    const int row = threadIdx.y * kDispRows + r;
    const Coords c = rect_coords(h, xs, (float)row + y00);
    float res = kSentinel;
    // ox < wi  <=>  (int)ox < wi  for ox >= 0 and an integer-valued wi
    if ((c.z > 0.0f) && (c.ox >= 0.0f) && (c.oy >= 0.0f) && (c.ox < wi) &&
        (c.oy < hi)) {
      const int xi = (int)c.ox, yi = (int)c.oy;  // C truncation, both >= 0
      const float zs = dep[(long long)yi * Wp + xi];
      const float u = (c.ox - h[17]) / h[15];
      const float v = (c.oy - h[18]) / h[16];
      const float z_rect = zs * (h[12] * u + h[13] * v + h[14]);
      const float disp = h[11] / fmaxf(z_rect, 1e-6f);
      if (zs > 0.0f && z_rect > 0.0f) res = disp;
    }
    tile[row * WpR + threadIdx.x] = res;
  }
}

}  // namespace

// imgs (S, Hp, Wp) f32; consts (S, 11) f32: Hinv row-major, width, height;
// out (S, HpR, WpR) f32 with HpR % 8 == 0 and WpR % 128 == 0.  ``gate``
// enables the per-tile gate with the claimant window (WR, WC).
extern "C" int acmmp_warp_src_frames(const float* imgs, const float* consts,
                                     float* out, int S, int Hp, int Wp,
                                     int HpR, int WpR, int WR, int WC,
                                     int gate, cudaStream_t stream) {
  dim3 block(128, 8 / kRows);
  dim3 grid(WpR / 128, HpR / 8, S);
  warp_src_kernel<<<grid, block, 0, stream>>>(imgs, consts, out, Hp, Wp, HpR,
                                              WpR, WR, WC, gate);
  return (int)cudaGetLastError();
}

// depths (S, Hp, Wp) f32; consts (S, 19) f32: Hinv row-major, width, height,
// fB, R_sr[2, :], fx, fy, cx, cy of the source camera; out (S, HpR, WpR) f32.
extern "C" int acmmp_warp_src_disparities(const float* depths,
                                          const float* consts, float* out,
                                          int S, int Hp, int Wp, int HpR,
                                          int WpR, int WR, int WC, int gate,
                                          cudaStream_t stream) {
  dim3 block(128, 8 / kDispRows);
  dim3 grid(WpR / 128, HpR / 8, S);
  warp_disp_kernel<<<grid, block, 0, stream>>>(depths, consts, out, Hp, Wp,
                                               HpR, WpR, WR, WC, gate);
  return (int)cudaGetLastError();
}
