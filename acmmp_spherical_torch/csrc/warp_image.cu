// Sentinel-variant Catmull-Rom warp of the source images into their
// rectified frames.
//
// Replaces: acmmp_spherical_tpu/ops/pallas/warp_image.py::warp_src_frames
// (kernel _warp_kernel, mode "bicubic").  Per rect pixel: apply Hinv in f32
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
// read of the source band per frame.  Design: one thread per rect pixel, a
// (128, 8) block per rect tile so the tile gate is uniform in a block and
// output stores are coalesced; taps are read through L1 straight from
// global memory.  No window staging: the footprint of a tile in the source
// varies with the homography, and the caches already hold the band.

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

__global__ void __launch_bounds__(1024)
warp_src_kernel(const float* __restrict__ imgs, const float* __restrict__ consts,
                float* __restrict__ out, int Hp, int Wp, int HpR, int WpR,
                int WR, int WC, int gate) {
  const int s = blockIdx.z;
  const int tx = blockIdx.x, ty = blockIdx.y;
  const float* h = consts + s * 11;
  const float wi = h[9], hi = h[10];
  const float x00 = 128.0f * (float)tx - (float)kPadX;
  const float y00 = 8.0f * (float)ty - (float)kPadY;
  const int px = tx * 128 + threadIdx.x;
  const int py = ty * 8 + threadIdx.y;
  float* dst = out + ((long long)s * HpR + py) * WpR + px;

  if (gate) {
    const Coords c0 = rect_coords(h, x00, y00);
    const Coords c1 = rect_coords(h, x00, y00 + 7.0f);
    const Coords c2 = rect_coords(h, x00 + 127.0f, y00);
    const Coords c3 = rect_coords(h, x00 + 127.0f, y00 + 7.0f);
    const bool corners_ok = fminf(fminf(c0.z, c1.z), fminf(c2.z, c3.z)) > 1e-6f;
    const float cx_lo = fminf(fminf(c0.ox, c1.ox), fminf(c2.ox, c3.ox));
    const float cx_hi = fmaxf(fmaxf(c0.ox, c1.ox), fmaxf(c2.ox, c3.ox));
    const float cy_lo = fminf(fminf(c0.oy, c1.oy), fminf(c2.oy, c3.oy));
    const float cy_hi = fmaxf(fmaxf(c0.oy, c1.oy), fmaxf(c2.oy, c3.oy));
    const bool live = corners_ok && cx_hi >= -2.0f && cx_lo < wi + 2.0f &&
                      cy_hi >= -2.0f && cy_lo < hi + 2.0f &&
                      (cx_hi - cx_lo < (float)WC - 8.0f) &&
                      (cy_hi - cy_lo < (float)WR - 8.0f);
    if (!live) {
      *dst = kSentinel;
      return;
    }
  }

  const float xs = (float)threadIdx.x + x00;
  const float ys = (float)threadIdx.y + y00;
  const Coords c = rect_coords(h, xs, ys);
  const bool valid = (c.z > 0.0f) && (c.ox >= 0.0f) && (c.ox < wi) &&
                     (c.oy >= 0.0f) && (c.oy < hi);
  if (!valid) {
    *dst = kSentinel;
    return;
  }
  const int wi_i = (int)wi, hi_i = (int)hi;
  const float x0f = floorf(c.ox), y0f = floorf(c.oy);
  const int xa = clampi(floor_to_int(c.ox), 0, wi_i - 1);
  const int ya = clampi(floor_to_int(c.oy), 0, hi_i - 1);
  float wx[4], wy[4];
  catmull_rom(c.ox - x0f, wx);
  catmull_rom(c.oy - y0f, wy);
  const float* img = imgs + (long long)s * Hp * Wp;
  int cols[4];
  for (int k = 0; k < 4; ++k) cols[k] = clampi(xa + k - 1, 0, wi_i - 1);
  float acc = 0.0f;
  for (int r = 0; r < 4; ++r) {
    const float* row = img + (long long)clampi(ya + r - 1, 0, hi_i - 1) * Wp;
    float rsum = wx[0] * row[cols[0]];
    for (int k = 1; k < 4; ++k) rsum = rsum + wx[k] * row[cols[k]];
    acc = acc + wy[r] * rsum;
  }
  *dst = acc;
}

}  // namespace

// imgs (S, Hp, Wp) f32; consts (S, 11) f32: Hinv row-major, width, height;
// out (S, HpR, WpR) f32 with HpR % 8 == 0 and WpR % 128 == 0.  ``gate``
// enables the per-tile gate with the claimant window (WR, WC).
extern "C" int acmmp_warp_src_frames(const float* imgs, const float* consts,
                                     float* out, int S, int Hp, int Wp,
                                     int HpR, int WpR, int WR, int WC,
                                     int gate, cudaStream_t stream) {
  dim3 block(128, 8);
  dim3 grid(WpR / 128, HpR / 8, S);
  warp_src_kernel<<<grid, block, 0, stream>>>(imgs, consts, out, Hp, Wp, HpR,
                                              WpR, WR, WC, gate);
  return (int)cudaGetLastError();
}
