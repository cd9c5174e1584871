// Rectified bilateral-NCC cost of C affine disparity fields against S
// rectified source frames, on the compacted live (8, 128) tiles.
//
// Replaces: acmmp_spherical_tpu/ops/pallas/ncc_rect.py::run_rect_kernel
// (kernel _rect_kernel, photometric variant, rect_tap_pack=False).  Per
// tile and candidate the kernel places a source window at the tile-min of
// x - clip(D, dlo, dhi) (128-aligned, clamped), samples the 36 taps (11x11,
// stride 2) bilinearly in x on the tap's own row at x + dx - (D + A dx +
// B dy), rejects taps outside [0, win_w - 2] of the window or on a SENTINEL
// neighbour, checks the centre sample and D > 0, and returns 1 - NCC of the
// bilateral-weighted moments, clamped to [0, cost_max].  These per-tile
// rules are part of the algorithm and are kept exactly.
//
// Bound on the H100: per (pixel, candidate) 36 taps x (2 gathered source
// reads + ~30 flops + 1 reciprocal); at the bench point (C=9, S=8,
// N=960 tiles) that is ~2.5 G taps per C=9 call, so the kernel is bound by
// load and ALU throughput in the tap loop, not by device-memory bytes (the
// frames stay in L2).  Design: one block per (live tile, pair), one thread per
// pixel (1024 threads).  The reference side of the window (24 x 384 values
// and their colour exponentials ep) is staged once per block in shared
// memory (72 KB) and shared by all C candidates; the TPU kernel's per-tap
// weight scratch (3 x 36 x 8 x 128 f32 = 442 KB) does not fit in shared
// memory, so each candidate recomputes its tap weight from ep (one
// reciprocal and a few multiplies).  Source taps are read straight from
// global memory (through L1/L2).  The window origin needs a block-wide
// minimum per candidate (warp shuffles + one shared-memory pass).  Compiled
// with -fmad=false so sums and products round exactly like the plain-torch
// version's separate operations.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kWinH = 24;
constexpr int kRefWinW = 384;
constexpr int kPadX = 128;
constexpr float kSentinelThresh = -0.5f;
constexpr int kMaxTaps = 64;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int floor_to_int(float v) {
  // clamp before the cast so far-off taps stay defined (they are rejected)
  return (int)fminf(fmaxf(floorf(v), -1073741824.0f), 1073741824.0f);
}

__global__ void __launch_bounds__(1024)
rect_ncc_kernel(const float* __restrict__ srow, const int32_t* __restrict__ tile_oy,
                const int32_t* __restrict__ tile_ox,
                const float* __restrict__ rect_ref,
                const float* __restrict__ rect_src,
                const float* __restrict__ Dp, const uint32_t* __restrict__ ABp,
                const float* __restrict__ fwd_valid, float* __restrict__ out,
                int C, int S, int N, int Hp, int Wp, int win_w, int radius,
                int increment, float inv_2sc, float clampv, float cost_max,
                double inv_2ss) {
  extern __shared__ float smem[];
  float* ref_s = smem;                      // (24, 384) reference window
  float* ep_s = smem + kWinH * kRefWinW;    // exp(clip(ref) * inv_2sc)
  __shared__ float sw_s[kMaxTaps];
  __shared__ float red_s[32];
  __shared__ float min_s;

  const int k = blockIdx.x, s = blockIdx.y;
  const int l = threadIdx.x, r = threadIdx.y;
  const int tid = r * kTileW + l;
  const int K8 = N * kTileH;
  const long long plane = (long long)S * K8 * kTileW;
  const long long pix = ((long long)s * K8 + k * kTileH + r) * kTileW + l;

  const bool valid = fwd_valid[pix] > 0.5f;
  if (!__syncthreads_or(valid)) {
    for (int c = 0; c < C; ++c) out[c * plane + pix] = cost_max;
    return;
  }

  const int oy = tile_oy[s * N + k];
  const int ox = tile_ox[s * N + k];
  const float* ref_frame = rect_ref + (long long)s * Hp * Wp;
  for (int i = tid; i < kWinH * kRefWinW; i += kTileH * kTileW) {
    const int rr = i / kRefWinW, cc = i - rr * kRefWinW;
    const float v = ref_frame[(long long)(oy + rr) * Wp + ox + cc];
    ref_s[i] = v;
    ep_s[i] = expf(fminf(fmaxf(v, -clampv), clampv) * inv_2sc);
  }
  int n_off = 0;
  for (int d = -radius; d <= radius; d += increment) ++n_off;
  if (tid < n_off * n_off) {
    const int dy = -radius + (tid / n_off) * increment;
    const int dx = -radius + (tid % n_off) * increment;
    sw_s[tid] = (float)exp(-sqrt((double)(dx * dx + dy * dy)) * inv_2ss);
  }
  __syncthreads();

  const int cen = (kTileH + r) * kRefWinW + kTileW + l;
  const float cen_p = ep_s[cen];
  const float cen_n = 1.0f / cen_p;
  const float dlo = srow[s * 128 + 0];
  const float dhi = srow[s * 128 + 1];
  const float xg = (float)ox + (float)l;
  const float* src_frame = rect_src + (long long)s * Hp * Wp;
  const int warp = tid >> 5, lane = tid & 31;

  for (int c = 0; c < C; ++c) {
    const long long ci = c * plane + pix;
    const float D = Dp[ci];
    const uint32_t ab = ABp[ci];
    const float A = __uint_as_float(ab & 0xFFFF0000u);
    const float B = __uint_as_float(ab << 16);

    // window origin: tile-min of x - clip(D), 128-aligned and clamped
    float m = warp_min(xg - fminf(fmaxf(D, dlo), dhi));
    if (lane == 0) red_s[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = warp_min(red_s[lane]);
      if (lane == 0) min_s = m;
    }
    __syncthreads();
    int cmin = floor_to_int((min_s - 6.0f) / 128.0f) * kTileW;
    cmin = min(max(cmin, -kPadX), Wp - kPadX - win_w);

    // bilinear-in-x sample of tap (dx, dy); false when rejected
    auto sample = [&](float dx, float dyf, int dy, float& val) -> bool {
      const float xsrc = xg + dx - (D + A * dx + B * dyf);
      const float xf = floorf(xsrc);
      const int rel = floor_to_int(xsrc) - cmin;
      if (rel < 0 || rel > win_w - 2) return false;
      const float* p = src_frame + (long long)(oy + kTileH + dy + r) * Wp +
                       (cmin + kPadX + rel);
      const float g0 = p[0], g1 = p[1];
      val = g0 + (g1 - g0) * (xsrc - xf);
      return g0 > kSentinelThresh && g1 > kSentinelThresh;
    };

    float val = 0.0f;
    const bool center_ok = sample(0.0f, 0.0f, 0, val) && (D > 0.0f) && valid;

    float s_bw = 0.f, s_r = 0.f, s_rr = 0.f, s_s = 0.f, s_ss = 0.f, s_rs = 0.f;
    int t = 0;
    for (int iy = 0; iy < n_off; ++iy) {
      const int dy = -radius + iy * increment;
      for (int ix = 0; ix < n_off; ++ix, ++t) {
        const int dx = -radius + ix * increment;
        const int ti = (kTileH + dy + r) * kRefWinW + kTileW + dx + l;
        const float ref_pix = ref_s[ti];
        const float tap_p = ep_s[ti];
        const float tap_n = 1.0f / tap_p;
        const float wgt = sw_s[t] * fminf(tap_p * cen_n, tap_n * cen_p);
        const float wr = wgt * ref_pix;
        const float wrr = wgt * ref_pix * ref_pix;
        float v = 0.0f;
        const float okf = sample((float)dx, (float)dy, dy, v) ? 1.0f : 0.0f;
        if (okf == 0.0f) v = 0.0f;
        const float w_t = okf * wgt;
        s_bw = s_bw + w_t;
        s_r = s_r + okf * wr;
        s_rr = s_rr + okf * wrr;
        s_s = s_s + w_t * v;
        s_ss = s_ss + w_t * v * v;
        s_rs = s_rs + okf * wr * v;
      }
    }
    const float inv_bw = 1.0f / fmaxf(s_bw, 1e-12f);
    const float m_ref = s_r * inv_bw;
    const float m_src = s_s * inv_bw;
    const float var_ref = s_rr * inv_bw - m_ref * m_ref;
    const float var_src = s_ss * inv_bw - m_src * m_src;
    const float covar = s_rs * inv_bw - m_ref * m_src;
    const float ncc = 1.0f - covar * rsqrtf(fmaxf(var_ref * var_src, 1e-30f));
    const float cost = fminf(fmaxf(ncc, 0.0f), cost_max);
    const bool bad = s_bw < 1e-6f || var_ref < 1e-5f || var_src < 1e-5f ||
                     !center_ok;
    out[ci] = bad ? cost_max : cost;
  }
}

}  // namespace

// srow (S, 128) f32; tile_oy, tile_ox (S, N) int32 storage-frame origins;
// rect_ref, rect_src (S, Hp, Wp) f32 padded frames; D (C, S, 8N, 128) f32;
// AB (C, S, 8N, 128) bf16 pair words; fwd_valid (S, 8N, 128) f32;
// out (C, S, 8N, 128) f32.
extern "C" int acmmp_rect_ncc(const float* srow, const int32_t* tile_oy,
                              const int32_t* tile_ox, const float* rect_ref,
                              const float* rect_src, const float* D,
                              const uint32_t* AB, const float* fwd_valid,
                              float* out, int C, int S, int N, int Hp, int Wp,
                              int win_w, int radius, int increment,
                              float inv_2sc, float clampv, float cost_max,
                              double inv_2ss, cudaStream_t stream) {
  const int smem = 2 * kWinH * kRefWinW * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      rect_ncc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (N > 0 && S > 0) {
    dim3 block(kTileW, kTileH);
    dim3 grid(N, S);
    rect_ncc_kernel<<<grid, block, smem, stream>>>(
        srow, tile_oy, tile_ox, rect_ref, rect_src, D, AB, fwd_valid, out, C,
        S, N, Hp, Wp, win_w, radius, increment, inv_2sc, clampv, cost_max,
        inv_2ss);
  }
  return (int)cudaGetLastError();
}
