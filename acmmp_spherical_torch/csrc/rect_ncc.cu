// Rectified bilateral-NCC cost of C affine disparity fields against S
// rectified source frames, on the compacted live (8, 128) tiles.
//
// Replaces: acmmp_spherical_tpu/ops/pallas/ncc_rect.py::_rect_kernel (:110),
// launched by run_rect_kernel (:614), photometric and with_geom variants,
// rect_tap_pack False and True (kTapPack, below: the packed src_sample
// branch, :230-272, and the per-candidate pair pack, :297-306).  Per tile and candidate
// the kernel places a source window at the tile-min of x - clip(D, dlo, dhi)
// (128-aligned, clamped), samples the taps (11x11 at stride 2 by default)
// bilinearly in x on the tap's own row at x + dx - (D + A dx + B dy),
// rejects taps outside [0, win_w - 2] of the window or on a SENTINEL
// neighbour, checks the centre sample and D > 0, and returns 1 - NCC of the
// bilateral-weighted moments, clamped to [0, cost_max].  These per-tile
// rules are part of the algorithm and are kept exactly.
//
// What bounds it on the H100.  A C=9 call at the bench point (S=8, 960 live
// tiles, 36 taps) is ~2.5 G (candidate, pixel, tap) evaluations of a
// gathered bilinear sample and six moment sums.  The source frames stay in
// the 50 MB L2, so device-memory bytes are not the limit: fp32 instruction
// issue is.  The library is compiled with -fmad=false so that every sum and
// product rounds as the plain-torch version's separate operations do (the
// output is bit-identical to rect_ncc_plain); a multiply-add then costs two
// instructions, so the card issues at most ~33.5 T fp32 lane-instructions/s
// (132 SMs x 128 lanes x ~1.98 GHz), half the 67 TFLOP/s that counts FMAs.
// The tap loop compiles to ~32 instructions per (candidate, pixel, tap):
// 577 SASS instructions for the 6 taps x 3 candidates of the default
// pattern's chunk of 3 (scripts/sass_rect_ncc.py).
// Tensor cores do not apply: every sum weights a value gathered at a column
// that depends on the candidate and the pixel, so no operand is shared
// across a matrix product.
//
// Design (each point against the first port's one-candidate-at-a-time
// loop, which rebuilt the tap weight per candidate):
// * Taps outside, a chunk of candidates inside.  One block per (live tile,
//   pair) of kThreads = 128 * kRows threads; a thread owns one pixel per row
//   group (8 / kRows groups, walked in turn) and keeps a chunk of up to
//   kChunk candidates live: D, A, B, the window's middle column and the six
//   sums of each.  Per (pixel, tap) the weight triple (wgt, wgt*ref,
//   wgt*ref^2) is computed once and shared by the chunk.  Each candidate's
//   taps are summed in the reference's tap order (ncc_rect.py:192-201); the
//   candidates are independent, so regrouping them changes no bit.  The
//   block walks all C candidates in balanced chunks (every C works; C=9 is
//   3+3+3, C=5 is 3+2).
// * The tap loop is branch-free: a tap outside the window loads an
//   in-bounds column and is dropped by a select, so the loads of a chunk's
//   taps overlap.  The gather's dependent chain (coordinate, floor, window
//   test, load, interpolation) is latency-bound: a chunk of 3 at 64
//   registers (4 blocks, 32 warps per SM) measured faster than chunks of 9
//   (128 registers) or 5 (80); PERF.md records the measurement.
// * The weight comes from staged ep = exp(clip(ref) * inv_2sc) and
//   en = 1 / ep, both computed once at staging with the same IEEE
//   operations as the reference's ep and en (ncc_rect.py:210-211).
// * One window-origin reduction per chunk: the tile minima of all the
//   chunk's candidates in one warp-shuffle pass and one barrier pair, the
//   origin rule unchanged.
// * The default tap pattern (radius 5, stride 2: 6 offsets per axis) is a
//   template instantiation, so dx, the shared-memory tap offsets and the
//   tap count are constants and the row of 6 taps x the chunk is unrolled.
//   So is the coarse pattern of rect_prescreen (radius 5, stride 5: 3
//   offsets per axis, 9 taps), which ranks the candidates of a prescreened
//   half-step.  Any other pattern the wrapper accepts (radius <= 8, <= 64
//   taps) runs through the instantiation with runtime bounds: the same
//   kernel, which at the default pattern measured 14-30% slower than the
//   unrolled one.  The caller can ask for the runtime-bounds build at
//   any pattern (runtime_taps), to time the two side by side.
// * kThreads = 256 (two rows of the tile at a time) with
//   __launch_bounds__(256, 4), which caps a thread at 64 registers
//   (ptxas.log beside the library has the count and the spills).
// * Only the band the taps read is staged: (8 + 2r) x (128 + 2r) of ref,
//   ep and en, at a fixed row stride of 144 floats.
// * A warp whose lanes all fail the centre test for every candidate of the
//   chunk (their result is cost_max whatever the taps say) skips the taps
//   (a warp vote); a candidate that fails its centre test takes no tap.
//
// with_geom variant (kGeom, entry acmmp_rect_ncc_geom): a second plane, the
// fused geometric-consistency cost of each candidate,
// min(geom_max_cost, |D - sdisp| * srow[4]) where the centre sample is valid
// and sdisp -- the source's implied rect disparity, read at the centre tap's
// floored source column on the pixel's own row -- is not SENTINEL, else
// geom_max_cost.  The TPU kernel double-buffers a 24 x win_w disparity
// window by DMA; here it is one global load per (candidate, pixel).
//
// Packed taps (kTapPack, params.rect_tap_pack, the reference's default):
// the Pallas kernel reads both bilinear x-neighbours of a tap as one bf16
// pair word (pack_ab of the window and its +1 lane roll, built per
// candidate window at ncc_rect.py:297-306, gathered and unpacked per tap at
// :247-257), which rounds every source value that a tap or the centre
// check samples to bf16 and changes nothing else: the reference side, the
// interpolation, the SENTINEL test and the sdisp read stay f32.  Here the
// pair words are made once per rectified context, for whole frames, by
// pack_src_pairs.cu (the context's rect_src_pk, reused by its prior round
// and by every launch of the pass), and kTapPack reads one 32-bit word per
// tap and per centre check where the f32 instantiation loads two floats:
// g0 is the word's high half, g1 its low half, each as f32 bits.  Nothing
// is rounded in the loop.  The plain version rounds the f32 frame; the
// output is bit-identical.  One pair frame serves pinhole and sphere
// frames alike.  What the pair frame changed: the first port of kTapPack
// rounded each loaded value in the loop, 825 instructions for the chunk
// of 3 (45.8 per (candidate, pixel, tap)) with two loads in each tap's
// chain, 42-43% slower than the f32 loop; now 584 (32.4: the two unpack
// instructions in place of a load), within 1% of the f32 loop's time, so
// 1p is bound by issue as kernel 1 is (PERF.md §6; NVIDIA H100 80GB HBM3,
// 700 W).  The f32 instantiations compile to the same SASS as before.
// Shared-memory staging of the source windows is not the design: at
// rect_win_w = 384 one candidate's 18-row window of pair words is 27.6 KB,
// and a chunk of 3 plus the staged reference band is ~114 KB of shared
// memory, one 256-thread block per SM against four; the gathers hit L1
// and the 50 MB L2, and the loop is bound by issue, not by their bytes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kPadX = 128;
constexpr float kSentinelThresh = -0.5f;
constexpr int kMaxTaps = 64;
constexpr int kMaxRadius = 8;
constexpr int kBW = kTileW + 2 * kMaxRadius;   // staged band row stride
constexpr int kChunk = 3;       // candidates live per thread
constexpr int kRows = 2;        // tile rows per block at a time
constexpr int kThreads = kRows * kTileW;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kTileH / kRows;
constexpr int kMinBlocks = 4;   // blocks per SM: 64 registers a thread

struct Args {
  const float* srow;
  const int32_t* tile_oy;
  const int32_t* tile_ox;
  const float* rect_ref;
  const float* rect_src;
  const float* D;
  const uint32_t* AB;
  const float* fwd_valid;
  float* out;
  const float* sdisp;
  float* gout;
  int C, S, N, Hp, Wp, win_w, radius, increment;
  float inv_2sc, clampv, cost_max, geom_max;
  double inv_2ss;
  const uint32_t* src_pk;   // kTapPack: the pair-word frames (S, Hp, Wp)
};

// What every chunk of one block shares.
struct Block {
  const float* ref_b;     // staged band: reference values
  const float* ep_b;      // exp(clip(ref) * inv_2sc)
  const float* en_b;      // 1 / ep
  const float* sw_s;      // spatial weight per tap
  float* red_s;           // (kWarps, kChunk) warp minima
  int* cmin_s;            // (kChunk) window origins
  long long plane;        // C-stride of D, AB, out
  long long pix0;         // this thread's pixel of row group 0
  int tid, r0, l, oy;
  float xg, dlo, dhi;
  const float* src_frame;
  const float* sdisp_frame;
  int rad, inc, n_off;
  const uint32_t* pk_frame;   // kTapPack: this pair's pair-word frame
};

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The source frame a variant reads: f32 values, or with kTapPack the
// pair words of pack_src_pairs.cu (bf16(src[x]) high, bf16(src[x + 1]) low).
template <bool kTapPack> struct SrcFrame { using T = float; };
template <> struct SrcFrame<true> { using T = uint32_t; };

template <bool kTapPack>
__device__ __forceinline__ const typename SrcFrame<kTapPack>::T* frame_of(
    const Block& b) {
  if constexpr (kTapPack) return b.pk_frame; else return b.src_frame;
}

// The bilinear x-neighbours (g0, g1) of the column at p: two f32 loads, or
// one pair word, whose halves are the bf16 values as f32 bits.  pair_at
// loads through the ordinary path, ldg_pair through the read-only one.
__device__ __forceinline__ void unpack_pair(uint32_t w, float& g0,
                                            float& g1) {
  g0 = __uint_as_float(w & 0xFFFF0000u);
  g1 = __uint_as_float(w << 16);
}
__device__ __forceinline__ void pair_at(const float* p, float& g0,
                                        float& g1) {
  g0 = p[0];
  g1 = p[1];
}
__device__ __forceinline__ void pair_at(const uint32_t* p, float& g0,
                                        float& g1) {
  unpack_pair(p[0], g0, g1);
}
__device__ __forceinline__ void ldg_pair(const float* p, float& g0,
                                         float& g1) {
  g0 = __ldg(p);
  g1 = __ldg(p + 1);
}
__device__ __forceinline__ void ldg_pair(const uint32_t* p, float& g0,
                                         float& g1) {
  unpack_pair(__ldg(p), g0, g1);
}

__device__ __forceinline__ int floor_to_int(float v) {
  // clamp before the cast so far-off values stay defined
  return (int)fminf(fmaxf(floorf(v), -1073741824.0f), 1073741824.0f);
}

// One chunk of CB candidates, c0 .. c0 + CB - 1, over all row groups.
template <bool kGeom, bool kTapPack, int kNOff, int kRad, int kInc, int CB>
__device__ __forceinline__ void run_chunk(const Args& a, const Block& b,
                                          int c0) {
  const int warp = b.tid >> 5, lane = b.tid & 31;
  constexpr int kRowPix = kRows * kTileW;

  // ---- window origin of each candidate: one reduction for the chunk ----
  float m[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j) m[j] = CUDART_INF_F;
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    const long long pix = b.pix0 + (long long)g * kRowPix;
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      const float D = a.D[(c0 + j) * b.plane + pix];
      m[j] = fminf(m[j], b.xg - fminf(fmaxf(D, b.dlo), b.dhi));
    }
  }
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    const float w = warp_min(m[j]);
    if (lane == 0) b.red_s[warp * kChunk + j] = w;
  }
  __syncthreads();
  if (b.tid < CB) {
    float w = b.red_s[b.tid];
    for (int i = 1; i < kWarps; ++i) w = fminf(w, b.red_s[i * kChunk + b.tid]);
    int cmin = floor_to_int((w - 6.0f) / 128.0f) * kTileW;
    b.cmin_s[b.tid] = min(max(cmin, -kPadX), a.Wp - kPadX - a.win_w);
  }
  __syncthreads();

  const int rad = kNOff ? kRad : b.rad;
  const int inc = kNOff ? kInc : b.inc;
  const int n_off = kNOff ? kNOff : b.n_off;

#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    const int r = b.r0 + g * kRows;
    const long long pix = b.pix0 + (long long)g * kRowPix;
    const bool valid = a.fwd_valid[pix] > 0.5f;
    const int cen = (r + rad) * kBW + kMaxRadius + b.l;   // band index
    const float cen_p = b.ep_b[cen];
    const float cen_n = b.en_b[cen];
    // the pixel's own source row, at unpadded column 0 (a frame holds
    // < 2^31 values)
    const auto* src_row =
        frame_of<kTapPack>(b) + ((b.oy + kTileH + r) * a.Wp + kPadX);

    // per candidate: coefficients, the window's middle column, centre
    // test.  A floored column xf lies in the window [cmin, cmin + win_w - 2]
    // iff |xf - mid| <= half_w with mid = cmin + half_w: xf and mid are
    // integers or half-integers, so the test is exact, and false for a NaN.
    const float half_w = 0.5f * (float)(a.win_w - 2);
    float Dj[CB], Aj[CB], Bj[CB], mid[CB];
    bool any_ok = false;
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      const long long ci = (c0 + j) * b.plane + pix;
      const float D = a.D[ci];
      const uint32_t ab = a.AB[ci];
      const float A = __uint_as_float(ab & 0xFFFF0000u);
      const float B = __uint_as_float(ab << 16);
      const float mid_c = (float)b.cmin_s[j] + half_w;
      // the centre sample (dx = dy = 0), as the taps compute it
      const float xsrc = (b.xg + 0.0f) - ((D + A * 0.0f) + B * 0.0f);
      const float xf = floorf(xsrc);
      bool ok = false;
      int xi = 0;
      if (fabsf(xf - mid_c) <= half_w) {
        xi = (int)xf;
        float g0, g1;
        pair_at(src_row + xi, g0, g1);
        ok = g0 > kSentinelThresh && g1 > kSentinelThresh;
      }
      ok = ok && (D > 0.0f) && valid;
      if (kGeom) {
        // ok puts the centre column inside the window, so the read is in
        // bounds
        float gv = a.geom_max;
        if (ok) {
          const float dval = b.sdisp_frame[(long long)(b.oy + kTileH + r) *
                                               a.Wp + kPadX + xi];
          if (dval > kSentinelThresh)
            gv = fminf(a.geom_max, fabsf(D - dval) * a.srow[blockIdx.y * 128 + 4]);
        }
        a.gout[ci] = gv;
      }
      Dj[j] = D;
      Aj[j] = A;
      Bj[j] = B;
      // a candidate that fails its centre test takes no tap (mid = inf)
      mid[j] = ok ? mid_c : CUDART_INF_F;
      any_ok = any_ok || ok;
    }

    float s_bw[CB], s_r[CB], s_rr[CB], s_s[CB], s_ss[CB], s_rs[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j)
      s_bw[j] = s_r[j] = s_rr[j] = s_s[j] = s_ss[j] = s_rs[j] = 0.0f;

    if (__any_sync(0xffffffffu, any_ok)) {
      // the tap row's source row, carried from row to row so that a tap's
      // address is one multiply-add on it
      const auto* tap_row = src_row - rad * a.Wp;
#pragma unroll 1
      for (int iy = 0; iy < n_off; ++iy, tap_row += inc * a.Wp) {
        const int dy = -rad + iy * inc;
        const float dyf = (float)dy;
        const int brow = cen + dy * kBW;
#pragma unroll
        for (int ix = 0; ix < n_off; ++ix) {
          const int dx = -rad + ix * inc;
          const float dxf = (float)dx;
          // the weight triple of (pixel, tap), shared by the chunk
          const float ref_pix = b.ref_b[brow + dx];
          const float tap_p = b.ep_b[brow + dx];
          const float tap_n = b.en_b[brow + dx];
          const float wgt = b.sw_s[iy * n_off + ix] *
                            fminf(tap_p * cen_n, tap_n * cen_p);
          const float wr = wgt * ref_pix;
          const float wrr = wr * ref_pix;
          const float xgd = b.xg + dxf;
#pragma unroll
          for (int j = 0; j < CB; ++j) {
            // branch-free, so the chunk's loads overlap: a tap outside the
            // window reads the row's window column 0 (in bounds) and is
            // then dropped
            const float xsrc = xgd - ((Dj[j] + Aj[j] * dxf) + Bj[j] * dyf);
            const float xf = floorf(xsrc);
            const bool inwin = fabsf(xf - mid[j]) <= half_w;
            const auto* p = tap_row + (inwin ? __float2int_rz(xf) : 0);
            float g0, g1;
            ldg_pair(p, g0, g1);
            const bool ok =
                inwin && g0 > kSentinelThresh && g1 > kSentinelThresh;
            const float v = g0 + (g1 - g0) * (xsrc - xf);
            const float wv = wgt * v;
            // a rejected tap adds +0 in the reference: keeping the sum
            // leaves its bits unchanged
            s_bw[j] = ok ? s_bw[j] + wgt : s_bw[j];
            s_r[j] = ok ? s_r[j] + wr : s_r[j];
            s_rr[j] = ok ? s_rr[j] + wrr : s_rr[j];
            s_s[j] = ok ? s_s[j] + wv : s_s[j];
            s_ss[j] = ok ? s_ss[j] + wv * v : s_ss[j];
            s_rs[j] = ok ? s_rs[j] + wr * v : s_rs[j];
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < CB; ++j) {
      const float inv_bw = 1.0f / fmaxf(s_bw[j], 1e-12f);
      const float m_ref = s_r[j] * inv_bw;
      const float m_src = s_s[j] * inv_bw;
      const float var_ref = s_rr[j] * inv_bw - m_ref * m_ref;
      const float var_src = s_ss[j] * inv_bw - m_src * m_src;
      const float covar = s_rs[j] * inv_bw - m_ref * m_src;
      const float ncc =
          1.0f - covar * rsqrtf(fmaxf(var_ref * var_src, 1e-30f));
      const float cost = fminf(fmaxf(ncc, 0.0f), a.cost_max);
      const bool bad = s_bw[j] < 1e-6f || var_ref < 1e-5f ||
                       var_src < 1e-5f || mid[j] == CUDART_INF_F;
      a.out[(c0 + j) * b.plane + pix] = bad ? a.cost_max : cost;
    }
  }
}

// run_chunk for a chunk of cb <= CB candidates
template <bool kGeom, bool kTapPack, int kNOff, int kRad, int kInc, int CB>
__device__ __forceinline__ void dispatch_chunk(const Args& a, const Block& b,
                                               int c0, int cb) {
  if (cb == CB) {
    run_chunk<kGeom, kTapPack, kNOff, kRad, kInc, CB>(a, b, c0);
  } else if constexpr (CB > 1) {
    dispatch_chunk<kGeom, kTapPack, kNOff, kRad, kInc, CB - 1>(a, b, c0, cb);
  }
}

// kNOff == 0: the tap pattern (radius, increment) is read at run time.
template <bool kGeom, bool kTapPack, int kNOff, int kRad, int kInc>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rect_ncc_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  __shared__ float sw_s[kMaxTaps];
  __shared__ float red_s[kWarps * kChunk];
  __shared__ int cmin_s[kChunk];

  const int k = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x;
  const int r0 = tid / kTileW, l = tid % kTileW;
  const int K8 = a.N * kTileH;
  const long long plane = (long long)a.S * K8 * kTileW;
  const long long pix0 = ((long long)s * K8 + k * kTileH + r0) * kTileW + l;

  bool any_valid = false;
  for (int g = 0; g < kGroups; ++g)
    any_valid = any_valid || a.fwd_valid[pix0 + (long long)g * kThreads] > 0.5f;
  if (!__syncthreads_or(any_valid)) {
    for (int g = 0; g < kGroups; ++g) {
      const long long pix = pix0 + (long long)g * kThreads;
      for (int c = 0; c < a.C; ++c) {
        a.out[c * plane + pix] = a.cost_max;
        if (kGeom) a.gout[c * plane + pix] = a.geom_max;
      }
    }
    return;
  }

  const int rad = kNOff ? kRad : a.radius;
  const int inc = kNOff ? kInc : a.increment;
  const int n_off = kNOff ? kNOff : 2 * rad / inc + 1;
  const int band_h = kTileH + 2 * rad;
  float* ref_b = smem;
  float* ep_b = smem + band_h * kBW;
  float* en_b = smem + 2 * band_h * kBW;

  // stage the band the taps read: window rows 8-rad .. 15+rad, columns
  // 128-rad .. 255+rad (band row i = window row 8-rad+i, band column j =
  // window column 120+j)
  const int oy = a.tile_oy[s * a.N + k];
  const int ox = a.tile_ox[s * a.N + k];
  const float* ref_frame = a.rect_ref + (long long)s * a.Hp * a.Wp;
  const int band_w = kTileW + 2 * rad;
  for (int i = tid; i < band_h * band_w; i += kThreads) {
    const int br = i / band_w;
    const int bc = kMaxRadius - rad + i % band_w;
    const float v =
        ref_frame[(long long)(oy + kTileH - rad + br) * a.Wp + ox + 120 + bc];
    const float ep = expf(fminf(fmaxf(v, -a.clampv), a.clampv) * a.inv_2sc);
    ref_b[br * kBW + bc] = v;
    ep_b[br * kBW + bc] = ep;
    en_b[br * kBW + bc] = 1.0f / ep;
  }
  if (tid < n_off * n_off) {
    const int dy = -rad + (tid / n_off) * inc;
    const int dx = -rad + (tid % n_off) * inc;
    sw_s[tid] = (float)exp(-sqrt((double)(dx * dx + dy * dy)) * a.inv_2ss);
  }
  __syncthreads();

  Block b;
  b.ref_b = ref_b;
  b.ep_b = ep_b;
  b.en_b = en_b;
  b.sw_s = sw_s;
  b.red_s = red_s;
  b.cmin_s = cmin_s;
  b.plane = plane;
  b.pix0 = pix0;
  b.tid = tid;
  b.r0 = r0;
  b.l = l;
  b.oy = oy;
  b.xg = (float)ox + (float)l;
  b.dlo = a.srow[s * 128 + 0];
  b.dhi = a.srow[s * 128 + 1];
  b.src_frame = a.rect_src + (long long)s * a.Hp * a.Wp;
  b.sdisp_frame = kGeom ? a.sdisp + (long long)s * a.Hp * a.Wp : nullptr;
  b.rad = rad;
  b.inc = inc;
  b.n_off = n_off;
  b.pk_frame = kTapPack ? a.src_pk + (long long)s * a.Hp * a.Wp : nullptr;

  for (int c0 = 0; c0 < a.C;) {
    // balanced chunks of at most kChunk candidates
    const int rem = a.C - c0;
    const int n_chunks = (rem + kChunk - 1) / kChunk;
    const int cb = (rem + n_chunks - 1) / n_chunks;
    dispatch_chunk<kGeom, kTapPack, kNOff, kRad, kInc, kChunk>(a, b, c0, cb);
    c0 += cb;
  }
}

template <bool kGeom, bool kTapPack>
void launch_pattern(const Args& a, bool runtime_taps, cudaStream_t stream) {
  const int smem = 3 * (kTileH + 2 * a.radius) * kBW * (int)sizeof(float);
  const dim3 grid(a.N, a.S);
  if (!runtime_taps && a.radius == 5 && a.increment == 2)
    rect_ncc_kernel<kGeom, kTapPack, 6, 5, 2>   // the default 11x11 stride-2
        <<<grid, kThreads, smem, stream>>>(a);
  else if (!runtime_taps && a.radius == 5 && a.increment == 5)
    rect_ncc_kernel<kGeom, kTapPack, 3, 5, 5>   // prescreen's 11x11 stride-5
        <<<grid, kThreads, smem, stream>>>(a);
  else
    rect_ncc_kernel<kGeom, kTapPack, 0, 0, 0>
        <<<grid, kThreads, smem, stream>>>(a);
}

template <bool kGeom>
int launch_rect_ncc(const Args& a, bool runtime_taps, cudaStream_t stream) {
  if (a.N > 0 && a.S > 0) {
    if (a.src_pk != nullptr)
      launch_pattern<kGeom, true>(a, runtime_taps, stream);
    else
      launch_pattern<kGeom, false>(a, runtime_taps, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// srow (S, 128) f32; tile_oy, tile_ox (S, N) int32 storage-frame origins;
// rect_ref, rect_src (S, Hp, Wp) f32 padded frames; D (C, S, 8N, 128) f32;
// AB (C, S, 8N, 128) bf16 pair words; fwd_valid (S, 8N, 128) f32;
// out (C, S, 8N, 128) f32.  radius <= 8, at most 64 taps.  runtime_taps
// non-zero runs the build with runtime tap bounds at any pattern.  src_pk
// (S, Hp, Wp) the pair words of rect_src (pack_src_pairs.cu), or null:
// non-null runs the packed-tap variant, which reads src_pk in place of
// rect_src.
extern "C" int acmmp_rect_ncc(const float* srow, const int32_t* tile_oy,
                              const int32_t* tile_ox, const float* rect_ref,
                              const float* rect_src, const float* D,
                              const uint32_t* AB, const float* fwd_valid,
                              float* out, int C, int S, int N, int Hp, int Wp,
                              int win_w, int radius, int increment,
                              int runtime_taps, const uint32_t* src_pk,
                              float inv_2sc, float clampv, float cost_max,
                              double inv_2ss, cudaStream_t stream) {
  const Args a{srow, tile_oy, tile_ox, rect_ref, rect_src, D, AB, fwd_valid,
               out, nullptr, nullptr, C, S, N, Hp, Wp, win_w, radius,
               increment, inv_2sc, clampv, cost_max, 0.0f, inv_2ss, src_pk};
  return launch_rect_ncc<false>(a, runtime_taps != 0, stream);
}

// The with_geom variant: also sdisp (S, Hp, Wp) f32 in and the geometric
// cost plane gout (C, S, 8N, 128) f32 out.
extern "C" int acmmp_rect_ncc_geom(const float* srow, const int32_t* tile_oy,
                                   const int32_t* tile_ox,
                                   const float* rect_ref,
                                   const float* rect_src, const float* D,
                                   const uint32_t* AB, const float* fwd_valid,
                                   float* out, const float* sdisp, float* gout,
                                   int C, int S, int N, int Hp, int Wp,
                                   int win_w, int radius, int increment,
                                   int runtime_taps, const uint32_t* src_pk,
                                   float inv_2sc, float clampv,
                                   float cost_max, float geom_max,
                                   double inv_2ss, cudaStream_t stream) {
  const Args a{srow, tile_oy, tile_ox, rect_ref, rect_src, D, AB, fwd_valid,
               out, sdisp, gout, C, S, N, Hp, Wp, win_w, radius, increment,
               inv_2sc, clampv, cost_max, geom_max, inv_2ss, src_pk};
  return launch_rect_ncc<true>(a, runtime_taps != 0, stream);
}
