// Plane-coefficient transport onto the compacted live rect tiles, with the
// coefficients computed at the gathered pixel.
//
// Replaces: acmmp_spherical_tpu/ops/pallas/ncc_rect.py::warp_transport
// (kernel _warp_transport_kernel) together with the XLA pre-step that feeds
// it (ncc_rect.py:550-566).  On the TPU the pre-step writes (S, C, H, Wg) D
// and packed-AB tables and the Pallas kernel DMAs a per-tile window of them
// and extracts each claimant with row one-hots and lane gathers.  Here the
// tables are never written: for every (candidate c, pair s, compact pixel p)
// with fwd_valid[s, p] > 0.5 the kernel reads the plane at m = fwd_idx[s, p]
// (normals[c, m, :], ws[c, m]) and the claimed rect pixel (bwd_x[s, m],
// bwd_y[s, m]) and computes
//
//   n_r[i] = (n0 R[i,0] + n1 R[i,1]) + n2 R[i,2]
//   scale  = -baseline / w',  w' = 1e-20 where |w| < 1e-20 (sign dropped)
//   A = scale n_r[0],  B = scale n_r[1],  cterm = (scale n_r[2]) f
//   D = (A ((xb + off_x) - cx) + B ((yb + off_y) - cy)) + cterm
//
// with D = -1e9 unless finite and |D| < 1e8, and AB = (bf16(A) << 16) |
// bf16(B); invalid pixels get D = -1e9, AB = 0.  Each step is one rounded
// operation in the order of ncc_rect.coefficient_tables, so with -fmad=false
// and IEEE division the result equals coefficient_tables +
// warp_transport_plain bit for bit.  bf16 rounding is round-to-nearest-even
// on the bits, NaN -> 0x7FC0 with its sign (ncc_rect.pack_ab, the reference's
// conversion).
//
// Bound on the H100: bytes.  Per call the (C, S, P) D and AB planes are
// written once (566 MB at C=9 on the bench point), fwd_idx and fwd_valid
// read once, and the fields (16 B per (c, m)) and bwd_x/bwd_y (int64) read
// at the claimed pixels.  Design: a thread owns kPix consecutive compact
// pixels of one pair and walks all C candidates, so fwd_idx, fwd_valid,
// bwd_x/y and the pair's constants are read once per (s, p), not per
// (c, s, p); index, validity and output accesses are kPix-wide vectors along
// p; the field reads follow fwd_idx, which is row-coherent within a tile, so
// they mostly hit L2.  Invalid pixels issue no field loads.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kPix = 4;        // consecutive compact pixels per thread

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// round-to-nearest-even bf16 bits of x; NaN -> quiet NaN with x's sign
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t rne = (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
  return isnan(x) ? (((u >> 16) & 0x8000u) | 0x7FC0u) : rne;
}

__global__ void __launch_bounds__(kThreads)
warp_transport_kernel(const float* __restrict__ normals,
                      const float* __restrict__ ws,
                      const int64_t* __restrict__ bwd_x,
                      const int64_t* __restrict__ bwd_y,
                      const int32_t* __restrict__ fwd_idx,
                      const float* __restrict__ fwd_valid,
                      const float* __restrict__ R_rr,
                      const float* __restrict__ K,
                      const float* __restrict__ baseline,
                      const float* __restrict__ srow,
                      float* __restrict__ out_d, int32_t* __restrict__ out_ab,
                      int C, int S, int M, int P) {
  const int s = blockIdx.y;
  const int p0 = (blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (p0 >= P) return;
  const float* R = R_rr + s * 9;
  const float r00 = R[0], r01 = R[1], r02 = R[2];
  const float r10 = R[3], r11 = R[4], r12 = R[5];
  const float r20 = R[6], r21 = R[7], r22 = R[8];
  const float f = K[s * 3], cx = K[s * 3 + 1], cy = K[s * 3 + 2];
  const float nb = -baseline[s];
  const float off_y = srow[s * 128 + 2], off_x = srow[s * 128 + 3];

  const long long sp = (long long)s * P + p0;
  const Vec<float, kPix> val =
      *reinterpret_cast<const Vec<float, kPix>*>(fwd_valid + sp);
  const Vec<int32_t, kPix> idx =
      *reinterpret_cast<const Vec<int32_t, kPix>*>(fwd_idx + sp);
  bool ok[kPix];
  int m[kPix];
  float tx[kPix], ty[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    ok[j] = val.v[j] > 0.5f;
    m[j] = idx.v[j];
    const long long sm = (long long)s * M + m[j];
    const float xb = ok[j] ? (float)bwd_x[sm] : 0.0f;
    const float yb = ok[j] ? (float)bwd_y[sm] : 0.0f;
    tx[j] = (xb + off_x) - cx;
    ty[j] = (yb + off_y) - cy;
  }

  for (int c = 0; c < C; ++c) {
    Vec<float, kPix> d;
    Vec<int32_t, kPix> ab;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const long long cm = (long long)c * M + m[j];
      float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f, w = 1.0f;
      if (ok[j]) {
        n0 = normals[cm * 3];
        n1 = normals[cm * 3 + 1];
        n2 = normals[cm * 3 + 2];
        w = ws[cm];
      }
      const float nr0 = (n0 * r00 + n1 * r01) + n2 * r02;
      const float nr1 = (n0 * r10 + n1 * r11) + n2 * r12;
      const float nr2 = (n0 * r20 + n1 * r21) + n2 * r22;
      const float scale = nb / (fabsf(w) < 1e-20f ? 1e-20f : w);
      const float A = scale * nr0;
      const float B = scale * nr1;
      const float cterm = (scale * nr2) * f;
      const float dd = (A * tx[j] + B * ty[j]) + cterm;
      const bool keep = isfinite(dd) && fabsf(dd) < 1e8f;
      d.v[j] = ok[j] ? (keep ? dd : -1e9f) : -1e9f;
      ab.v[j] = ok[j] ? (int32_t)((bf16_bits(A) << 16) | bf16_bits(B)) : 0;
    }
    const long long o = ((long long)c * S + s) * P + p0;
    *reinterpret_cast<Vec<float, kPix>*>(out_d + o) = d;
    *reinterpret_cast<Vec<int32_t, kPix>*>(out_ab + o) = ab;
  }
}

}  // namespace

extern "C" const char* acmmp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// normals (C, M, 3) and ws (C, M) f32: the plane fields on the evaluation
// grid (M = H * Wg); bwd_x, bwd_y (S, M) int64: each grid pixel's claimed
// rect pixel; fwd_idx (S, P) int32 in [0, M), fwd_valid (S, P) f32; R_rr
// (S, 3, 3), K (S, 3) = (f, cx, cy), baseline (S,), srow (S, 128) with
// off_y, off_x at 2, 3; out_d f32 and out_ab int32: (C, S, P).
// P % (kThreads * kPix) == 0 (P is a whole number of 1024-pixel tiles).
extern "C" int acmmp_warp_transport(const float* normals, const float* ws,
                                    const int64_t* bwd_x, const int64_t* bwd_y,
                                    const int32_t* fwd_idx,
                                    const float* fwd_valid, const float* R_rr,
                                    const float* K, const float* baseline,
                                    const float* srow, float* out_d,
                                    int32_t* out_ab, int C, int S, int M, int P,
                                    cudaStream_t stream) {
  if ((long long)C * S * P > 0) {
    dim3 grid(P / (kThreads * kPix), S);
    warp_transport_kernel<<<grid, kThreads, 0, stream>>>(
        normals, ws, bwd_x, bwd_y, fwd_idx, fwd_valid, R_rr, K, baseline,
        srow, out_d, out_ab, C, S, M, P);
  }
  return (int)cudaGetLastError();
}
