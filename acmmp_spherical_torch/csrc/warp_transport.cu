// Plane-coefficient transport onto the compacted live rect tiles.
//
// Replaces: acmmp_spherical_tpu/ops/pallas/ncc_rect.py::warp_transport
// (kernel _warp_transport_kernel).  The Pallas kernel DMAs a per-tile window
// of the (D, AB) coefficient tables and extracts each pixel with row one-hots
// and lane gathers, because a TPU has no cheap per-element gather.  It is
// specified to equal ``table[fwd_idx]`` masked by ``fwd_valid`` bit for bit
// (invalid: D = -1e9, AB = 0), which is what this kernel computes directly.
//
// Bound on the H100: pure data movement, 2 x 4 bytes read (gathered) and
// 2 x 4 bytes written per (candidate, pair, compact pixel), plus the index
// and validity planes.  Design: one thread per (c, s, pixel) with the pixel
// index fastest, so index/validity loads and output stores are coalesced;
// the table reads follow fwd_idx, which is row-coherent within a tile
// (neighbouring rect pixels claim neighbouring original pixels), so most
// gathers hit the same cache lines.  No shared memory: nothing is reused
// inside a block beyond what L1 already catches.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void warp_transport_kernel(const float* __restrict__ tab_d,
                                      const float* __restrict__ tab_ab,
                                      const int32_t* __restrict__ fwd_idx,
                                      const float* __restrict__ fwd_valid,
                                      float* __restrict__ out_d,
                                      float* __restrict__ out_ab,
                                      int C, int S, int M, int P) {
  const long long total = (long long)C * S * P;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int p = (int)(i % P);
    const long long cs = i / P;
    const int s = (int)(cs % S);
    const int c = (int)(cs / S);
    const long long sp = (long long)s * P + p;
    float d = -1e9f, ab = 0.0f;
    if (fwd_valid[sp] > 0.5f) {
      const long long t = ((long long)s * C + c) * M + fwd_idx[sp];
      d = tab_d[t];
      ab = tab_ab[t];
    }
    out_d[i] = d;
    out_ab[i] = ab;
  }
}

}  // namespace

extern "C" const char* acmmp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// tab_d, tab_ab: (S, C, M) f32 (M = table rows per plane); fwd_idx (S, P)
// int32 in [0, M); fwd_valid (S, P) f32; out_d, out_ab: (C, S, P) f32.
extern "C" int acmmp_warp_transport(const float* tab_d, const float* tab_ab,
                                    const int32_t* fwd_idx,
                                    const float* fwd_valid, float* out_d,
                                    float* out_ab, int C, int S, int M, int P,
                                    cudaStream_t stream) {
  const long long total = (long long)C * S * P;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132 * 64) blocks = 132 * 64;
    warp_transport_kernel<<<(int)blocks, threads, 0, stream>>>(
        tab_d, tab_ab, fwd_idx, fwd_valid, out_d, out_ab, C, S, M, P);
  }
  return (int)cudaGetLastError();
}
