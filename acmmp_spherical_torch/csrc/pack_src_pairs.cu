// The bf16 pair-word source frame that the packed-tap rect kernels (kernels
// 1p and 4p, rect_ncc.cu's kTapPack) read: one 32-bit word per tap.
//
// Replaces: the pair word that acmmp_spherical_tpu/ops/pallas/ncc_rect.py::
// _rect_kernel builds once per candidate window (pack_ab of the window and
// its +1 lane roll, :297-306; one gather and an unpack per tap, :247-257).
// Here the words are made once per rectified context, for whole frames:
// word x of a row holds bf16(src[x]) in its high half and bf16(src[x + 1])
// in its low half, the order of ops/kernels/ncc_rect.py's pack_ab, rounded
// by _to_bf16_bits' rule (to nearest even on the bits, NaN -> 0x7FC0 with
// its sign).  The last column's low half holds SENTINEL's word.  No tap
// reads it: the rect kernel reads a pair at a column <= Wp - 2, since its
// window origin cmin <= Wp - PAD_X - win_w and a tap's column in the window
// is <= win_w - 2.  The same kernel serves pinhole frames (kernel 3's
// output) and SPHERE frames (made in plain torch).
//
// Bound on the H100: bytes, one f32 read and one 32-bit write per element
// (the +1 neighbour is the next thread's value, an L1 hit).  One block per
// frame row, its threads walking the columns.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kSentinel = -1.0e4f;

// _to_bf16_bits of one value
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return isnan(v) ? ((u >> 16) & 0x8000u) | 0x7FC0u
                  : (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

__global__ void __launch_bounds__(kThreads)
pack_src_pairs_kernel(const float* __restrict__ src,
                      uint32_t* __restrict__ out, int Wp) {
  const long long row = (long long)blockIdx.x * Wp;
  const float* s = src + row;
  uint32_t* o = out + row;
  for (int x = threadIdx.x; x < Wp; x += kThreads) {
    const float nxt = x + 1 < Wp ? s[x + 1] : kSentinel;
    o[x] = (bf16_bits(s[x]) << 16) | bf16_bits(nxt);
  }
}

}  // namespace

// src (rows, Wp) f32 (a stack of padded frames, rows = S * Hp); out (rows,
// Wp) the pair words.
extern "C" int acmmp_pack_src_pairs(const float* src, uint32_t* out,
                                    int rows, int Wp, cudaStream_t stream) {
  if (rows > 0 && Wp > 0)
    pack_src_pairs_kernel<<<rows, kThreads, 0, stream>>>(src, out, Wp);
  return (int)cudaGetLastError();
}
