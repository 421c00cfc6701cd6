// Device helpers of the Hopper attention kernels (B3's forward in
// flash_attention.cu, B2b's backward in packed_attention_bwd.cu): operands
// of wgmma m64nNk16 with A in registers and B a 128-byte-swizzled tile of
// 64-wide bf16 rows in shared memory, as TMA writes it.
//
// Layouts (lane = 4 * g + t, warp w of a warpgroup owns rows 16w..16w+15):
//   A fragment (16 x 16 bf16 a warp): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
//                                     a2 = (g, 2t+8..),   a3 = (g+8, 2t+8..)
//   D accumulator (16 x N f32 a warp, N / 2 values a thread): d[i] is row
//     g + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2t + (i & 1).
// So accumulator columns 16kk..16kk+15, rounded to bf16, are exactly the A
// fragment of k-step kk of a product whose K runs over those columns
// (acc_to_a): P = softmax(S) feeds P V, and P^T, dS^T feed dV, dK, without
// leaving the registers.
//
// A tile of R rows x 64 bf16 (128 bytes a row), 128-byte swizzled (16-byte
// chunk c of row r at chunk c ^ (r % 8)), 1024-byte aligned, is read two
// ways:
//   * K-major (desc_k): as the B operand of X Y^T, the 64 columns are the
//     contraction; k-step kk starts 32 bytes further, 8-row groups 1024 B
//     apart;
//   * MN-major (desc_mn): as the B operand of X Y, the R rows are the
//     contraction; k-step kk starts 16 rows (2048 B) further.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace attn_hopper {

constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim * 2;  // one 64-wide bf16 row: the swizzle span
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;  // the JAX kernels' _NEG_INF

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return hopper::make_desc(static_cast<const uint8_t*>(tile) + kk * 32, 128, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return hopper::make_desc(static_cast<const uint8_t*>(tile) + kk * 16 * kRowBytes, 128,
                           64 * kRowBytes, 1024);
}

// A fragments of a warp's 16 rows x 64 columns of a packed tensor, straight
// from global memory (row stride ld elements; `rows` points at row 0).
__device__ __forceinline__ void load_a_global(uint32_t frag[4][4], const __nv_bfloat16* rows,
                                              int ld, int g, int t) {
  const __nv_bfloat16* p0 = rows + static_cast<size_t>(g) * ld + t * 2;
  const __nv_bfloat16* p8 = p0 + static_cast<size_t>(8) * ld;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag[kk][0] = *reinterpret_cast<const uint32_t*>(p0 + kk * 16);
    frag[kk][1] = *reinterpret_cast<const uint32_t*>(p8 + kk * 16);
    frag[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + kk * 16 + 8);
    frag[kk][3] = *reinterpret_cast<const uint32_t*>(p8 + kk * 16 + 8);
  }
}

// Accumulator columns 16kk..16kk+15 as a bf16 A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float* d, int kk) {
  a[0] = pack_bf16x2(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

// Keep A fragments alive (and unmoved) up to this point: an issued wgmma
// reads them until a wait_group retires it.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

// Rows g and g + 8 of a warp's 16 x 64 f32 accumulator, times inv0 / inv8,
// as bf16 into a packed tensor at `rows` (row stride ld), each row only if
// its flag is set.
__device__ __forceinline__ void store_acc(__nv_bfloat16* rows, int ld, const float* d, float inv0,
                                          float inv8, bool ok0, bool ok8, int g, int t) {
  __nv_bfloat16* o0 = rows + static_cast<size_t>(g) * ld + t * 2;
  __nv_bfloat16* o8 = o0 + static_cast<size_t>(8) * ld;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (ok0)
      *reinterpret_cast<uint32_t*>(o0 + j * 8) = pack_bf16x2(d[4 * j] * inv0, d[4 * j + 1] * inv0);
    if (ok8)
      *reinterpret_cast<uint32_t*>(o8 + j * 8) = pack_bf16x2(d[4 * j + 2] * inv8, d[4 * j + 3] * inv8);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

}  // namespace attn_hopper
