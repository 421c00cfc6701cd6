// Device helpers of the mma.sync packed flash-attention forward (B1 and B2a
// in packed_attention.cu): cp.async tile loads, ldmatrix, and the bf16
// mma.sync m16n8k16 tensor-core product. The Hopper kernels (B2b, B3) use
// attention_hopper.cuh instead.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                           a3 = (g+8, 2t+8..)
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// Two adjacent C tiles (n = 0..7 and 8..15), rounded to bf16, are exactly the
// A fragment of a product whose k runs over those 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace packed_attn {

constexpr int kHeadDim = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;              // rows of a query or key tile
constexpr int kStride = kHeadDim + 8;  // padded smem row (bf16 elements)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory into mma fragments: as stored
// (the B operand of X Y^T from row-major Y) ...
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// ... or transposed (the B operand of X Y from row-major Y).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 64 rows x 64 bf16 from global (row stride ld elements) into padded smem.
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                          int ld) {
#pragma unroll
  for (int i = 0; i < (kTile * 8) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int row = idx >> 3;
    const int col = (idx & 7) * 8;
    cp_async_16(smem + row * kStride + col, gmem + static_cast<size_t>(row) * ld + col);
  }
}

// A warp's 16 rows x 64 columns of a packed tensor, straight from global
// memory into mma A fragments (4 k-steps of 16 columns): rows g and g + 8.
__device__ __forceinline__ void load_a_frags(uint32_t frag[4][4], const __nv_bfloat16* rows,
                                             int ld, int g, int t) {
  const __nv_bfloat16* p0 = rows + static_cast<size_t>(g) * ld + t * 2;
  const __nv_bfloat16* p8 = p0 + static_cast<size_t>(8) * ld;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag[kk][0] = ld_u32(p0 + kk * 16);
    frag[kk][1] = ld_u32(p8 + kk * 16);
    frag[kk][2] = ld_u32(p0 + kk * 16 + 8);
    frag[kk][3] = ld_u32(p8 + kk * 16 + 8);
  }
}

// acc[16 rows x 64 cols] += A[16 x 64] * Y^T, where Y is a row-major 64 x 64
// smem tile: out column n is row n of Y (the Q K^T pattern). ldmatrix lanes
// 8i..8i+7 address rows of matrix i = columns 8i..8i+7 (of 32) of 8 Y rows.
__device__ __forceinline__ void mma_a_yt(float acc[8][4], const uint32_t a[4][4],
                                         const __nv_bfloat16* y, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const __nv_bfloat16* ys = y + (nt * 8 + (lane & 7)) * kStride + (lane >> 3) * 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t b[4];
      ldmatrix_x4(b, ys + half * 32);
      mma_bf16_16816(acc[nt], a[2 * half], b);
      mma_bf16_16816(acc[nt], a[2 * half + 1], b + 2);
    }
  }
}

// acc[16 x 64] += X[16 x 64] * Y, with X given as f32 C fragments (rounded to
// bf16 here) over Y's 64 rows and Y a row-major 64 x 64 smem tile (the P V
// pattern). ldmatrix.trans lanes 0-7 / 8-15 / 16-23 / 24-31 address matrices
// (rows +0, cols +0), (rows +8, cols +0), (rows +0, cols +8), (rows +8, cols +8).
__device__ __forceinline__ void mma_c_y(float acc[8][4], const float x[8][4],
                                        const __nv_bfloat16* y, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {
        pack_bf16x2(x[2 * kk][0], x[2 * kk][1]),
        pack_bf16x2(x[2 * kk][2], x[2 * kk][3]),
        pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]),
    };
    const int mi = lane >> 3;
    const __nv_bfloat16* ys = y + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kStride + (mi >> 1) * 8;
#pragma unroll
    for (int dt = 0; dt < 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, ys + dt * 8);
      mma_bf16_16816(acc[dt], a, b);
      mma_bf16_16816(acc[dt + 1], a, b + 2);
    }
  }
}

__device__ __forceinline__ void zero_acc(float acc[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
}

// Rows g and g + 8 of a warp's 16 x 64 f32 accumulator, times `scale`, as
// bf16 into a packed tensor at `rows` (row stride ld elements).
__device__ __forceinline__ void store_acc_bf16(__nv_bfloat16* rows, int ld, const float acc[8][4],
                                               float scale0, float scale8, int g, int t) {
  __nv_bfloat16* o0 = rows + static_cast<size_t>(g) * ld + t * 2;
  __nv_bfloat16* o8 = o0 + static_cast<size_t>(8) * ld;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    *reinterpret_cast<uint32_t*>(o0 + dt * 8) =
        pack_bf16x2(acc[dt][0] * scale0, acc[dt][1] * scale0);
    *reinterpret_cast<uint32_t*>(o8 + dt * 8) =
        pack_bf16x2(acc[dt][2] * scale8, acc[dt][3] * scale8);
  }
}

}  // namespace packed_attn
