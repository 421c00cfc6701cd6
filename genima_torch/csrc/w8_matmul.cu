// Weight-only int8 matmul for Hopper (sm_90a): out = (x @ w_q^T) * scale.
//
// Replaces genima_tpu/kernels/w8_matmul.py::_w8_matmul_2d / _kernel (and
// w8_matmul_interpret, the same kernel body): x (M, K) bf16, w_q (N, K) int8
// (the nn.Linear layout, one row per output column), scale (N,) f32, out
// (M, N) bf16. The int8 weights travel from device memory to shared memory
// as int8 and are widened to bf16 in registers on their way into the tensor
// cores, so no dequantised copy of the weight is ever written; the f32
// accumulator is multiplied by the per-column scale once, in the epilogue.
//
// Design: a tiled GEMM with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   * one block per (64-row, 128-column) output tile; 4 warps in 2 x 2, each
//     32 rows x 64 columns;
//   * K is walked in 32-wide tiles through a 3-stage cp.async ring (the TPU
//     kernel holds all of K in one VMEM block, which Hopper's shared memory
//     cannot for K = 10240);
//   * x fragments come through ldmatrix; each weight fragment is two int8
//     pairs read from shared memory and converted exactly to bf16
//     (|w_q| <= 127 fits bf16's 8-bit significand);
//   * ragged M and N edges are zero-filled on load (cp.async with a source
//     size of 0) and masked on store. The TPU wrapper sends M = 77 and
//     N % 128 != 0 to an XLA fallback, a lane restriction of that chip that
//     does not exist here: every shape with K % 16 == 0 and N % 8 == 0 runs.
//
// Bound: 2*M*K*N flops on M*K*2 + K*N + M*N*2 bytes. At M = 4096 tokens the
// tensor cores bound it; at M <= 256 (the 16x16 and 8x8 levels, and the
// 77-token cross-attention K/V) the weight bytes do, which is where int8
// halves the traffic of a bf16 weight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kXStride = kBK + 8;   // bf16 per smem row of x (80 bytes)
constexpr int kWStride = kBK + 16;  // int8 per smem row of w (48 bytes)

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two adjacent int8 weights (k, k+1 of one output column) as a bf16 pair.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  __nv_bfloat162 r = __floats2bfloat162_rn(static_cast<float>(v.x), static_cast<float>(v.y));
  return *reinterpret_cast<uint32_t*>(&r);
}

__global__ void __launch_bounds__(kThreads)
w8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int m, int n,
                 int k) {
  __shared__ __align__(16) __nv_bfloat16 s_x[kStages][kBM * kXStride];
  __shared__ __align__(16) int8_t s_w[kStages][kBN * kWStride];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 1;  // 32-row half of the tile
  const int wn = warp & 1;   // 64-column half
  const int g = lane >> 2;
  const int t = lane & 3;

  // one K tile: 64 x 32 bf16 of x (4 x 16 B per row) and 128 x 32 int8 of w
  // (2 x 16 B per row); each thread copies two 16-byte pieces of each
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx >> 2, col = (idx & 3) * 8;
      const bool ok = m0 + row < m && k0 + col < k;
      const __nv_bfloat16* src = ok ? x + static_cast<size_t>(m0 + row) * k + k0 + col : x;
      cp_async_16(&s_x[stage][row * kXStride + col], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx >> 1, col = (idx & 1) * 16;
      const bool ok = n0 + row < n && k0 + col < k;
      const int8_t* src = ok ? w + static_cast<size_t>(n0 + row) * k + k0 + col : w;
      cp_async_16(&s_w[stage][row * kWStride + col], src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int n_tiles = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage(s, s * kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // refill the stage consumed one iteration ago
    const int next = kt + kStages - 1;
    if (next < n_tiles) load_stage(next % kStages, next * kBK);
    cp_async_commit();

    const __nv_bfloat16* xs = s_x[kt % kStages];
    const int8_t* ws = s_w[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldmatrix_x4(a[mt], xs + (wm * 32 + mt * 16 + (lane & 15)) * kXStride + kk * 16 +
                               (lane >> 4) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* wp = ws + (wn * 64 + nt * 8 + g) * kWStride + kk * 16 + 2 * t;
        const uint32_t b[2] = {int8x2_to_bf16x2(wp), int8x2_to_bf16x2(wp + 8)};
        mma_bf16_16816(acc[0][nt], a[0], b);
        mma_bf16_16816(acc[1][nt], a[1], b);
      }
    }
  }

  // epilogue: the per-column scale once, then bf16, masked at the edges
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + wn * 64 + nt * 8 + 2 * t;
    if (col >= n) continue;  // n % 8 == 0: col and col + 1 are both in or out
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mt * 16 + g + half * 8;
        if (row >= m) continue;
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][nt][2 * half] * s0,
                                                 acc[mt][nt][2 * half + 1] * s1);
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * n + col) = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// out (M, N) bf16 = (x (M, K) bf16 @ w_q (N, K) int8 ^T) * scale (N,) f32.
// Needs K % 16 == 0 and N % 8 == 0 (the wrapper checks). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
int w8_matmul(const void* x, const void* w_q, const void* scale, void* out, int m, int n, int k,
              void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  w8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

const char* w8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
