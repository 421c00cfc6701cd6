// Float32 attention for Hopper (sm_90a) on packed (B, S, heads * d) f32
// tensors: the forward shared by B1/B2a (packed_attention.cu) and B3
// (flash_attention.cu), and the helpers B2b's f32 backward
// (packed_attention_bwd.cu) shares with it.
//
// On f32 inputs the TPU kernels (genima_tpu/kernels/packed_attention.py
// _packed_kernel, _packed_kernel_lse, _bwd_kernel; flash_attention.py
// _flash_kernel) take the input's dtype through: S = Q K^T, P V and the
// backward's products in f32, P and dS kept in f32, outputs in f32. This
// file computes the same: non-causal softmax(Q K^T / sqrt(d)) V with an
// online softmax in f32, keys at or past Sk masked out, query rows at or past
// Sq never stored; with kWriteLse also L = m + ln(l) per (row, head) into a
// (B, Sq, heads) f32 tensor; and the flash backward dq, dk, dv from q, k, v,
// o, L and dO (Drow = rowsum(dO * O), P = exp(S / sqrt(d) - L),
// dS = P * (dP - Drow) / sqrt(d)).
//
// Why FFMA on the CUDA cores and not the tensor cores: Hopper's tensor cores
// take f32 only as TF32 (10 mantissa bits, about three decimal digits), and a
// single TF32 pass misses the f32 results by ~1e-3 at unit-scale inputs,
// where these kernels are held to 1e-4. A 3xTF32 split (a = a_hi + a_lo,
// hi*hi + hi*lo + lo*hi) would reach f32 accuracy at up to 165 TFLOP/s, but
// wgmma takes TF32 operands K-major only, so P V, P^T dO, dS^T Q and dS K
// would need transposed tiles or mma.sync from registers. FFMA needs
// neither: every product reads its operands straight from row-major tiles.
// This is the simple kernel that is right; its bound is FFMA's 67 TFLOP/s.
//
// Bound: the forward does 4 * B * Sq * Sk * C flops on 4 * B * (2 Sq + 2 Sk) C
// bytes, the backward 10 * B * Sq * Sk * C on ~4 * B * (4 Sq + 4 Sk) C: at
// the SD levels FFMA bounds both (about 25 flops a byte at 256 tokens,
// 400 at 4096, against FFMA's 20 per HBM byte).
//
// Design: a block is 256 threads, a 16 x 16 grid (ty = threadIdx.x / 16,
// tx = threadIdx.x % 16), over a tile of R query rows (or keys): R = 64,
// and 32 for the backward at head dims above 192 (shared memory). A head of
// d columns (1 to 256, any value: no TMA, so no padding) is held in shared
// memory as DA = ceil(d / 64) atoms of 64 columns, zeros past d, every row
// 64 * DA + 1 floats apart. The odd row stride is what makes the two kinds
// of product free of bank conflicts with one scalar load a value:
//   * X Y^T (S = Q K^T, dP = dO V^T and their transposes): thread (ty, tx)
//     owns rows ty + 16 r and columns tx + 16 c (r, c < R / 16); at column e
//     a warp reads two rows of X (broadcasts) and 16 rows of Y, which lie in
//     16 banks;
//   * X Y (O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q): thread owns
//     rows ty + 16 r and head columns tx + 16 n (n < 4 DA); at contraction
//     index j a warp reads two values of X and 16 consecutive of Y.
// The online softmax's row max and row sum are shared by the 16 threads of a
// row (lanes of one half warp, shuffles xor 8, 4, 2, 1). The forward streams
// K and V tiles of 64 keys through shared memory beside the block's Q tile;
// P goes through shared memory to P V. The backward (packed_attention_bwd.cu,
// on these helpers) is two kernels, as the bf16 one is, with no atomics (two
// calls give the same bits): the dq kernel
// (a block of query rows: Q and dO resident, K and V streamed) also writes
// Drow for the dk/dv kernel (a block of keys: K and V resident, Q and dO
// streamed, P^T and dS^T through shared memory).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_f32 {

// Internal linkage, as attention_fwd_hopper.cuh: the launch functions'
// `configured` statics must be one per library.
namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kFwdRows = 64;   // query rows a forward block, keys a K/V tile
constexpr int kMaxHeadDim = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

inline int head_atoms(int d) { return (d + 63) / 64; }
inline bool head_dim_ok(int d) { return d >= 1 && d <= kMaxHeadDim; }

// Dynamic shared memory of a forward block: Q, K and V tiles and P.
int fwd_smem_bytes(int da) {
  const int ld = 64 * da + 1;
  return 4 * (3 * kFwdRows * ld + kFwdRows * (kFwdRows + 1));
}

// Rows row0 .. row0 + R - 1 (of s in the batch) of the d head columns at
// col0 of a (B, s, ldg) f32 tensor into an R x W tile with row stride LD;
// zeros at or past s and d.
template <int R, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int batch, int row0,
                                          int s, int ldg, int col0, int d) {
  for (int idx = threadIdx.x; idx < R * W; idx += kThreads) {
    const int r = idx / W, e = idx - r * W;
    const int row = row0 + r;
    float v = 0.f;
    if (row < s && e < d) v = src[(static_cast<size_t>(batch) * s + row) * ldg + col0 + e];
    dst[r * LD + e] = v;
  }
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// --- forward -----------------------------------------------------------------

struct FwdParams {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (B, Sq, heads), written by the kWriteLse kernels
  int sq, sk, c, d, heads;
  float scale_log2;  // log2(e) / sqrt(d)
};

template <int DA, bool kWriteLse>
__global__ void __launch_bounds__(kThreads, DA == 1 ? 3 : 1)
attention_f32_fwd_kernel(const FwdParams p) {
  constexpr int R = kFwdRows, W = 64 * DA, LD = W + 1, LDP = R + 1, NC = 4 * DA;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + R * LD;
  float* vs = ks + R * LD;
  float* ps = vs + R * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * R, head = blockIdx.y, b = blockIdx.z;
  const int col0 = head * p.d;
  load_tile<R, W, LD>(qs, p.q, b, q0, p.sq, p.c, col0, p.d);

  float o[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) o[r][n] = 0.f;
  }

  for (int k0 = 0; k0 < p.sk; k0 += R) {
    __syncthreads();  // Q stored; the previous tile's K, V and P read
    load_tile<R, W, LD>(ks, p.k, b, k0, p.sk, p.c, col0, p.d);
    load_tile<R, W, LD>(vs, p.v, b, k0, p.sk, p.c, col0, p.d);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int e = 0; e < p.d; ++e) {
      float a[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qs[(ty + 16 * r) * LD + e];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = ks[(tx + 16 * c) * LD + e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], kb[c], s[r][c]);
    }
    const int valid = min(R, p.sk - k0);  // keys of this tile below Sk
    // online softmax in base 2; m is kept scaled, so p = 2^(s * scale - m)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (tx + 16 * c < valid) mx = fmaxf(mx, s[r][c]);
      const float m_new = fmaxf(m[r], max16(mx) * p.scale_log2);
      const float alpha = exp2f(m[r] - m_new);  // 0 at the first tile
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e =
            tx + 16 * c < valid ? exp2f(fmaf(s[r][c], p.scale_log2, -m_new)) : 0.f;
        ps[(ty + 16 * r) * LDP + tx + 16 * c] = e;
        sum += e;
      }
      l[r] = l[r] * alpha + sum;  // this thread's columns; summed over the row at the end
#pragma unroll
      for (int n = 0; n < NC; ++n) o[r][n] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < valid; ++j) {
      float pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = ps[(ty + 16 * r) * LDP + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float vv = vs[j * LD + tx + 16 * n];
#pragma unroll
        for (int r = 0; r < 4; ++r) o[r][n] = fmaf(pr[r], vv, o[r][n]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) l[r] = sum16(l[r]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= p.sq) continue;
    const size_t at = static_cast<size_t>(b) * p.sq + row;
    float* dst = p.o + at * p.c + col0;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (tx + 16 * n < p.d) dst[tx + 16 * n] = o[r][n] * inv;
    if constexpr (kWriteLse) {
      // L = m + ln(l) in natural-log units: m is the max times log2(e)
      if (tx == 0) p.lse[at * p.heads + head] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int DA, bool kWriteLse>
int launch_fwd(const FwdParams& p, int batch, cudaStream_t stream) {
  const int smem = fwd_smem_bytes(DA);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_f32_fwd_kernel<DA, kWriteLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((p.sq + kFwdRows - 1) / kFwdRows, p.heads, batch);
  attention_f32_fwd_kernel<DA, kWriteLse><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The forward on (B, Sq, heads * d) q, (B, Sk, heads * d) k and v, into o
// and, with kWriteLse, L; 0 or a CUDA error code. A template, so that each
// library instantiates only the kernels it launches.
template <bool kWriteLse>
int forward(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int sq,
            int sk, int heads, int d, cudaStream_t stream) {
  if (batch < 1 || sq < 1 || sk < 1 || heads < 1 || !head_dim_ok(d))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = lse;
  p.sq = sq;
  p.sk = sk;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(d)));
  switch (head_atoms(d)) {
    case 1: return launch_fwd<1, kWriteLse>(p, batch, stream);
    case 2: return launch_fwd<2, kWriteLse>(p, batch, stream);
    case 3: return launch_fwd<3, kWriteLse>(p, batch, stream);
    default: return launch_fwd<4, kWriteLse>(p, batch, stream);
  }
}

}  // namespace
}  // namespace attn_f32
