// Packed-layout flash-attention backward for Hopper (sm_90a).
//
// Replaces genima_tpu/kernels/packed_attention.py::_flash_backward /
// _bwd_kernel: dq, dk and dv of softmax(Q_h K_h^T / 8) V_h from q, k, v, o,
// dO and the forward's L = m + log(l) (packed_attention_fwd_lse), with the
// TPU kernel's arithmetic:
//   P  = exp(S / 8 - L), rounded to bf16 before P^T dO;
//   dP = dO V^T;  Drow = rowsum(dO * O);
//   dS = P (dP - Drow) / 8, rounded to bf16;
//   dQ = dS K accumulated in f32 over key tiles; dK = dS^T Q; dV = P^T dO.
//
// Layout: every tensor is packed (B, S, heads * 64) bf16, read at column
// offset h * 64 with row stride C, as the forward reads it. The TPU wrapper
// transposes to (B * heads, S, 64) around its kernel; the packed kernel
// exists to avoid those transposes, so this one reads head-strided instead.
// L and Drow are (B, Sq, heads) f32.
//
// Design (FlashAttention-2 backward, two kernels, no atomics, deterministic):
//   * dq kernel: one block per (64-query tile, head, batch), 4 warps of 16
//     query rows with Q and dO in registers. Its prologue computes
//     Drow = rowsum(dO * O) for its rows (stored for the next kernel); then a
//     loop over 64-key tiles (K, V double-buffered through cp.async)
//     rebuilds P, forms dS and accumulates dQ = dS K in f32 registers.
//   * dk/dv kernel: one block per (64-key tile, head, batch), 4 warps of 16
//     keys with K and V in registers, looping over 64-query tiles (Q, dO, L,
//     Drow double-buffered). It works on the transposed scores S^T = K Q^T,
//     so P^T and dS^T come out of the mma accumulators already in the A
//     layout of dV += P^T dO and dK += dS^T Q.
//   Both kernels run mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// Bound: 10 * S^2 * C flops (the TPU kernel's cost estimate: S, dP, dV, dQ,
// dK) over ~16 * S * C bytes, so tensor-core operations bound it. This
// design does 14 * S^2 * C (S and dP are formed in both kernels), the
// price of having no atomics; wgmma and TMA are later work.

#include "attention_common.cuh"

namespace {

using namespace packed_attn;

__global__ void __launch_bounds__(kThreads)
packed_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ o,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse, float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dq, int sq, int sk, int c,
                               float scale_log2, float scale) {
  __shared__ __align__(16) __nv_bfloat16 s_k[2][kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 s_v[2][kTile * kStride];

  const int q_tile = blockIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int heads = c / kHeadDim;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int row0 = q_tile * kTile + warp * 16;  // this warp's first query row
  const size_t rows_off = (static_cast<size_t>(batch) * sq + row0) * c + head * kHeadDim;
  const __nv_bfloat16* k_blk = k + static_cast<size_t>(batch) * sk * c + head * kHeadDim;
  const __nv_bfloat16* v_blk = v + static_cast<size_t>(batch) * sk * c + head * kHeadDim;

  load_tile(s_k[0], k_blk, c);
  load_tile(s_v[0], v_blk, c);
  cp_async_commit();

  uint32_t q_frag[4][4], do_frag[4][4];
  load_a_frags(q_frag, q + rows_off, c, g, t);
  load_a_frags(do_frag, dout + rows_off, c, g, t);

  // Prologue: Drow for rows g and g + 8 from dO and O in the same fragment
  // pattern (f32 products of the bf16 values, as the TPU wrapper sums them).
  float drow[2] = {0.f, 0.f};
  {
    uint32_t o_frag[4][4];
    load_a_frags(o_frag, o + rows_off, c, g, t);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = unpack_bf16x2(do_frag[kk][i]);
        const float2 b = unpack_bf16x2(o_frag[kk][i]);
        drow[i & 1] += a.x * b.x + a.y * b.y;  // regs 0, 2: row g; 1, 3: row g + 8
      }
    }
  }
  float l2[2];
  const size_t lrow = (static_cast<size_t>(batch) * sq + row0 + g) * heads + head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    drow[r] += __shfl_xor_sync(0xffffffff, drow[r], 1);
    drow[r] += __shfl_xor_sync(0xffffffff, drow[r], 2);
    l2[r] = lse[lrow + static_cast<size_t>(8 * r) * heads] * kLog2e;
  }
  if (t == 0) {
    delta[lrow] = drow[0];
    delta[lrow + static_cast<size_t>(8) * heads] = drow[1];
  }

  float acc[8][4];
  zero_acc(acc);
  const int n_tiles = sk / kTile;
  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      const size_t off = static_cast<size_t>(j + 1) * kTile * c;
      load_tile(s_k[cur ^ 1], k_blk + off, c);
      load_tile(s_v[cur ^ 1], v_blk + off, c);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float p[8][4], ds[8][4];
    zero_acc(p);
    zero_acc(ds);
    mma_a_yt(p, q_frag, s_k[cur], lane);    // S = Q K^T
    mma_a_yt(ds, do_frag, s_v[cur], lane);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        p[nt][i] = exp2_approx(fmaf(p[nt][i], scale_log2, -l2[r]));
        ds[nt][i] = p[nt][i] * (ds[nt][i] - drow[r]) * scale;
      }
    }
    mma_c_y(acc, ds, s_k[cur], lane);  // dQ += bf16(dS) K
    __syncthreads();
  }
  store_acc_bf16(dq + rows_off, c, acc, 1.f, 1.f, g, t);
}

__global__ void __launch_bounds__(kThreads)
packed_attention_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv, int sq, int sk, int c,
                                 float scale_log2, float scale) {
  __shared__ __align__(16) __nv_bfloat16 s_q[2][kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 s_do[2][kTile * kStride];
  __shared__ float s_l[2][kTile];  // L * log2(e) of the tile's query rows
  __shared__ float s_d[2][kTile];  // Drow of the tile's query rows

  const int k_tile = blockIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int heads = c / kHeadDim;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t keys_off =
      (static_cast<size_t>(batch) * sk + k_tile * kTile + warp * 16) * c + head * kHeadDim;
  const __nv_bfloat16* q_blk = q + static_cast<size_t>(batch) * sq * c + head * kHeadDim;
  const __nv_bfloat16* do_blk = dout + static_cast<size_t>(batch) * sq * c + head * kHeadDim;
  const size_t lbase = static_cast<size_t>(batch) * sq * heads + head;

  auto prefetch = [&](int i, int buf) {
    const size_t off = static_cast<size_t>(i) * kTile * c;
    load_tile(s_q[buf], q_blk + off, c);
    load_tile(s_do[buf], do_blk + off, c);
    if (threadIdx.x < kTile) {
      const size_t li = lbase + static_cast<size_t>(i * kTile + threadIdx.x) * heads;
      s_l[buf][threadIdx.x] = lse[li] * kLog2e;
      s_d[buf][threadIdx.x] = delta[li];
    }
  };
  prefetch(0, 0);
  cp_async_commit();

  uint32_t k_frag[4][4], v_frag[4][4];
  load_a_frags(k_frag, k + keys_off, c, g, t);
  load_a_frags(v_frag, v + keys_off, c, g, t);
  float dk_acc[8][4], dv_acc[8][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);

  const int n_tiles = sq / kTile;
  for (int i = 0; i < n_tiles; ++i) {
    const int cur = i & 1;
    if (i + 1 < n_tiles) {
      prefetch(i + 1, cur ^ 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // Transposed scores: rows are this warp's keys g, g + 8; column
    // nt * 8 + 2t (+1) is a query row of the tile.
    float p[8][4], ds[8][4];
    zero_acc(p);
    zero_acc(ds);
    mma_a_yt(p, k_frag, s_q[cur], lane);    // S^T = K Q^T
    mma_a_yt(ds, v_frag, s_do[cur], lane);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        p[nt][e] = exp2_approx(fmaf(p[nt][e], scale_log2, -s_l[cur][col]));
        ds[nt][e] = p[nt][e] * (ds[nt][e] - s_d[cur][col]) * scale;
      }
    }
    mma_c_y(dv_acc, p, s_do[cur], lane);  // dV += bf16(P^T) dO
    mma_c_y(dk_acc, ds, s_q[cur], lane);  // dK += bf16(dS^T) Q
    __syncthreads();
  }
  store_acc_bf16(dk + keys_off, c, dk_acc, 1.f, 1.f, g, t);
  store_acc_bf16(dv + keys_off, c, dv_acc, 1.f, 1.f, g, t);
}

}  // namespace

extern "C" {

// dq, dk, dv of packed (B, S, heads * 64) bf16 attention, from the forward's
// o and (B, Sq, heads) f32 lse and the output gradient dout. `delta` is a
// (B, Sq, heads) f32 scratch the first kernel fills with rowsum(dO * O) for
// the second. Launches both kernels on `stream`, does not synchronise, and
// returns the first launch error (0 when both were accepted).
int packed_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* lse, const void* dout, void* delta, void* dq, void* dk,
                         void* dv, int batch, int sq, int sk, int heads, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int c = heads * kHeadDim;
  const float scale = 0.125f;  // 1 / sqrt(64)
  const float scale_log2 = kLog2e * scale;
  const auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  packed_attention_bwd_dq_kernel<<<dim3(sq / kTile, heads, batch), kThreads, 0, st>>>(
      bf(q), bf(k), bf(v), bf(o), bf(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<__nv_bfloat16*>(dq), sq, sk, c, scale_log2,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  packed_attention_bwd_dkdv_kernel<<<dim3(sk / kTile, heads, batch), kThreads, 0, st>>>(
      bf(q), bf(k), bf(v), bf(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, sk, c, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* packed_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
