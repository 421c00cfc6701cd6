// Packed-layout flash-attention forward for Hopper (sm_90a).
//
// Replaces genima_tpu/kernels/packed_attention.py::_packed_kernel (resident
// K/V) and ::_streaming_kernel (online softmax over key blocks): one kernel
// covers both, since a block's shared memory cannot hold a 4096-row K/V.
// Its training variant also replaces ::_packed_kernel_lse: the same kernel,
// instantiated to write L = m + log(l) per (row, head) as well, the softmax
// normaliser the backward (packed_attention_bwd.cu) rebuilds P from.
//
// Layout: q, k, v and o are (B, S, heads * 64) bf16, row-major, exactly as
// the to_q / to_k / to_v projections emit them. A block reads head h as the
// 64 columns at offset h * 64 with row stride C = heads * 64, so no
// (S, H, D) -> (H, S, D) transpose ever touches device memory. L is
// (B, S, heads) f32.
//
// Design (FlashAttention-2 forward):
//   * one block per (64-query tile, head, batch); 4 warps, 16 query rows
//     each, Q held in registers. A 128-row tile (8 warps) halves the L2
//     reads of K/V but measured slower at 4096 tokens (160 blocks on 132
//     SMs), so the tile stays at 64 rows;
//   * a loop over 64-key tiles, double-buffered in shared memory with cp.async
//     and read into mma fragments with ldmatrix;
//   * S = Q K^T and O += P V on the tensor cores through mma.sync m16n8k16
//     (bf16 in, f32 accumulate); the running row max and row sum stay in
//     registers in f32 (online softmax), P is rounded to bf16 before P V as
//     the TPU kernel does;
//   * O / l is written once, as bf16, at the same packed offsets.
//
// Bound: at the SD levels this is 4 * S^2 * C flops over 8 * S * C bytes, far
// above the card's ~295 flop/byte ridge, so it is bound by tensor-core
// operations (and by the S^2 * H exponentials on the special-function units,
// about as costly). The design keeps scores out of device memory and uses
// the tensor cores; wgmma, TMA and warp specialisation are later work.

#include "attention_common.cuh"

namespace {

using namespace packed_attn;
constexpr int kBlockM = kWarps * 16;  // query rows per block
constexpr int kBlockN = kTile;        // keys per tile

template <bool kWriteLse>
__global__ void __launch_bounds__(kThreads)
packed_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int sq,
                            int sk, int c, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 s_k[2][kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 s_v[2][kBlockN * kStride];

  const int q_tile = blockIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  const __nv_bfloat16* q_blk =
      q + (static_cast<size_t>(batch) * sq + static_cast<size_t>(q_tile) * kBlockM) * c +
      head * kHeadDim;
  const __nv_bfloat16* k_blk = k + static_cast<size_t>(batch) * sk * c + head * kHeadDim;
  const __nv_bfloat16* v_blk = v + static_cast<size_t>(batch) * sk * c + head * kHeadDim;

  load_tile(s_k[0], k_blk, c);
  load_tile(s_v[0], v_blk, c);
  cp_async_commit();

  // Q stays in registers as mma A fragments for the whole key loop, loaded
  // once straight from global memory: rows g and g + 8 of this warp's 16.
  uint32_t q_frag[4][4];
  load_a_frags(q_frag, q_blk + static_cast<size_t>(warp * 16) * c, c, g, t);
  float acc[8][4];
  zero_acc(acc);
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  const int n_tiles = sk / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      const size_t off = static_cast<size_t>(j + 1) * kBlockN * c;
      load_tile(s_k[cur ^ 1], k_blk + off, c);
      load_tile(s_v[cur ^ 1], v_blk + off, c);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 tiles of 8 keys).
    float s[8][4];
    zero_acc(s);
    mma_a_yt(s, q_frag, s_k[cur], lane);

    // Online softmax in base 2 on raw scores: rows g (regs 0, 1) and g + 8
    // (regs 2, 3); row_max is kept pre-scaled, so p = 2^(s*scale - max) is
    // one FFMA and one EX2.
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      tile_max[0] = fmaxf(tile_max[0], fmaxf(s[nt][0], s[nt][1]));
      tile_max[1] = fmaxf(tile_max[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 2));
      const float m_new = fmaxf(row_max[r], tile_max[r] * scale_log2);
      alpha[r] = exp2_approx(row_max[r] - m_new);
      row_max[r] = m_new;
      row_sum[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2_approx(fmaf(s[nt][0], scale_log2, -row_max[0]));
      s[nt][1] = exp2_approx(fmaf(s[nt][1], scale_log2, -row_max[0]));
      s[nt][2] = exp2_approx(fmaf(s[nt][2], scale_log2, -row_max[1]));
      s[nt][3] = exp2_approx(fmaf(s[nt][3], scale_log2, -row_max[1]));
      row_sum[0] += s[nt][0] + s[nt][1];
      row_sum[1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments become the A operand directly.
    mma_c_y(acc, s, s_v[cur], lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 2);
  }
  const int row0 = q_tile * kBlockM + warp * 16;
  store_acc_bf16(o + (static_cast<size_t>(batch) * sq + row0) * c + head * kHeadDim, c, acc,
                 1.f / row_sum[0], 1.f / row_sum[1], g, t);
  if (kWriteLse && t == 0) {
    // L = m + ln(l) in natural-log units: row_max is m * log2(e).
    const int heads = c / kHeadDim;
    float* l0 = lse + (static_cast<size_t>(batch) * sq + row0 + g) * heads + head;
    l0[0] = (row_max[0] + log2f(row_sum[0])) * kLn2;
    l0[static_cast<size_t>(8) * heads] = (row_max[1] + log2f(row_sum[1])) * kLn2;
  }
}

template <bool kWriteLse>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
               int sq, int sk, int heads, void* stream) {
  const dim3 grid(sq / kBlockM, heads, batch);
  const float scale_log2 = kLog2e / 8.0f;  // log2(e) / sqrt(64)
  packed_attention_fwd_kernel<kWriteLse>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sq, sk,
          heads * kHeadDim, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// softmax(Q_h K_h^T / 8) V_h for every head h of packed (B, S, heads * 64)
// bf16 tensors. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so the caller sees a refused launch.
int packed_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                         int sq, int sk, int heads, void* stream) {
  return launch_fwd<false>(q, k, v, o, nullptr, batch, sq, sk, heads, stream);
}

// The same, and L = m + log(l) per (row, head) into the (B, Sq, heads) f32
// tensor `lse`.
int packed_attention_fwd_lse(const void* q, const void* k, const void* v, void* o, void* lse,
                             int batch, int sq, int sk, int heads, void* stream) {
  return launch_fwd<true>(q, k, v, o, static_cast<float*>(lse), batch, sq, sk, heads,
                          stream);
}

const char* packed_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
