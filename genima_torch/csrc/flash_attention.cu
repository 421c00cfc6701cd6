// Flash-attention forward on (B, S, H, 64) for Hopper (sm_90a), any S.
//
// Replaces genima_tpu/kernels/flash_attention.py::_flash_forward /
// _flash_kernel: non-causal softmax(Q K^T / sqrt(64)) V with an online
// softmax in f32, P rounded to bf16 before P V, keys at or past Sk masked to
// -1e30 and padded query rows never stored. The JAX wrapper transposes
// (B, S, H, D) to (B*H, S, D) around its kernel, a TPU tiling artifact that
// is not carried over: (B, S, H, 64) is the packed (B, S, H*64) layout the
// projections emit, and a block reads head h as the 64 columns at offset
// h * 64 with row stride H * 64, as B1 (packed_attention.cu) does.
//
// What differs from B1 is the ragged edge. The serving path sends this
// kernel the 77-token cross-attention (Sk = 77) and the 64-token mid block,
// and the tests send 33 and 100 tokens, so:
//   * K/V rows at or past Sk and Q rows at or past Sq are zero-filled on load
//     (cp.async with a source size of 0, or a zero register), never read out
//     of bounds;
//   * scores of keys at or past Sk are set to -1e30 before the row max, so
//     the masked keys of the last tile get p = 0; every earlier tile holds a
//     real key, so the row max is finite by then and no row gives a NaN;
//   * rows at or past Sq are computed on zeros and not stored.
//
// Design (FlashAttention-2 forward, as B1): one block per (64-query tile,
// head, batch), 4 warps of 16 query rows, Q in registers, 64-key K/V tiles
// double-buffered in shared memory with cp.async and read into mma
// fragments with ldmatrix, mma.sync m16n8k16 in bf16 with f32 accumulators.
//
// Bound: 4 * B * Sq * Sk * C flops on 2 * B * (2 * Sq + 2 * Sk) * C bytes.
// Self-attention at 4096 and 1024 tokens is bound by tensor-core operations;
// cross-attention over 77 keys does 4 * 77 flops per q byte pair and is bound
// by reading q and writing o.

#include "attention_common.cuh"

namespace {

using namespace packed_attn;
constexpr int kBlockM = kWarps * 16;
constexpr int kBlockN = kTile;
constexpr float kMasked = -1e30f;  // the JAX kernel's _NEG_INF

__device__ __forceinline__ void cp_async_16_zfill(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

// load_tile (attention_common.cuh) with rows at or past `rows` zero-filled.
__device__ __forceinline__ void load_tile_rows(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                               int ld, int rows) {
#pragma unroll
  for (int i = 0; i < (kTile * 8) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int row = idx >> 3;
    const int col = (idx & 7) * 8;
    const bool ok = row < rows;
    cp_async_16_zfill(smem + row * kStride + col,
                      ok ? gmem + static_cast<size_t>(row) * ld + col : gmem, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int sq, int sk, int c, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 s_k[2][kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 s_v[2][kBlockN * kStride];

  const int q_tile = blockIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* k_blk = k + static_cast<size_t>(batch) * sk * c + head * kHeadDim;
  const __nv_bfloat16* v_blk = v + static_cast<size_t>(batch) * sk * c + head * kHeadDim;

  load_tile_rows(s_k[0], k_blk, c, sk);
  load_tile_rows(s_v[0], v_blk, c, sk);
  cp_async_commit();

  // Q fragments straight from global memory; rows past Sq read as zeros
  const int row0 = q_tile * kBlockM + warp * 16;
  const __nv_bfloat16* q0 = q + (static_cast<size_t>(batch) * sq + row0 + g) * c +
                            head * kHeadDim + t * 2;
  const __nv_bfloat16* q8 = q0 + static_cast<size_t>(8) * c;
  const bool r0_ok = row0 + g < sq, r8_ok = row0 + g + 8 < sq;
  uint32_t q_frag[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    q_frag[kk][0] = r0_ok ? ld_u32(q0 + kk * 16) : 0u;
    q_frag[kk][1] = r8_ok ? ld_u32(q8 + kk * 16) : 0u;
    q_frag[kk][2] = r0_ok ? ld_u32(q0 + kk * 16 + 8) : 0u;
    q_frag[kk][3] = r8_ok ? ld_u32(q8 + kk * 16 + 8) : 0u;
  }
  float acc[8][4];
  zero_acc(acc);
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  const int n_tiles = (sk + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      const int kv0 = (j + 1) * kBlockN;
      const size_t off = static_cast<size_t>(kv0) * c;
      load_tile_rows(s_k[cur ^ 1], k_blk + off, c, sk - kv0);
      load_tile_rows(s_v[cur ^ 1], v_blk + off, c, sk - kv0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4];
    zero_acc(s);
    mma_a_yt(s, q_frag, s_k[cur], lane);

    const int kv0 = j * kBlockN;
    if (kv0 + kBlockN > sk) {  // the ragged last tile: mask keys >= Sk
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key = kv0 + nt * 8 + 2 * t;
        if (key >= sk) s[nt][0] = s[nt][2] = kMasked;
        if (key + 1 >= sk) s[nt][1] = s[nt][3] = kMasked;
      }
    }

    // online softmax in base 2, as in packed_attention.cu
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
    mma_c_y(acc, s, s_v[cur], lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 2);
  }
  // store rows g and g + 8 of this warp's 16, skipping rows past Sq
  __nv_bfloat16* o0 = o + (static_cast<size_t>(batch) * sq + row0 + g) * c + head * kHeadDim +
                      t * 2;
  __nv_bfloat16* o8 = o0 + static_cast<size_t>(8) * c;
  const float inv0 = 1.f / row_sum[0], inv8 = 1.f / row_sum[1];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    if (r0_ok)
      *reinterpret_cast<uint32_t*>(o0 + dt * 8) = pack_bf16x2(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r8_ok)
      *reinterpret_cast<uint32_t*>(o8 + dt * 8) = pack_bf16x2(acc[dt][2] * inv8, acc[dt][3] * inv8);
  }
}

}  // namespace

extern "C" {

// softmax(Q_h K_h^T / 8) V_h for every head h of (B, S, heads, 64) bf16
// tensors, Sq and Sk >= 1. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                        int sk, int heads, void* stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, heads, batch);
  const float scale_log2 = kLog2e / 8.0f;  // log2(e) / sqrt(64)
  flash_attention_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk,
      heads * kHeadDim, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
