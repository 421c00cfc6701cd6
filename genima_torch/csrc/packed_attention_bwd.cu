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
// L is (B, Sq, heads) f32.
//
// Bound: 10 * S^2 * C flops (the TPU kernel's cost estimate: S, dP, dV, dQ,
// dK) over ~16 * S * C bytes, so tensor-core operations bound it.
//
// Design: two kernels, no atomics, so two calls give the same bits (the
// price: S and dP are formed in both, 14 * S^2 * C flops). Each is
// warp-specialised: a producer warpgroup, whose first thread keeps a
// 4-stage ring of 64-row tiles full with TMA behind "full" / "empty"
// mbarriers, and two consumer warpgroups of 64 rows that run wgmma
// m64n64k16 with A from registers and B from the ring's 128-byte-swizzled
// tiles; setmaxnreg moves registers from the producer (24) to the
// consumers (240). Each stage is read K-major by one product and MN-major
// by another (attention_hopper.cuh).
//   * dq kernel, one block per (128 query rows, head, batch): Q and dO in
//     registers. Its prologue computes Drow = rowsum(dO * O) and L * log2(e)
//     for its rows and writes both, (B, heads, Sq) contiguous, into the
//     `delta` scratch for the second kernel. Per 64-key tile of K and V:
//     S = Q K^T and dP = dO V^T (K, V K-major), P and dS in registers,
//     dQ += bf16(dS) K (K MN-major).
//   * dk/dv kernel, one block per (128 keys, head, batch): K and V in
//     registers, dK and dV accumulated in f32. Per 64-query tile of Q and
//     dO (plus that tile's 64 values of L * log2(e) and Drow, bulk-copied
//     from the scratch: as (B, Sq, heads) they lie heads * 4 bytes apart,
//     which no TMA box can take): S^T = K Q^T and dP^T = V dO^T (Q, dO
//     K-major), P^T and dS^T in registers, already in the A layout of
//     dV += bf16(P^T) dO and dK += bf16(dS^T) Q (Q, dO MN-major).
//   In both, S is waited for before dP, so the exponentials run while dP
//   finishes; the dk/dv kernel issues dV += P^T dO as soon as P^T is in
//   registers, so that group runs under the dS math. A stage goes back to
//   the producer once the groups reading it have been retired. Sq or Sk an
//   odd multiple of 64 leaves the last block's second warpgroup without
//   rows: it takes no part.

#include "attention_hopper.cuh"

namespace {

using namespace hopper;
using namespace attn_hopper;

constexpr int kNWG = 2;                       // consumer warpgroups a block
constexpr int kThreads = 128 * kNWG + 128;    // + the producer warpgroup
constexpr int kBlockRows = 64 * kNWG;
constexpr int kTileBytes = 64 * kRowBytes;    // a 64-row tile
constexpr int kStages = 4;
constexpr int kRing = kStages * 2 * kTileBytes;
constexpr int kDqSmem = 1024 + kRing + 16 * kStages;
constexpr int kDkdvSmem = 1024 + kRing + kStages * 2 * 64 * 4 + 16 * kStages;

struct Params {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;  // (B, Sq, heads)
  float* l2;         // (B, heads, Sq): L * log2(e), written by the dq kernel
  float* drow;       // (B, heads, Sq): rowsum(dO * O), written by the dq kernel
  __nv_bfloat16 *dq, *dk, *dv;
  int sq, sk, c, heads;
  float scale_log2, scale;
};

__global__ void __launch_bounds__(kThreads, 1)
packed_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing);
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kBlockRows;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int active = min(kNWG, (p.sq - q0) / 64);
  const int n_tiles = p.sk / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], active);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= 4 * kNWG) {  // producer warpgroup: K and V tiles
    setmaxnreg_dec<24>();
    if (warp == 4 * kNWG && lane == 0) {
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * 2 * kTileBytes;
        mbar_expect_tx(&full[stage], 2 * kTileBytes);
        tma_load_3d(st, &map_k, &full[stage], head * kHeadDim, j * 64, batch);
        tma_load_3d(st + kTileBytes, &map_v, &full[stage], head * kHeadDim, j * 64, batch);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  if (wg >= active) return;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int row0 = q0 + wg * 64 + wq * 16;  // this warp's first query row
  const size_t rows_off = (static_cast<size_t>(batch) * p.sq + row0) * p.c + head * kHeadDim;
  uint32_t qf[4][4], dof[4][4];
  load_a_global(qf, p.q + rows_off, p.c, g, t);
  load_a_global(dof, p.dout + rows_off, p.c, g, t);

  // Prologue: Drow and L * log2(e) for rows g and g + 8 (f32 products of
  // the bf16 values, summed as the TPU wrapper sums them), kept in
  // registers and written for the dk/dv kernel.
  float drow[2] = {0.f, 0.f}, l2[2];
  {
    uint32_t of[4][4];
    load_a_global(of, p.o + rows_off, p.c, g, t);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = unpack_bf16x2(dof[kk][i]);
        const float2 b = unpack_bf16x2(of[kk][i]);
        drow[i & 1] += a.x * b.x + a.y * b.y;  // regs 0, 2: row g; 1, 3: row g + 8
      }
    }
  }
  const size_t lrow = (static_cast<size_t>(batch) * p.sq + row0 + g) * p.heads + head;
  const size_t srow = (static_cast<size_t>(batch) * p.heads + head) * p.sq + row0 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    drow[r] += __shfl_xor_sync(0xffffffff, drow[r], 1);
    drow[r] += __shfl_xor_sync(0xffffffff, drow[r], 2);
    l2[r] = p.lse[lrow + static_cast<size_t>(8 * r) * p.heads] * kLog2e;
    if (t == 0) {
      p.l2[srow + 8 * r] = l2[r];
      p.drow[srow + 8 * r] = drow[r];
    }
  }

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  uint32_t dsf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) dsf[kk][0] = dsf[kk][1] = dsf[kk][2] = dsf[kk][3] = 0u;
  fence_operands(dq);

  int stage = 0;
  uint32_t phase = 0;
  int prev = -1;  // the stage the dQ group in flight reads
  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(&full[stage], phase);
    const uint8_t* ks = ring + stage * 2 * kTileBytes;
    const uint8_t* vs = ks + kTileBytes;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<64, 0>(s, qf[kk], desc_k(ks, kk));  // S = Q K^T
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<64, 0>(dp, dof[kk], desc_k(vs, kk));  // dP = dO V^T
    wgmma_commit();
    fence_operands(s);
    fence_operands(dp);
    wgmma_wait<1>();  // S, and the previous tile's dQ group
    fence_operands(s);
    fence_frags(dsf);
    if (prev >= 0 && wq == 0 && lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = exp2_approx(fmaf(s[i], p.scale_log2, -l2[(i >> 1) & 1]));
    wgmma_wait<0>();
    fence_operands(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - drow[(i >> 1) & 1]) * p.scale;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(dsf[kk], dp, kk);
    fence_frags(dsf);
    fence_operands(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<64, 1>(dq, dsf[kk], desc_mn(ks, kk));  // dQ += dS K
    wgmma_commit();
    fence_operands(dq);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(dq);
  fence_frags(dsf);
  store_acc(p.dq + rows_off, p.c, dq, 1.f, 1.f, true, true, g, t);
}

__global__ void __launch_bounds__(kThreads, 1)
packed_attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_do, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* rows_ring = reinterpret_cast<float*>(ring + kRing);  // [stage][L2 | Drow][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_ring + kStages * 2 * 64);
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kBlockRows;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int active = min(kNWG, (p.sk - k0) / 64);
  const int n_tiles = p.sq / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], active);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= 4 * kNWG) {  // producer warpgroup: Q, dO, L * log2(e), Drow tiles
    setmaxnreg_dec<24>();
    if (warp == 4 * kNWG && lane == 0) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_do);
      const size_t bh = (static_cast<size_t>(batch) * p.heads + head) * p.sq;
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * 2 * kTileBytes;
        float* rs = rows_ring + stage * 2 * 64;
        mbar_expect_tx(&full[stage], 2 * kTileBytes + 2 * 64 * 4);
        tma_load_3d(st, &map_q, &full[stage], head * kHeadDim, i * 64, batch);
        tma_load_3d(st + kTileBytes, &map_do, &full[stage], head * kHeadDim, i * 64, batch);
        bulk_load(rs, p.l2 + bh + i * 64, 64 * 4, &full[stage]);
        bulk_load(rs + 64, p.drow + bh + i * 64, 64 * 4, &full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  if (wg >= active) return;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t keys_off =
      (static_cast<size_t>(batch) * p.sk + k0 + wg * 64 + wq * 16) * p.c + head * kHeadDim;
  uint32_t kf[4][4], vf[4][4];
  load_a_global(kf, p.k + keys_off, p.c, g, t);
  load_a_global(vf, p.v + keys_off, p.c, g, t);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pf[4][4], dsf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pf[kk][r] = dsf[kk][r] = 0u;
  fence_operands(dk);
  fence_operands(dv);

  int stage = 0;
  uint32_t phase = 0;
  int prev = -1;  // the stage the dV/dK group in flight reads
  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(&full[stage], phase);
    const uint8_t* qs = ring + stage * 2 * kTileBytes;
    const uint8_t* dos = qs + kTileBytes;
    const float* rs = rows_ring + stage * 2 * 64;
    // transposed scores: rows are this warp's keys g, g + 8; accumulator
    // value e of column group j is query 8j + 2t + (e & 1) of the tile
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<64, 0>(s, kf[kk], desc_k(qs, kk));  // S^T = K Q^T
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<64, 0>(dp, vf[kk], desc_k(dos, kk));  // dP^T = V dO^T
    wgmma_commit();
    fence_operands(s);
    fence_operands(dp);
    wgmma_wait<1>();  // S^T, and the previous tile's dV and dK groups
    fence_operands(s);
    fence_frags(pf);
    fence_frags(dsf);
    if (prev >= 0 && wq == 0 && lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(rs + 8 * j + 2 * t);
      s[4 * j] = exp2_approx(fmaf(s[4 * j], p.scale_log2, -l.x));
      s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], p.scale_log2, -l.y));
      s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], p.scale_log2, -l.x));
      s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], p.scale_log2, -l.y));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pf[kk], s, kk);
    fence_frags(pf);
    fence_operands(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<64, 1>(dv, pf[kk], desc_mn(dos, kk));  // dV += P^T dO
    wgmma_commit();
    fence_operands(dv);
    wgmma_wait<1>();  // dP^T; the dV group runs on under the dS math
    fence_operands(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(rs + 64 + 8 * j + 2 * t);
      dp[4 * j] = s[4 * j] * (dp[4 * j] - d.x) * p.scale;
      dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d.y) * p.scale;
      dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d.x) * p.scale;
      dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d.y) * p.scale;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(dsf[kk], dp, kk);
    fence_frags(dsf);
    fence_operands(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<64, 1>(dk, dsf[kk], desc_mn(qs, kk));  // dK += dS^T Q
    wgmma_commit();
    fence_operands(dk);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(dk);
  fence_operands(dv);
  fence_frags(pf);
  fence_frags(dsf);
  store_acc(p.dk + keys_off, p.c, dk, 1.f, 1.f, true, true, g, t);
  store_acc(p.dv + keys_off, p.c, dv, 1.f, 1.f, true, true, g, t);
}

// A (C, S, B) map of a packed (B, S, C) bf16 tensor with a (64, 64, 1) box.
int seq_map(CUtensorMap* map, const void* x, int batch, int s, int c) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * 2,
                                 static_cast<cuuint64_t>(s) * c * 2};
  const cuuint32_t box[3] = {kHeadDim, 64, 1};
  return hopper_host::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

extern "C" {

// dq, dk, dv of packed (B, S, heads * 64) bf16 attention, from the forward's
// o and (B, Sq, heads) f32 lse and the output gradient dout; Sq and Sk
// multiples of 64. `delta` is a (2, B, heads, Sq) f32 scratch the first
// kernel fills with L * log2(e) and rowsum(dO * O) for the second. Needs
// 16-byte aligned tensors (the wrapper checks). Launches both kernels on
// `stream`, does not synchronise, and returns 0 or the first error code for
// packed_attention_bwd_error_string.
int packed_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* lse, const void* dout, void* delta, void* dq, void* dk,
                         void* dv, int batch, int sq, int sk, int heads, void* stream) {
  if (sq < 64 || sk < 64 || sq % 64 || sk % 64) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int c = heads * kHeadDim;
  CUtensorMap mq, mk, mv, mdo;
  int rc;
  if ((rc = seq_map(&mq, q, batch, sq, c))) return rc;
  if ((rc = seq_map(&mk, k, batch, sk, c))) return rc;
  if ((rc = seq_map(&mv, v, batch, sk, c))) return rc;
  if ((rc = seq_map(&mdo, dout, batch, sq, c))) return rc;
  const auto bf = [](const void* x) { return static_cast<const __nv_bfloat16*>(x); };
  Params p;
  p.q = bf(q);
  p.k = bf(k);
  p.v = bf(v);
  p.o = bf(o);
  p.dout = bf(dout);
  p.lse = static_cast<const float*>(lse);
  p.l2 = static_cast<float*>(delta);
  p.drow = p.l2 + static_cast<size_t>(batch) * heads * sq;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.sq = sq;
  p.sk = sk;
  p.c = c;
  p.heads = heads;
  p.scale = 0.125f;  // 1 / sqrt(64)
  p.scale_log2 = kLog2e * p.scale;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(packed_attention_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(packed_attention_bwd_dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  packed_attention_bwd_dq_kernel<<<dim3((sq + kBlockRows - 1) / kBlockRows, heads, batch),
                                   kThreads, kDqSmem, st>>>(mk, mv, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_attention_bwd_dkdv_kernel<<<dim3((sk + kBlockRows - 1) / kBlockRows, heads, batch),
                                     kThreads, kDkdvSmem, st>>>(mq, mdo, p);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory each of the two kernels asks for.
int packed_attention_bwd_smem_bytes(int dkdv) { return dkdv ? kDkdvSmem : kDqSmem; }

const char* packed_attention_bwd_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
