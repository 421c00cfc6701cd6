// Packed-layout flash-attention backward for Hopper (sm_90a).
//
// Replaces genima_tpu/kernels/packed_attention.py::_flash_backward /
// _bwd_kernel: dq, dk and dv of softmax(Q_h K_h^T / sqrt(d)) V_h from q, k,
// v, o, dO and the forward's L = m + log(l) (packed_attention_fwd_lse), with
// the TPU kernel's arithmetic:
//   P  = exp(S / sqrt(d) - L), rounded to bf16 before P^T dO;
//   dP = dO V^T;  Drow = rowsum(dO * O);
//   dS = P (dP - Drow) / sqrt(d), rounded to bf16;
//   dQ = dS K accumulated in f32 over key tiles; dK = dS^T Q; dV = P^T dO.
//
// Layout: every tensor is packed (B, S, heads * d) bf16, read at column
// offset h * d with row stride C, as the forward reads it; d a multiple of 8
// up to 256 (the wrapper zero-pads any other head dim up to 256 to the next
// multiple of 8 and passes the real one as scale_dim), Sq and Sk any
// multiples of 64. The TPU wrapper transposes to (B * heads, S, d) around
// its kernel; the packed kernel exists to avoid those transposes, so this
// one reads head-strided instead. L is (B, Sq, heads) f32.
//
// Bound: 10 * S^2 * C flops (the TPU kernel's cost estimate: S, dP, dV, dQ,
// dK) over ~16 * S * C bytes, so tensor-core operations bound it.
//
// Design: two kernels, no atomics, so two calls give the same bits (the
// price: S and dP are formed in both, 14 * S^2 * C flops). Each is
// warp-specialised: a producer warpgroup, whose first thread keeps a ring of
// 64-row tiles full with TMA behind "full" / "empty" mbarriers, and two
// consumer warpgroups of 64 rows that run wgmma m64n64k16 with B from the
// ring's 128-byte-swizzled tiles; setmaxnreg moves registers from the
// producer (24) to the consumers (240). Each stage is read K-major by one
// product and MN-major by another (attention_hopper.cuh). At four atoms a
// block is one consumer warpgroup and a one-warp producer (below).
//   * dq kernel, one block per (128 query rows, head, batch): Q and dO
//     resident. Its prologue computes Drow = rowsum(dO * O) over the real d
//     columns and L * log2(e) for its rows and writes both, (B, heads, Sq)
//     contiguous, into the `delta` scratch for the second kernel. Per
//     64-key tile of K and V: S = Q K^T and dP = dO V^T (K, V K-major), P
//     and dS in registers, dQ += bf16(dS) K (K MN-major).
//   * dk/dv kernel, one block per (128 keys, head, batch): K and V
//     resident, dK and dV accumulated in f32. Per 64-query tile of Q and dO
//     (plus that tile's 64 values of L * log2(e) and Drow, bulk-copied from
//     the scratch: as (B, Sq, heads) they lie heads * 4 bytes apart, which
//     no TMA box can take): S^T = K Q^T and dP^T = V dO^T (Q, dO K-major),
//     P^T and dS^T in registers, already in the A layout of
//     dV += bf16(P^T) dO and dK += bf16(dS^T) Q (Q, dO MN-major).
//   In both, S is waited for before dP, so the exponentials run while dP
//   finishes; the dk/dv kernel issues dV += P^T dO as soon as P^T is in
//   registers, so that group runs under the dS math. A stage goes back to
//   the producer once the groups reading it have been retired. Sq or Sk an
//   odd multiple of 64 leaves the last block's second warpgroup without
//   rows: it takes no part.
//
// Head dims, as DA = ceil(d / 64) atoms of 64 columns (attention_hopper.cuh):
//   * d <= 64 (DA = 1): the resident tensors are A fragments in registers,
//     loaded from global memory with the columns past d zeroed, 4-stage ring.
//   * d = 72..256 (DA = 2, 3, 4): a warpgroup's f32 accumulators alone
//     would take 32 * DA registers a thread each, so the resident tensors
//     move to shared memory (a TMA load a block, wgmma with both operands in
//     shared memory, their columns past d zeroed there once), and the dk/dv
//     kernel makes two passes over the query tiles, dV in the first and dK
//     in the second, holding one accumulator at a time (S^T is formed twice:
//     16 * S^2 * C flops in all). DA = 3 and 4 ring 2 stages, DA = 2 four.
//   * DA = 4: two resident tensors of 128 rows (128 KB) and a 2-stage ring
//     of 64-row Q/dO or K/V pairs (128 KB) would pass the 227 KB a block
//     may take, and the dq kernel's dQ (128 f32 a thread), S and dP alone
//     come to ~210 registers. So a block is one consumer warpgroup of 64
//     rows and a one-warp producer: 160 threads, which ptxas may give 255
//     registers each with no setmaxnreg; the resident tensors are 64 rows
//     (64 KB), the ring 2 x 64 KB.
//   Every contraction over d sees zeros past d (Q or dO, K or V), and dQ,
//   dK and dV store their real d columns only.
//
// On f32 tensors it is attention_f32.cuh's backward instead (FFMA on the
// CUDA cores, its note says why): the same two kernels and the same
// arithmetic with P and dS kept in f32, dq, dk and dv in f32, as the TPU
// kernel writes them in q's dtype.

#include "attention_f32.cuh"
#include "attention_hopper.cuh"

namespace {

using namespace hopper;
using namespace attn_hopper;

constexpr int kAtomTile = 64 * kRowBytes;     // 64 rows x one 64-column atom

template <int DA>
struct BwdCfg {
  static_assert(DA >= 1 && DA <= 4, "heads of up to 256 columns");
  static constexpr int kNWG = DA == 4 ? 1 : 2;  // consumer warpgroups a block
  // + the producer: a warpgroup where setmaxnreg moves registers, else a warp
  static constexpr int kThreads = 128 * kNWG + (kNWG == 1 ? 32 : 128);
  static constexpr int kBlockRows = 64 * kNWG;
  static constexpr bool kRegA = DA == 1;      // resident tensors in registers
  static constexpr bool kSplit = DA > 1;      // dV, then dK, in two passes
  static constexpr int kStages = DA >= 3 ? 2 : 4;
  static constexpr int kTile = DA * kAtomTile;  // a 64-row tile, all atoms
  static constexpr int kRing = kStages * 2 * kTile;
  // two resident tensors of kBlockRows rows, and their barrier
  static constexpr int kRes = kRegA ? 0 : 2 * kNWG * kTile;
  static constexpr int kResBar = kRegA ? 0 : 16;
  static constexpr int kDqSmem = 1024 + kRes + kRing + 16 * kStages + kResBar;
  static constexpr int kDkdvSmem = kDqSmem + kStages * 2 * 64 * 4;
};

struct Params {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;  // (B, Sq, heads)
  float* l2;         // (B, heads, Sq): L * log2(e), written by the dq kernel
  float* drow;       // (B, heads, Sq): rowsum(dO * O), written by the dq kernel
  __nv_bfloat16 *dq, *dk, *dv;
  int sq, sk, c, d, heads;
  float scale_log2, scale;
};

// acc (64 rows of this warpgroup x 64) += X Y^T over DA atoms, X this
// warpgroup's 64 resident rows (fragments `f` when DA is 1, else the
// shared-memory tile `x`, atoms kAtomTile apart) and Y the ring tile `y`.
template <int DA>
__device__ __forceinline__ void mma_rows_t(float* acc, const uint32_t (&f)[4][4],
                                           const uint8_t* x, const uint8_t* y) {
  if constexpr (DA == 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<64, 0>(acc, f[kk], desc_k(y, kk));
  } else {
#pragma unroll
    for (int a = 0; a < DA; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64, 0>(acc, desc_k(x + a * kAtomTile, kk), desc_k(y + a * kAtomTile, kk));
  }
}

// acc (64 x 64 * DA) += A Y over the 64 rows of the ring tile `y` (MN-major),
// A given as the four bf16 A fragments `af`.
template <int DA>
__device__ __forceinline__ void mma_acc(float* acc, const uint32_t (&af)[4][4], const uint8_t* y) {
#pragma unroll
  for (int a = 0; a < DA; ++a)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64, 1>(acc + 32 * a, af[kk], desc_mn(y + a * kAtomTile, kk));
}

// Resident tiles (DA > 1): wait for the block's TMA load, then zero this
// warpgroup's columns past d of `n` tensors kNWG * kTile apart.
template <int DA>
__device__ __forceinline__ void resident_ready(uint64_t* res_full, uint8_t* tile, int n, int d,
                                               int wg) {
  mbar_wait(res_full, 0);
  const int tail = d - (DA - 1) * kAtom;
  if (tail < kAtom) {
    for (int i = 0; i < n; ++i)
      zero_tail(tile + i * BwdCfg<DA>::kNWG * BwdCfg<DA>::kTile + (DA - 1) * kAtomTile, 64,
                tail, threadIdx.x & 127, 128);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }
}

// The producer's loads of two resident tensors (maps m0, m1) for the
// block's `active` warpgroups of 64 rows from row r0.
template <int DA>
__device__ __forceinline__ void load_resident(uint8_t* res, uint64_t* res_full,
                                              const CUtensorMap* m0, const CUtensorMap* m1,
                                              int col, int r0, int batch, int active) {
  constexpr int kTile = BwdCfg<DA>::kTile;
  constexpr int kNWG = BwdCfg<DA>::kNWG;
  mbar_expect_tx(res_full, 2 * active * kTile);
  for (int w = 0; w < active; ++w)
#pragma unroll
    for (int a = 0; a < DA; ++a) {
      tma_load_3d(res + w * kTile + a * kAtomTile, m0, res_full, col + a * kAtom, r0 + 64 * w,
                  batch);
      tma_load_3d(res + (kNWG + w) * kTile + a * kAtomTile, m1, res_full, col + a * kAtom,
                  r0 + 64 * w, batch);
    }
}

template <int DA>
__global__ void __launch_bounds__(BwdCfg<DA>::kThreads, 1)
packed_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_do,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v, const Params p) {
  using C = BwdCfg<DA>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* res = align1024(smem_raw);  // Q then dO, 128 rows each (DA > 1)
  uint8_t* ring = res + C::kRes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kRing);
  uint64_t* empty = full + C::kStages;
  uint64_t* res_full = empty + C::kStages;

  constexpr int kNWG = C::kNWG;
  const int q0 = blockIdx.x * C::kBlockRows;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int active = min(kNWG, (p.sq - q0) / 64);
  const int n_tiles = p.sk / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], active);
    }
    if constexpr (!C::kRegA) mbar_init(res_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= 4 * kNWG) {  // producer warpgroup: K and V tiles
    if constexpr (kNWG >= 2) setmaxnreg_dec<24>();
    if (warp == 4 * kNWG && lane == 0) {
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      const int col = head * p.d;
      if constexpr (!C::kRegA)
        load_resident<DA>(res, res_full, &map_q, &map_do, col, q0, batch, active);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * 2 * C::kTile;
        mbar_expect_tx(&full[stage], 2 * C::kTile);
#pragma unroll
        for (int a = 0; a < DA; ++a) {
          tma_load_3d(st + a * kAtomTile, &map_k, &full[stage], col + a * kAtom, j * 64, batch);
          tma_load_3d(st + C::kTile + a * kAtomTile, &map_v, &full[stage], col + a * kAtom,
                      j * 64, batch);
        }
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if constexpr (kNWG >= 2) setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  if (wg >= active) return;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int row0 = q0 + wg * 64 + wq * 16;  // this warp's first query row
  const size_t rows_off = (static_cast<size_t>(batch) * p.sq + row0) * p.c + head * p.d;
  uint32_t qf[4][4], dof[4][4];
  const uint8_t* q_res = res + wg * C::kTile;
  const uint8_t* do_res = res + (kNWG + wg) * C::kTile;
  if constexpr (C::kRegA) {
    load_a_global(qf, p.q + rows_off, p.c, g, t, p.d);
    load_a_global(dof, p.dout + rows_off, p.c, g, t, p.d);
  } else {
    resident_ready<DA>(res_full, res + wg * C::kTile, 2, p.d, wg);
  }

  // Prologue: Drow and L * log2(e) for rows g and g + 8 (f32 products of
  // the bf16 values over the real d columns, summed as the TPU wrapper sums
  // them), kept in registers and written for the dk/dv kernel.
  float drow[2] = {0.f, 0.f}, l2[2];
  if constexpr (C::kRegA) {  // dO's fragments are in registers: O's alongside
    uint32_t of[4][4];
    load_a_global(of, p.o + rows_off, p.c, g, t, p.d);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack_bf16x2(dof[kk][i]);
        const float2 y = unpack_bf16x2(of[kk][i]);
        drow[i & 1] += x.x * y.x + x.y * y.y;  // regs 0, 2: row g; 1, 3: row g + 8
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < DA; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int col = a * kAtom + kk * 16 + hi * 8 + 2 * t;
          if (col >= p.d) continue;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const size_t off = rows_off + static_cast<size_t>(g + 8 * r) * p.c + col;
            const float2 x = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p.dout + off));
            const float2 y = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p.o + off));
            drow[r] += x.x * y.x + x.y * y.y;
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

  float dq[32 * DA];
#pragma unroll
  for (int i = 0; i < 32 * DA; ++i) dq[i] = 0.f;
  uint32_t dsf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) dsf[kk][0] = dsf[kk][1] = dsf[kk][2] = dsf[kk][3] = 0u;
  fence_operands(dq);

  int stage = 0;
  uint32_t phase = 0;
  int prev = -1;  // the stage the dQ group in flight reads
  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(&full[stage], phase);
    const uint8_t* ks = ring + stage * 2 * C::kTile;
    const uint8_t* vs = ks + C::kTile;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
    mma_rows_t<DA>(s, qf, q_res, ks);  // S = Q K^T
    wgmma_commit();
    mma_rows_t<DA>(dp, dof, do_res, vs);  // dP = dO V^T
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
    mma_acc<DA>(dq, dsf, ks);  // dQ += dS K
    wgmma_commit();
    fence_operands(dq);
    prev = stage;
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(dq);
  fence_frags(dsf);
#pragma unroll
  for (int a = 0; a < DA; ++a)
    store_acc(p.dq + rows_off + a * kAtom, p.c, dq + 32 * a, 1.f, 1.f, true, true, g, t,
              p.d - a * kAtom);
}

// One pass of the dk/dv kernel's consumers over the n_tiles query tiles of
// the ring: dV += P^T dO (kDV) and / or dK += dS^T Q (kDK), into the
// accumulators dv and dk (64 keys x 64 * DA, f32). The ring position
// (stage, phase) carries over to the next pass; a pass of two hands its
// last stage back once its groups have been retired.
template <int DA, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_pass(float* dv, float* dk, const uint32_t (&kf)[4][4],
                                          const uint32_t (&vf)[4][4], const uint8_t* k_res,
                                          const uint8_t* v_res, const uint8_t* ring,
                                          const float* rows_ring, uint64_t* full,
                                          uint64_t* empty, int n_tiles, const Params& p,
                                          bool arrives, int t, int& stage, uint32_t& phase) {
  using C = BwdCfg<DA>;
  uint32_t pf[4][4], dsf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pf[kk][r] = dsf[kk][r] = 0u;
  int prev = -1;  // the stage the dV/dK group in flight reads
  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(&full[stage], phase);
    const uint8_t* qs = ring + stage * 2 * C::kTile;
    const uint8_t* dos = qs + C::kTile;
    const float* rs = rows_ring + stage * 2 * 64;
    // transposed scores: rows are this warp's keys g, g + 8; accumulator
    // value e of column group j is query 8j + 2t + (e & 1) of the tile
    float s[32], dp[kDK ? 32 : 1];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    fence_operands(s);
    if constexpr (kDK) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dp[e] = 0.f;
      fence_operands(dp);
    }
    wgmma_fence();
    mma_rows_t<DA>(s, kf, k_res, qs);  // S^T = K Q^T
    wgmma_commit();
    if constexpr (kDK) {
      mma_rows_t<DA>(dp, vf, v_res, dos);  // dP^T = V dO^T
      wgmma_commit();
      fence_operands(dp);
    }
    fence_operands(s);
    // S^T, and the previous tile's dV and dK groups
    if constexpr (kDK) wgmma_wait<1>(); else wgmma_wait<0>();
    fence_operands(s);
    fence_frags(pf);
    fence_frags(dsf);
    if (prev >= 0 && arrives) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(rs + 8 * j + 2 * t);
      s[4 * j] = exp2_approx(fmaf(s[4 * j], p.scale_log2, -l.x));
      s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], p.scale_log2, -l.y));
      s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], p.scale_log2, -l.x));
      s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], p.scale_log2, -l.y));
    }
    if constexpr (kDV) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(pf[kk], s, kk);
      fence_frags(pf);
      fence_acc<32 * DA>(dv);
      wgmma_fence();
      mma_acc<DA>(dv, pf, dos);  // dV += P^T dO
      wgmma_commit();
      fence_acc<32 * DA>(dv);
    }
    if constexpr (kDK) {
      // dP^T; the dV group runs on under the dS math
      if constexpr (kDV) wgmma_wait<1>(); else wgmma_wait<0>();
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
      fence_acc<32 * DA>(dk);
      wgmma_fence();
      mma_acc<DA>(dk, dsf, qs);  // dK += dS^T Q
      wgmma_commit();
      fence_acc<32 * DA>(dk);
    }
    prev = stage;
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  if constexpr (kDV) fence_acc<32 * DA>(dv);
  if constexpr (kDK) fence_acc<32 * DA>(dk);
  fence_frags(pf);
  fence_frags(dsf);
  if constexpr (!(kDV && kDK))
    if (prev >= 0 && arrives) mbar_arrive(&empty[prev]);
}

template <int DA>
__global__ void __launch_bounds__(BwdCfg<DA>::kThreads, 1)
packed_attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_do,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v, const Params p) {
  using C = BwdCfg<DA>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* res = align1024(smem_raw);  // K then V, 128 keys each (DA > 1)
  uint8_t* ring = res + C::kRes;
  float* rows_ring = reinterpret_cast<float*>(ring + C::kRing);  // [stage][L2 | Drow][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_ring + C::kStages * 2 * 64);
  uint64_t* empty = full + C::kStages;
  uint64_t* res_full = empty + C::kStages;

  constexpr int kNWG = C::kNWG;
  const int k0 = blockIdx.x * C::kBlockRows;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int active = min(kNWG, (p.sk - k0) / 64);
  const int n_tiles = p.sq / 64;
  constexpr int kPasses = C::kSplit ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], active);
    }
    if constexpr (!C::kRegA) mbar_init(res_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= 4 * kNWG) {  // producer warpgroup: Q, dO, L * log2(e), Drow tiles
    if constexpr (kNWG >= 2) setmaxnreg_dec<24>();
    if (warp == 4 * kNWG && lane == 0) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_do);
      const int col = head * p.d;
      if constexpr (!C::kRegA)
        load_resident<DA>(res, res_full, &map_k, &map_v, col, k0, batch, active);
      const size_t bh = (static_cast<size_t>(batch) * p.heads + head) * p.sq;
      int stage = 0;
      uint32_t phase = 0;
      for (int n = 0; n < kPasses * n_tiles; ++n) {
        const int i = n % n_tiles;
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * 2 * C::kTile;
        float* rs = rows_ring + stage * 2 * 64;
        mbar_expect_tx(&full[stage], 2 * C::kTile + 2 * 64 * 4);
#pragma unroll
        for (int a = 0; a < DA; ++a) {
          tma_load_3d(st + a * kAtomTile, &map_q, &full[stage], col + a * kAtom, i * 64, batch);
          tma_load_3d(st + C::kTile + a * kAtomTile, &map_do, &full[stage], col + a * kAtom,
                      i * 64, batch);
        }
        bulk_load(rs, p.l2 + bh + i * 64, 64 * 4, &full[stage]);
        bulk_load(rs + 64, p.drow + bh + i * 64, 64 * 4, &full[stage]);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if constexpr (kNWG >= 2) setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  if (wg >= active) return;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool arrives = wq == 0 && lane == 0;

  const size_t keys_off =
      (static_cast<size_t>(batch) * p.sk + k0 + wg * 64 + wq * 16) * p.c + head * p.d;
  uint32_t kf[4][4], vf[4][4];
  const uint8_t* k_res = res + wg * C::kTile;
  const uint8_t* v_res = res + (kNWG + wg) * C::kTile;
  if constexpr (C::kRegA) {
    load_a_global(kf, p.k + keys_off, p.c, g, t, p.d);
    load_a_global(vf, p.v + keys_off, p.c, g, t, p.d);
  } else {
    resident_ready<DA>(res_full, res + wg * C::kTile, 2, p.d, wg);
  }

  int stage = 0;
  uint32_t phase = 0;
  if constexpr (C::kSplit) {
    {
      float dv[32 * DA];
#pragma unroll
      for (int i = 0; i < 32 * DA; ++i) dv[i] = 0.f;
      fence_operands(dv);
      dkdv_pass<DA, true, false>(dv, nullptr, kf, vf, k_res, v_res, ring, rows_ring, full, empty,
                                 n_tiles, p, arrives, t, stage, phase);
#pragma unroll
      for (int a = 0; a < DA; ++a)
        store_acc(p.dv + keys_off + a * kAtom, p.c, dv + 32 * a, 1.f, 1.f, true, true, g, t,
                  p.d - a * kAtom);
    }
    float dk[32 * DA];
#pragma unroll
    for (int i = 0; i < 32 * DA; ++i) dk[i] = 0.f;
    fence_operands(dk);
    dkdv_pass<DA, false, true>(nullptr, dk, kf, vf, k_res, v_res, ring, rows_ring, full, empty,
                               n_tiles, p, arrives, t, stage, phase);
#pragma unroll
    for (int a = 0; a < DA; ++a)
      store_acc(p.dk + keys_off + a * kAtom, p.c, dk + 32 * a, 1.f, 1.f, true, true, g, t,
                p.d - a * kAtom);
  } else {
    float dk[32 * DA], dv[32 * DA];
#pragma unroll
    for (int i = 0; i < 32 * DA; ++i) dk[i] = dv[i] = 0.f;
    fence_operands(dk);
    fence_operands(dv);
    dkdv_pass<DA, true, true>(dv, dk, kf, vf, k_res, v_res, ring, rows_ring, full, empty,
                              n_tiles, p, arrives, t, stage, phase);
#pragma unroll
    for (int a = 0; a < DA; ++a) {
      store_acc(p.dk + keys_off + a * kAtom, p.c, dk + 32 * a, 1.f, 1.f, true, true, g, t,
                p.d - a * kAtom);
      store_acc(p.dv + keys_off + a * kAtom, p.c, dv + 32 * a, 1.f, 1.f, true, true, g, t,
                p.d - a * kAtom);
    }
  }
}

// A (C, S, B) map of a packed (B, S, C) bf16 tensor with a (64, 64, 1) box.
int seq_map(CUtensorMap* map, const void* x, int batch, int s, int c) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * 2,
                                 static_cast<cuuint64_t>(s) * c * 2};
  const cuuint32_t box[3] = {kAtom, 64, 1};
  return hopper_host::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DA>
int launch_bwd(const CUtensorMap& mq, const CUtensorMap& mdo, const CUtensorMap& mk,
               const CUtensorMap& mv, const Params& p, int batch, cudaStream_t st) {
  using C = BwdCfg<DA>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(packed_attention_bwd_dq_kernel<DA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(packed_attention_bwd_dkdv_kernel<DA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDkdvSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  packed_attention_bwd_dq_kernel<DA>
      <<<dim3((p.sq + C::kBlockRows - 1) / C::kBlockRows, p.heads, batch), C::kThreads,
         C::kDqSmem, st>>>(mq, mdo, mk, mv, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_attention_bwd_dkdv_kernel<DA>
      <<<dim3((p.sk + C::kBlockRows - 1) / C::kBlockRows, p.heads, batch), C::kThreads,
         C::kDkdvSmem, st>>>(mq, mdo, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace attn_f32 {
namespace {

// Rows of the backward's blocks and tiles at DA atoms: four resident tiles
// of 64 rows x 257 floats do not fit 227 KB.
__host__ __device__ constexpr int bwd_rows(int da) { return da == 4 ? 32 : 64; }

// Dynamic shared memory of a backward block: four tiles (Q, dO, K, V), dS
// (and P^T in the dk/dv kernel), and a row's L * log2(e) and Drow.
int bwd_smem_bytes(int da, bool dkdv) {
  const int r = bwd_rows(da), ld = 64 * da + 1;
  return 4 * (4 * r * ld + (dkdv ? 2 : 1) * r * (r + 1) + 2 * r);
}

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* lse;   // (B, Sq, heads)
  const float* dout;
  float* drow;        // (B, heads, Sq): rowsum(dO * O), the dq kernel's for the dk/dv kernel
  float* dq;
  float* dk;
  float* dv;
  int sq, sk, c, d, heads;
  float scale, scale_log2;
};

// dq for a block of R query rows: Q and dO resident, K and V streamed in
// tiles of R keys; first Drow and L * log2(e) of the block's rows.
template <int DA>
__global__ void __launch_bounds__(kThreads, 1) attention_f32_dq_kernel(const BwdParams p) {
  constexpr int R = bwd_rows(DA), RN = R / 16, W = 64 * DA, LD = W + 1, LDP = R + 1;
  constexpr int NC = 4 * DA;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + R * LD;
  float* ks = dos + R * LD;
  float* vs = ks + R * LD;
  float* dss = vs + R * LD;
  float* lrow = dss + R * LDP;
  float* drow = lrow + R;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * R, head = blockIdx.y, b = blockIdx.z;
  const int col0 = head * p.d;
  load_tile<R, W, LD>(qs, p.q, b, q0, p.sq, p.c, col0, p.d);
  load_tile<R, W, LD>(dos, p.dout, b, q0, p.sq, p.c, col0, p.d);
  __syncthreads();
  {  // warp w: rows w, w + 8, ...
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < R; r += kThreads / 32) {
      const int row = q0 + r;
      float acc = 0.f;
      if (row < p.sq) {
        const float* orow = p.o + (static_cast<size_t>(b) * p.sq + row) * p.c + col0;
        for (int e = lane; e < p.d; e += 32) acc = fmaf(dos[r * LD + e], orow[e], acc);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        drow[r] = acc;
        lrow[r] = row < p.sq
                      ? p.lse[(static_cast<size_t>(b) * p.sq + row) * p.heads + head] * kLog2e
                      : INFINITY;
        if (row < p.sq) p.drow[(static_cast<size_t>(b) * p.heads + head) * p.sq + row] = acc;
      }
    }
  }

  float dq[RN][NC];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) dq[r][n] = 0.f;

  for (int k0 = 0; k0 < p.sk; k0 += R) {
    __syncthreads();  // Drow and L stored; the previous tile's K and dS read
    load_tile<R, W, LD>(ks, p.k, b, k0, p.sk, p.c, col0, p.d);
    load_tile<R, W, LD>(vs, p.v, b, k0, p.sk, p.c, col0, p.d);
    __syncthreads();
    float s[RN][RN], dp[RN][RN];
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
    for (int e = 0; e < p.d; ++e) {
      float a[RN], g[RN], kb[RN], vb[RN];
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        a[r] = qs[(ty + 16 * r) * LD + e];
        g[r] = dos[(ty + 16 * r) * LD + e];
      }
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        kb[c] = ks[(tx + 16 * c) * LD + e];
        vb[c] = vs[(tx + 16 * c) * LD + e];
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          s[r][c] = fmaf(a[r], kb[c], s[r][c]);
          dp[r][c] = fmaf(g[r], vb[c], dp[r][c]);
        }
    }
    const int valid = min(R, p.sk - k0);
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const int j = tx + 16 * c;
        const float pv = j < valid ? exp2f(fmaf(s[r][c], p.scale_log2, -lrow[i])) : 0.f;
        dss[i * LDP + j] = pv * (dp[r][c] - drow[i]) * p.scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < valid; ++j) {
      float ds[RN];
#pragma unroll
      for (int r = 0; r < RN; ++r) ds[r] = dss[(ty + 16 * r) * LDP + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float kv = ks[j * LD + tx + 16 * n];
#pragma unroll
        for (int r = 0; r < RN; ++r) dq[r][n] = fmaf(ds[r], kv, dq[r][n]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= p.sq) continue;
    float* dst = p.dq + (static_cast<size_t>(b) * p.sq + row) * p.c + col0;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (tx + 16 * n < p.d) dst[tx + 16 * n] = dq[r][n];
  }
}

// dk and dv for a block of R keys: K and V resident, Q and dO streamed in
// tiles of R query rows; S^T, dP^T with keys as rows, P^T and dS^T through
// shared memory.
template <int DA>
__global__ void __launch_bounds__(kThreads, 1) attention_f32_dkdv_kernel(const BwdParams p) {
  constexpr int R = bwd_rows(DA), RN = R / 16, W = 64 * DA, LD = W + 1, LDP = R + 1;
  constexpr int NC = 4 * DA;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + R * LD;
  float* qs = vs + R * LD;
  float* dos = qs + R * LD;
  float* pt = dos + R * LD;
  float* dst = pt + R * LDP;
  float* lrow = dst + R * LDP;
  float* drow = lrow + R;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * R, head = blockIdx.y, b = blockIdx.z;
  const int col0 = head * p.d;
  load_tile<R, W, LD>(ks, p.k, b, k0, p.sk, p.c, col0, p.d);
  load_tile<R, W, LD>(vs, p.v, b, k0, p.sk, p.c, col0, p.d);

  float dk[RN][NC], dv[RN][NC];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) dk[r][n] = dv[r][n] = 0.f;

  for (int q0 = 0; q0 < p.sq; q0 += R) {
    __syncthreads();  // K, V stored; the previous tile's Q, dO, P^T and dS^T read
    load_tile<R, W, LD>(qs, p.q, b, q0, p.sq, p.c, col0, p.d);
    load_tile<R, W, LD>(dos, p.dout, b, q0, p.sq, p.c, col0, p.d);
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const int row = q0 + r;
      const bool in = row < p.sq;
      lrow[r] = in ? p.lse[(static_cast<size_t>(b) * p.sq + row) * p.heads + head] * kLog2e
                   : INFINITY;  // P = 0 on rows past Sq
      drow[r] = in ? p.drow[(static_cast<size_t>(b) * p.heads + head) * p.sq + row] : 0.f;
    }
    __syncthreads();
    float s[RN][RN], dp[RN][RN];  // rows: keys ty + 16 r; columns: query rows tx + 16 c
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
    for (int e = 0; e < p.d; ++e) {
      float kk[RN], vv[RN], qq[RN], gg[RN];
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        kk[r] = ks[(ty + 16 * r) * LD + e];
        vv[r] = vs[(ty + 16 * r) * LD + e];
      }
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        qq[c] = qs[(tx + 16 * c) * LD + e];
        gg[c] = dos[(tx + 16 * c) * LD + e];
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          s[r][c] = fmaf(kk[r], qq[c], s[r][c]);
          dp[r][c] = fmaf(vv[r], gg[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int j = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const int i = tx + 16 * c;
        const float pv = exp2f(fmaf(s[r][c], p.scale_log2, -lrow[i]));
        pt[j * LDP + i] = pv;
        dst[j * LDP + i] = pv * (dp[r][c] - drow[i]) * p.scale;
      }
    }
    __syncthreads();
    const int valid = min(R, p.sq - q0);
#pragma unroll 2
    for (int i = 0; i < valid; ++i) {
      float pr[RN], dr[RN];
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        pr[r] = pt[(ty + 16 * r) * LDP + i];
        dr[r] = dst[(ty + 16 * r) * LDP + i];
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float gv = dos[i * LD + tx + 16 * n];
        const float qv = qs[i * LD + tx + 16 * n];
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          dv[r][n] = fmaf(pr[r], gv, dv[r][n]);
          dk[r][n] = fmaf(dr[r], qv, dk[r][n]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int row = k0 + ty + 16 * r;
    if (row >= p.sk) continue;
    const size_t at = (static_cast<size_t>(b) * p.sk + row) * p.c + col0;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if (tx + 16 * n >= p.d) continue;
      p.dk[at + tx + 16 * n] = dk[r][n];
      p.dv[at + tx + 16 * n] = dv[r][n];
    }
  }
}

template <int DA>
int launch_bwd(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int R = bwd_rows(DA);
  const int dq_smem = bwd_smem_bytes(DA, false), dkdv_smem = bwd_smem_bytes(DA, true);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attention_f32_dq_kernel<DA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attention_f32_dkdv_kernel<DA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  attention_f32_dq_kernel<DA>
      <<<dim3((p.sq + R - 1) / R, p.heads, batch), kThreads, dq_smem, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_f32_dkdv_kernel<DA>
      <<<dim3((p.sk + R - 1) / R, p.heads, batch), kThreads, dkdv_smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The backward of `forward` (with its o and L); drow is a (B, heads, Sq)
// f32 scratch; 0 or a CUDA error code.
int backward(const void* q, const void* k, const void* v, const void* o, const void* lse,
             const void* dout, void* drow, void* dq, void* dk, void* dv, int batch, int sq,
             int sk, int heads, int d, cudaStream_t stream) {
  if (batch < 1 || sq < 1 || sk < 1 || heads < 1 || !head_dim_ok(d))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  BwdParams p;
  p.q = f(q);
  p.k = f(k);
  p.v = f(v);
  p.o = f(o);
  p.lse = f(lse);
  p.dout = f(dout);
  p.drow = static_cast<float*>(drow);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.sq = sq;
  p.sk = sk;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  p.scale_log2 = kLog2e * p.scale;
  switch (head_atoms(d)) {
    case 1: return launch_bwd<1>(p, batch, stream);
    case 2: return launch_bwd<2>(p, batch, stream);
    case 3: return launch_bwd<3>(p, batch, stream);
    default: return launch_bwd<4>(p, batch, stream);
  }
}

}  // namespace
}  // namespace attn_f32

extern "C" {

// dq, dk, dv of packed (B, S, heads * d) bf16 attention, from the forward's
// o and (B, Sq, heads) f32 lse and the output gradient dout; Sq and Sk
// multiples of 64, d a multiple of 8 up to 256, scale_dim d or the real head
// dim of heads zero-padded to d columns. `delta` is a
// (2, B, heads, Sq) f32 scratch the first kernel fills with L * log2(e) and
// rowsum(dO * O) for the second. Needs 16-byte aligned tensors (the wrapper
// checks). Launches both kernels on `stream`, does not synchronise, and
// returns 0 or the first error code for packed_attention_bwd_error_string.
int packed_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* lse, const void* dout, void* delta, void* dq, void* dk,
                         void* dv, int batch, int sq, int sk, int heads, int d, int scale_dim,
                         void* stream) {
  if (sq < 64 || sk < 64 || sq % 64 || sk % 64 || !head_dim_ok(d, scale_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int c = heads * d;
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
  p.d = d;
  p.heads = heads;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(scale_dim)));  // 0.125 at 64
  p.scale_log2 = kLog2e * p.scale;
  switch (head_atoms(d)) {
    case 1: return launch_bwd<1>(mq, mdo, mk, mv, p, batch, st);
    case 2: return launch_bwd<2>(mq, mdo, mk, mv, p, batch, st);
    case 3: return launch_bwd<3>(mq, mdo, mk, mv, p, batch, st);
    default: return launch_bwd<4>(mq, mdo, mk, mv, p, batch, st);
  }
}

// Shared memory each of the two kernels asks for at head dim d (0 for a d
// there is no kernel for).
int packed_attention_bwd_smem_bytes(int dkdv, int d) {
  if (!head_dim_ok(d, d)) return 0;
  switch (head_atoms(d)) {
    case 1: return dkdv ? BwdCfg<1>::kDkdvSmem : BwdCfg<1>::kDqSmem;
    case 2: return dkdv ? BwdCfg<2>::kDkdvSmem : BwdCfg<2>::kDqSmem;
    case 3: return dkdv ? BwdCfg<3>::kDkdvSmem : BwdCfg<3>::kDqSmem;
    default: return dkdv ? BwdCfg<4>::kDkdvSmem : BwdCfg<4>::kDqSmem;
  }
}

// The same on f32 tensors, d any head dim from 1 to 256; `drow` is a
// (B, heads, Sq) f32 scratch the first kernel fills with rowsum(dO * O).
int packed_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                             const void* lse, const void* dout, void* drow, void* dq, void* dk,
                             void* dv, int batch, int sq, int sk, int heads, int d,
                             void* stream) {
  if (sq < 64 || sk < 64 || sq % 64 || sk % 64) return static_cast<int>(cudaErrorInvalidValue);
  return attn_f32::backward(q, k, v, o, lse, dout, drow, dq, dk, dv, batch, sq, sk, heads, d,
                            static_cast<cudaStream_t>(stream));
}

// Shared memory each of the two f32 kernels asks for at head dim d (0 for a
// d there is no kernel for).
int packed_attention_bwd_f32_smem_bytes(int dkdv, int d) {
  return attn_f32::head_dim_ok(d) ? attn_f32::bwd_smem_bytes(attn_f32::head_atoms(d), dkdv != 0)
                                  : 0;
}

const char* packed_attention_bwd_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
