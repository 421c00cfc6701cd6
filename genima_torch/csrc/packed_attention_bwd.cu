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
// (the wrapper zero-pads any other head dim to the next multiple of 8 and
// passes the real one as scale_dim; above 256 the wide kernels below), Sq
// and Sk any multiples of 64. The TPU wrapper transposes to (B * heads, S, d) around
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
// On f32 tensors it is the f32 backward below instead (3xTF32 on the tensor
// cores, on attention_f32_hopper.cuh's pieces): the same two kernels and the
// same arithmetic with P and dS kept in f32, dq, dk and dv in f32, as the
// TPU kernel writes them in q's dtype.

#include "attention_f32_hopper.cuh"
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

// --- heads of more than four atoms (d > 256) --------------------------------
//
// Three launches, each one block per (64 rows, output chunk, head, batch)
// with two consumer warpgroups and a producer warpgroup (384 threads;
// setmaxnreg 24 / 240), walking 64-row tiles of the other sequence:
//   * dq (kWideDq): rows of Q, tiles of K and V; dQ += dS K;
//   * dV (kWideDv): rows of K, tiles of Q and dO; dV += P^T dO;
//   * dK (kWideDk): rows of K, tiles of Q and dO; dK += dS^T Q.
// A block holds its output for 2 * OA atoms, OA in each consumer warpgroup
// (wide_bwd_oa: 3 at five or six atoms, 4 at seven or eight, 5 at nine or
// ten: the whole head in one block up to d = 640; past ten atoms chunks of
// eight, one a block). S and dP are formed once a tile in each block, the
// work split between the warpgroups:
//   * dq and dK: warpgroup 0 forms S (S^T) over every atom of the head and
//     P = 2^(S scale log2(e) - L log2(e)); warpgroup 1 forms dP (dP^T) and,
//     from P handed over in shared memory, dS = P (dP - Drow) / sqrt(d) as
//     bf16 A fragments, which it hands back; each warpgroup then runs the
//     product over its OA atoms of the tile (K or Q) with dS as A.
//   * dV: each warpgroup sums S^T over half the atoms (even, odd);
//     warpgroup 1 hands its part over, warpgroup 0 adds it (always in that
//     order), forms P^T as A fragments and hands them back; dV += P^T dO
//     over each warpgroup's atoms.
// The hand-overs are 32 values a thread through a 16 KB buffer, each thread
// exchanging with the thread of the other warpgroup that holds the same
// accumulator elements, behind two named barriers (one warpgroup arrives,
// the other waits); every value is written by one warpgroup and read by the
// other in program order, so no step needs a third barrier. Both warpgroups
// run the same wgmma code on different operands (no wgmma in a
// data-dependent branch).
//   Operands: the block's 64 rows of the row tensors (Q and dO, or K and V;
// dV: K) stay resident in shared memory up to six atoms (96 KB); past six
// they stream a tile at a time beside the tile's operands. Three rings,
// each fed by its own thread of the producer warpgroup with TMA from 4-D
// maps (head_map: zeros past d and past S, so no masking):
//   * O: 8 KB atom tiles of the tensor the output product reads (K, Q or
//     dO), the block's 2 * OA atoms a tile, read by both warpgroups and
//     held until the tile's output product is retired; in dq and dK
//     warpgroup 0 forms S from these same tiles;
//   * E0, E1: 16 KB slots of warpgroup 0's and 1's other operands, given
//     back as soon as the wgmma reading them is retired (dq/dK: E0 the
//     streamed rows of Q or K and any atom of the head outside the block's
//     chunk, E1 dO / V and V / dO; dV: E0 the rows of K and the tile's Q).
// No atomics: two calls give the same bits. Against a design of one
// warpgroup a block holding a chunk of three or four atoms of the output
// (S formed 2 + 2 * chunks times, dP 1 + chunks, every operand re-read from
// L2 per tile and chunk): at d = 320 and 640 the three launches form S, dP
// and the products 8 times 2 B Sq Sk d (13 and 18 that way), and read the
// row tensors once a block.

constexpr int kWideDq = 0, kWideDk = 1, kWideDv = 2;
constexpr int kWideBwdThreads = 384;     // two consumer warpgroups and the producer warpgroup
constexpr int kWideEMax = 16;            // barriers an early ring
constexpr int kWideXBuf = 128 * 32 * 4;  // the hand-over: 32 values a consumer thread
constexpr int kWideMaxOStages = 20;
constexpr int kBlockSmem = 232448;  // dynamic shared memory a block may take
constexpr int kWideBwdSms = 132;    // the H100's SMs: a grid under them is split
constexpr int kWideBwdMaxSplits = 4;
// setmaxnreg: the producer warpgroup's registers a thread (24 and 32 left
// its threads spilling), the consumers' what is left of the SM's 512 a
// thread-slot (two warpgroups)
constexpr int kWideProducerRegs = 40;
constexpr int kWideConsumerRegs = (512 - kWideProducerRegs) / 2 / 8 * 8;

// The early rings' slots: with the rows resident a tile atom (8 KB), else a
// row atom and a tile atom (16 KB).
__host__ __device__ constexpr int wide_e_slot(bool res) { return (res ? 1 : 2) * kAtomTile; }

// The plan of the wide backward, mirrored by
// kernels/packed_attention.py::wide_backward_plan: atoms of output a consumer
// warpgroup holds, chunks of the head, whether the row tensors stay
// resident, the O ring's depth from the shared memory left, and the splits
// of the tile loop where the grid is short.
inline int wide_bwd_chunks(int atoms) { return atoms <= 10 ? 1 : (atoms + 7) / 8; }
inline int wide_bwd_oa(int atoms) { return atoms <= 6 ? 3 : atoms <= 8 ? 4 : atoms <= 10 ? 5 : 4; }
inline bool wide_bwd_resident(int atoms) { return atoms <= 6; }
inline int imin(int a, int b) { return a < b ? a : b; }
// the O ring's atoms a tile: the chunk's atoms of the head (past them the
// output product reads a zero tile)
inline int wide_bwd_o_atoms(int atoms) {
  const int chunk = 2 * wide_bwd_oa(atoms);
  return atoms < chunk ? atoms : chunk;
}
inline int wide_bwd_e_rings(int mode, bool res) {
  return (!res || mode == kWideDv ? 1 : 0) + (mode != kWideDv ? 1 : 0);
}
// Alignment slack, the resident rows, the hand-over buffer, the zero tile,
// the barriers; then the rings.
inline int wide_bwd_fixed_bytes(int mode, int atoms) {
  const bool res = wide_bwd_resident(atoms);
  const int res_tensors = res ? (mode == kWideDv ? 1 : 2) : 0;
  return 1024 + res_tensors * atoms * kAtomTile + kWideXBuf + kAtomTile + 8 * (4 * kWideEMax + 1);
}
// Depths of the O ring (slots of 8 KB and two barriers) and of each early
// ring: with the rows resident the O ring holds two tiles where three early
// slots are left beside it (so that a tile's output product and its O slots
// never hold up the next tile's scores), the early rings what is left;
// streaming, three early slots a warpgroup (dV's one ring six), the O ring
// what is left (20 at most).
inline void wide_bwd_rings(int mode, int atoms, int& o_stages, int& e_stages) {
  const bool res = wide_bwd_resident(atoms);
  const int left = kBlockSmem - wide_bwd_fixed_bytes(mode, atoms);
  const int e_bytes = wide_bwd_e_rings(mode, res) * wide_e_slot(res);  // a slot of each ring
  const int per_o = kAtomTile + 16;
  if (res) {
    o_stages = imin(2 * wide_bwd_o_atoms(atoms), (left - 3 * e_bytes) / per_o);
    e_stages = imin(kWideEMax, (left - o_stages * per_o) / e_bytes);
  } else {
    e_stages = mode == kWideDv ? 6 : 3;
    o_stages = imin(kWideMaxOStages, (left - e_stages * e_bytes) / per_o);
  }
}
inline int wide_bwd_smem_bytes(int mode, int atoms) {
  int o, e;
  wide_bwd_rings(mode, atoms, o, e);
  return wide_bwd_fixed_bytes(mode, atoms) + o * (kAtomTile + 16) +
         e * wide_bwd_e_rings(mode, wide_bwd_resident(atoms)) * wide_e_slot(wide_bwd_resident(atoms));
}
// Ranges of the tile loop a block's rows take: 1 where the grid fills the
// card, else as many as keep it within one wave, two tiles each at least
// (a tile each ran slower at 4 x 256 in two heads of 640 on the H100: the
// merge outweighs a tile), kWideBwdMaxSplits at most (the CTAs of a
// cluster, merged at the end).
inline int wide_bwd_splits(int blocks, int tiles) {
  int k = 1;
  if (blocks < kWideBwdSms)
    for (int s = 2; s <= kWideBwdMaxSplits; ++s)
      if (2 * s <= tiles && blocks * s <= kWideBwdSms) k = s;
  return k;
}

struct WideBwdParams {
  const __nv_bfloat16 *o, *dout;
  const float* lse;  // (B, Sq, heads)
  float* l2;         // (B, heads, Sq): L * log2(e), written by the dq kernel (chunk 0)
  float* drow;       // (B, heads, Sq): rowsum(dO * O), likewise
  __nv_bfloat16* out;  // dq, dk or dv: the kernel's output
  int rows, n_tiles;   // the block's sequence (Sq or Sk) and the tiles of the other
  int sq, c, d, heads, atoms, chunks, o_stages, e_stages, splits;
  float scale_log2, scale;
};

// Slot and phase of the n-th item of a ring of `stages` slots.
__device__ __forceinline__ void ring_at(int n, int stages, int& slot, uint32_t& phase) {
  slot = n % stages;
  phase = static_cast<uint32_t>(n / stages) & 1u;
}

// Maps: dq (q, dO, k, v), dK and dV (k, v, q, dO): rows x, x2, tiles y, y2.
template <int kMode, int OA, bool kRes>
__global__ void __launch_bounds__(kWideBwdThreads, 1)
bwd_wide_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_x2,
                const __grid_constant__ CUtensorMap map_y, const __grid_constant__ CUtensorMap map_y2,
                const WideBwdParams p) {
  constexpr bool kDv = kMode == kWideDv;
  constexpr bool kE0 = !kRes || kDv;  // warpgroup 0's early ring
  constexpr bool kE1 = !kDv;          // warpgroup 1's
  constexpr int kResN = kRes ? (kDv ? 1 : 2) : 0;
  constexpr int kChunk = 2 * OA;      // output atoms a block
  constexpr int kESlot = wide_e_slot(kRes);
  const int kES = p.e_stages;
  constexpr int kYOff = kRes ? 0 : kAtomTile;  // a slot's tile atom
  extern __shared__ uint8_t smem_raw[];
  const int A = p.atoms;
  uint8_t* res = align1024(smem_raw);
  float* xbuf = reinterpret_cast<float*>(res + kResN * A * kAtomTile);
  uint8_t* zero_tile = reinterpret_cast<uint8_t*>(xbuf) + kWideXBuf;  // output atoms past d
  uint8_t* e0 = zero_tile + kAtomTile;
  uint8_t* e1 = e0 + (kE0 ? kES * kESlot : 0);
  uint8_t* oring = e1 + (kE1 ? kES * kESlot : 0);
  uint64_t* o_full = reinterpret_cast<uint64_t*>(oring + p.o_stages * kAtomTile);
  uint64_t* o_empty = o_full + p.o_stages;
  uint64_t* e_full = o_empty + p.o_stages;  // [ring][stage]
  uint64_t* e_empty = e_full + 2 * kWideEMax;
  uint64_t* res_full = e_empty + 2 * kWideEMax;

  // blockIdx.x: (row block, chunk, split), the splits of a row block's
  // chunk the CTAs of one cluster
  const int split = blockIdx.x % p.splits;
  const int chunk = blockIdx.x / p.splits % p.chunks;
  const int r0 = blockIdx.x / p.splits / p.chunks * 64;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int c0 = chunk * kChunk;  // the block's first output atom
  const int n_o = min(kChunk, A - c0);  // its atoms of the head: the O ring's a tile
  const int t0 = split_begin(split, p.n_tiles, p.splits);
  const int tiles = split_begin(split + 1, p.n_tiles, p.splits) - t0;
  // dq / dK: a tile atom outside the block's chunk comes through E0 (dV:
  // every tile atom of the score product)
  const auto in_chunk = [&](int a) { return !kDv && a >= c0 && a < c0 + n_o; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.o_stages; ++s) {
      mbar_init(&o_full[s], 1);
      mbar_init(&o_empty[s], 2);  // each consumer warpgroup
    }
    for (int s = 0; s < 2 * kWideEMax; ++s) {
      mbar_init(&e_full[s], 1);
      mbar_init(&e_empty[s], 1);
    }
    mbar_init(res_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 8) {  // the producer warpgroup: a thread a ring
    setmaxnreg_dec<kWideProducerRegs>();
    if (lane == 0 && warp == 8) {  // the resident rows, then the O ring
      if constexpr (kRes) {
        mbar_expect_tx(res_full, kResN * A * kAtomTile);
        for (int a = 0; a < A; ++a) {
          tma_load_4d(res + a * kAtomTile, &map_x, res_full, a * kAtom, head, r0, batch);
          if constexpr (kResN == 2)
            tma_load_4d(res + (A + a) * kAtomTile, &map_x2, res_full, a * kAtom, head, r0, batch);
        }
      }
      const CUtensorMap* mo = kDv ? &map_y2 : &map_y;
      for (int j = 0, n = 0; j < tiles; ++j)
        for (int i = 0; i < n_o; ++i, ++n) {
          int slot;
          uint32_t phase;
          ring_at(n, p.o_stages, slot, phase);
          mbar_wait(&o_empty[slot], phase ^ 1);
          mbar_expect_tx(&o_full[slot], kAtomTile);
          tma_load_4d(oring + slot * kAtomTile, mo, &o_full[slot], (c0 + i) * kAtom, head,
                      (t0 + j) * 64, batch);
        }
    } else if (lane == 0 && ((warp == 9 && kE0) || (warp == 10 && kE1))) {
      const int r = warp - 9;  // 0: E0, 1: E1
      uint8_t* ring = r ? e1 : e0;
      const CUtensorMap* mx = r ? &map_x2 : &map_x;
      const CUtensorMap* my = r ? &map_y2 : &map_y;
      for (int j = 0, n = 0; j < tiles; ++j)
        for (int a = 0; a < A; ++a, ++n) {
          const bool tile_atom = r == 1 || !in_chunk(a);
          int slot;
          uint32_t phase;
          ring_at(n, kES, slot, phase);
          uint64_t* full = &e_full[r * kWideEMax + slot];
          mbar_wait(&e_empty[r * kWideEMax + slot], phase ^ 1);
          mbar_expect_tx(full, ((kRes ? 0 : 1) + (tile_atom ? 1 : 0)) * kAtomTile);
          uint8_t* st = ring + slot * kESlot;
          if (!kRes) tma_load_4d(st, mx, full, a * kAtom, head, r0, batch);
          if (tile_atom) tma_load_4d(st + kYOff, my, full, a * kAtom, head, (t0 + j) * 64, batch);
        }
    }
    if (p.splits > 1) {  // the consumers' merge
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  setmaxnreg_inc<kWideConsumerRegs>();
  // the consumer warpgroup, made warp-uniform for the compiler
  const int wg = __shfl_sync(0xffffffff, threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127;
  const int wq = warp & 3, g = lane >> 2, t = lane & 3;
  const bool leader = tid == 0;  // arrives on the rings' barriers for its warpgroup

  // dq: L * log2(e) (warpgroup 0) or Drow over every column (warpgroup 1)
  // of this thread's rows g and g + 8; chunk 0, split 0 writes them for dK
  // and dV
  float rowv[2] = {0.f, 0.f};
  if constexpr (kMode == kWideDq) {
    const int row0 = r0 + wq * 16;
    const size_t srow = (static_cast<size_t>(batch) * p.heads + head) * p.sq + row0 + g;
    if (wg == 0) {
      const size_t lrow = (static_cast<size_t>(batch) * p.sq + row0 + g) * p.heads + head;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rowv[r] = p.lse[lrow + static_cast<size_t>(8 * r) * p.heads] * kLog2e;
    } else {
      const size_t rows_off = (static_cast<size_t>(batch) * p.sq + row0) * p.c + head * p.d;
      for (int col = 2 * t; col < p.d; col += 8)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const size_t off = rows_off + static_cast<size_t>(g + 8 * r) * p.c + col;
          const float2 x = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p.dout + off));
          const float2 y = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p.o + off));
          rowv[r] += x.x * y.x + x.y * y.y;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rowv[r] += __shfl_xor_sync(0xffffffff, rowv[r], 1);
        rowv[r] += __shfl_xor_sync(0xffffffff, rowv[r], 2);
      }
    }
    if (chunk == 0 && split == 0 && t == 0) {
      float* dst = wg ? p.drow : p.l2;
      dst[srow] = rowv[0];
      dst[srow + 8] = rowv[1];
    }
  }
  // dK / dV: this warpgroup's per-query values of a tile (L * log2(e) for
  // warpgroup 0, Drow for warpgroup 1), read from the dq kernel's scratch
  const float* cols_src =
      (wg ? p.drow : p.l2) + (static_cast<size_t>(batch) * p.heads + head) * p.sq;

  // operands of this warpgroup's score product: dq / dK (X, Y) for
  // warpgroup 0, (X2, Y2) for 1; dV (X, Y) for both, halves of the atoms.
  // An early ring carries an item an atom a tile (with the rows resident in
  // dq / dK, E0 none: the chunk is the whole head, every tile atom in O).
  const uint8_t* res_x = res + (kResN == 2 && wg ? A : 0) * kAtomTile;
  const int er = kDv ? 0 : wg;  // this warpgroup's early ring
  uint8_t* ering = er ? e1 : e0;
  uint64_t* ef = e_full + er * kWideEMax;
  uint64_t* ee = e_empty + er * kWideEMax;
  const int a0 = kDv ? wg : 0, astep = kDv ? 2 : 1;

  // a tile's O slots go back (this warpgroup's arrival on each) once its
  // output product is retired: in the next tile, after its first score group
  // is issued (the O ring holds a tile and an atom at least), so that the
  // output product runs under the next tile's scores
  const auto release_o = [&](int n0) {
    for (int i = 0; i < n_o; ++i) {
      int os;
      uint32_t op;
      ring_at(n0 + i, p.o_stages, os, op);
      mbar_wait(&o_full[os], op);
      mbar_arrive(&o_empty[os]);
    }
  };
  float acc[32 * OA];
#pragma unroll
  for (int i = 0; i < 32 * OA; ++i) acc[i] = 0.f;
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) af[kk][0] = af[kk][1] = af[kk][2] = af[kk][3] = 0u;
  fence_operands(acc);
  for (int i = threadIdx.x; i < kAtomTile / 16; i += 256)
    reinterpret_cast<uint4*>(zero_tile)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();  // before wgmma reads it
  named_barrier(1, 256);
  if constexpr (kRes) mbar_wait(res_full, 0);
  uint32_t* xbuf_u = reinterpret_cast<uint32_t*>(xbuf);

  for (int jj = 0; jj < tiles; ++jj) {
    const int j = t0 + jj;
    const int obase = jj * n_o;
    float2 colv[8];  // dK / dV: columns 8i + 2t and + 1 of this tile
    if constexpr (kMode != kWideDq) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        colv[i] = *reinterpret_cast<const float2*>(cols_src + j * 64 + 8 * i + 2 * t);
    }
    // the score product over this warpgroup's atoms, an atom a group; an
    // early slot goes back once the group after it is issued and it retired
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_operands(s);
    int held = -1;  // the early ring item of the last committed group
    for (int a = a0; a < A; a += astep) {
      const bool first = a == a0;
      const bool from_o = !kDv && wg == 0 && in_chunk(a);
      const bool from_e = !kRes || !from_o;
      const int en = jj * A + a;
      int es = 0, os = 0;
      uint32_t ep = 0, op = 0;
      if (from_e) {
        ring_at(en, kES, es, ep);
        mbar_wait(&ef[es], ep);
      }
      if (from_o) {
        ring_at(obase + a - c0, p.o_stages, os, op);
        mbar_wait(&o_full[os], op);
      }
      const uint8_t* xa = kRes ? res_x + a * kAtomTile : ering + es * kESlot;
      const uint8_t* ya = from_o ? oring + os * kAtomTile : ering + es * kESlot + kYOff;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<64, 0>(s, desc_k(xa, kk), desc_k(ya, kk));
      wgmma_commit();
      fence_operands(s);
      wgmma_wait<1>();
      fence_operands(s);
      if (first && jj > 0) {  // the tile before's output product is retired
        fence_acc<32 * OA>(acc);
        fence_frags(af);  // its A fragments were live until here
        if (leader) release_o(obase - n_o);
      }
      if (held >= 0 && leader) {
        int hs;
        uint32_t hp;
        ring_at(held, kES, hs, hp);
        mbar_arrive(&ee[hs]);
      }
      held = from_e ? en : -1;
    }
    wgmma_wait<0>();
    fence_operands(s);
    if (held >= 0 && leader) {
      int hs;
      uint32_t hp;
      ring_at(held, kES, hs, hp);
      mbar_arrive(&ee[hs]);
    }

    // the hand-overs: after them af holds dS (dq, dK) or P^T (dV)
    fence_frags(af);
    if constexpr (kDv) {
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) xbuf[i * 128 + tid] = s[i];  // the odd atoms' S^T
        named_arrive(1, 256);
        named_barrier(2, 256);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) af[kk][e] = xbuf_u[(4 * kk + e) * 128 + tid];
      } else {
        named_barrier(1, 256);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] += xbuf[i * 128 + tid];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[4 * i] = exp2_approx(fmaf(s[4 * i], p.scale_log2, -colv[i].x));
          s[4 * i + 1] = exp2_approx(fmaf(s[4 * i + 1], p.scale_log2, -colv[i].y));
          s[4 * i + 2] = exp2_approx(fmaf(s[4 * i + 2], p.scale_log2, -colv[i].x));
          s[4 * i + 3] = exp2_approx(fmaf(s[4 * i + 3], p.scale_log2, -colv[i].y));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc_to_a(af[kk], s, kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) xbuf_u[(4 * kk + e) * 128 + tid] = af[kk][e];
        }
        named_arrive(2, 256);
      }
    } else {
      if (wg == 0) {  // P from S
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float l;
          if constexpr (kMode == kWideDq) {
            l = rowv[(i >> 1) & 1];
          } else {
            l = i & 1 ? colv[i >> 2].y : colv[i >> 2].x;
          }
          xbuf[i * 128 + tid] = exp2_approx(fmaf(s[i], p.scale_log2, -l));
        }
        named_arrive(1, 256);
        named_barrier(2, 256);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) af[kk][e] = xbuf_u[(4 * kk + e) * 128 + tid];
      } else {  // dS from P and dP (in s)
        named_barrier(1, 256);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float dr;
          if constexpr (kMode == kWideDq) {
            dr = rowv[(i >> 1) & 1];
          } else {
            dr = i & 1 ? colv[i >> 2].y : colv[i >> 2].x;
          }
          s[i] = xbuf[i * 128 + tid] * (s[i] - dr) * p.scale;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc_to_a(af[kk], s, kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) xbuf_u[(4 * kk + e) * 128 + tid] = af[kk][e];
        }
        named_arrive(2, 256);
      }
    }
    fence_frags(af);

    // the output product over this warpgroup's OA atoms of the tile
    // (an atom past the head's reads the zero tile)
#pragma unroll
    for (int a = 0; a < OA; ++a) {
      const int i = wg * OA + a;  // the atom of the chunk
      if (i < n_o) {
        int os;
        uint32_t op;
        ring_at(obase + i, p.o_stages, os, op);
        mbar_wait(&o_full[os], op);
      }
    }
    fence_acc<32 * OA>(acc);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < OA; ++a) {
      const int i = wg * OA + a;
      const uint8_t* tile =
          i < n_o ? oring + (obase + i) % p.o_stages * kAtomTile : zero_tile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<64, 1>(acc + 32 * a, af[kk], desc_mn(tile, kk));
    }
    wgmma_commit();
    fence_acc<32 * OA>(acc);
    fence_frags(af);
  }
  // the last output product, and its O slots
  wgmma_wait<0>();
  fence_acc<32 * OA>(acc);
  fence_frags(af);
  if (leader && tiles > 0) release_o((tiles - 1) * n_o);

  const int col0 = (c0 + wg * OA) * kAtom;
  __nv_bfloat16* dst =
      p.out + (static_cast<size_t>(batch) * p.rows + r0 + wq * 16) * p.c + head * p.d + col0;
  if (p.splits == 1) {
#pragma unroll
    for (int a = 0; a < OA; ++a)
      store_acc(dst + a * kAtom, p.c, acc + 32 * a, 1.f, 1.f, true, true, g, t,
                p.d - col0 - a * kAtom);
    return;
  }
  // the splits' merge: each block leaves its sums in shared memory, thread
  // by thread, as float4s; after a cluster barrier atom a of warpgroup wg is
  // summed over the splits in split order, reading the peers' through
  // distributed shared memory, by split (wg * OA + a) % splits, which stores
  // it; a second barrier keeps every block until its peers have read it
  const int ct = threadIdx.x;  // 0..255
  float4* mine = reinterpret_cast<float4*>(res);
  const uint32_t area = smem_u32(res);
  named_barrier(1, 256);  // both warpgroups are done with the rings
#pragma unroll
  for (int k = 0; k < 8 * OA; ++k)
    mine[k * 256 + ct] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  cluster_sync();
#pragma unroll
  for (int a = 0; a < OA; ++a) {
    if ((wg * OA + a) % p.splits != split) continue;
    float sum[32];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = 8 * a + k;  // float4 e of the thread's sums
      float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s2 = 0; s2 < p.splits; ++s2) {
        const float4 v = s2 == split ? mine[e * 256 + ct]
                                     : ld_cluster(map_rank(area + (e * 256 + ct) * 16, s2));
        v4 = s2 == 0 ? v : make_float4(v4.x + v.x, v4.y + v.y, v4.z + v.z, v4.w + v.w);
      }
      sum[4 * k] = v4.x, sum[4 * k + 1] = v4.y, sum[4 * k + 2] = v4.z, sum[4 * k + 3] = v4.w;
    }
    store_acc(dst + a * kAtom, p.c, sum, 1.f, 1.f, true, true, g, t, p.d - col0 - a * kAtom);
  }
  cluster_sync();
}

template <int kMode, int OA, bool kRes>
int launch_wide_kernel(const CUtensorMap& mx, const CUtensorMap& mx2, const CUtensorMap& my,
                       const CUtensorMap& my2, WideBwdParams p, void* out, int rows, int n_tiles,
                       int batch, cudaStream_t st) {
  const auto kernel = bwd_wide_kernel<kMode, OA, kRes>;
  static bool configured = false;  // the most any d asks for
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int smem = wide_bwd_smem_bytes(kMode, p.atoms);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.rows = rows;
  p.n_tiles = n_tiles;
  wide_bwd_rings(kMode, p.atoms, p.o_stages, p.e_stages);
  // the O ring holds a tile and an atom, each early ring two slots
  if (p.o_stages <= wide_bwd_o_atoms(p.atoms) || p.e_stages < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  p.splits = wide_bwd_splits(rows / 64 * p.chunks * p.heads * batch, n_tiles);
  const dim3 grid(rows / 64 * p.chunks * p.splits, p.heads, batch);
  if (p.splits > 1)
    return launch_clustered(kernel, grid, kWideBwdThreads, smem, p.splits, st, mx, mx2, my, my2, p);
  kernel<<<grid, kWideBwdThreads, smem, st>>>(mx, mx2, my, my2, p);
  return static_cast<int>(cudaGetLastError());
}

// dq first (it writes `delta`), then dV and dK.
template <int OA, bool kRes>
int launch_bwd_wide(const CUtensorMap& mq, const CUtensorMap& mdo, const CUtensorMap& mk,
                    const CUtensorMap& mv, const WideBwdParams& p, void* dq, void* dk, void* dv,
                    int sk, int batch, cudaStream_t st) {
  int rc = launch_wide_kernel<kWideDq, OA, kRes>(mq, mdo, mk, mv, p, dq, p.sq, sk / 64, batch, st);
  if (!rc)
    rc = launch_wide_kernel<kWideDv, OA, kRes>(mk, mv, mq, mdo, p, dv, sk, p.sq / 64, batch, st);
  if (!rc)
    rc = launch_wide_kernel<kWideDk, OA, kRes>(mk, mv, mq, mdo, p, dk, sk, p.sq / 64, batch, st);
  return rc;
}

// B2b at heads of more than four atoms (d > 256); the arguments as
// packed_attention_bwd's.
int backward_wide(const void* q, const void* k, const void* v, const void* o, const void* lse,
                  const void* dout, void* delta, void* dq, void* dk, void* dv, int batch, int sq,
                  int sk, int heads, int d, int scale_dim, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  int rc;
  if ((rc = head_map(&mq, q, batch, sq, heads, d, 64))) return rc;
  if ((rc = head_map(&mk, k, batch, sk, heads, d, 64))) return rc;
  if ((rc = head_map(&mv, v, batch, sk, heads, d, 64))) return rc;
  if ((rc = head_map(&mdo, dout, batch, sq, heads, d, 64))) return rc;
  WideBwdParams p{};
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.l2 = static_cast<float*>(delta);
  p.drow = p.l2 + static_cast<size_t>(batch) * heads * sq;
  p.sq = sq;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.atoms = head_atoms(d);
  p.chunks = wide_bwd_chunks(p.atoms);
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(scale_dim)));
  p.scale_log2 = kLog2e * p.scale;
  switch (wide_bwd_oa(p.atoms)) {
    case 3: return launch_bwd_wide<3, true>(mq, mdo, mk, mv, p, dq, dk, dv, sk, batch, st);
    case 4: return launch_bwd_wide<4, false>(mq, mdo, mk, mv, p, dq, dk, dv, sk, batch, st);
    default: return launch_bwd_wide<5, false>(mq, mdo, mk, mv, p, dq, dk, dv, sk, batch, st);
  }
}

}  // namespace

namespace attn_f32 {
namespace {

// --- backward (B2b on f32) ---------------------------------------------------
//
// Replaces genima_tpu/kernels/packed_attention.py:380 _flash_backward /
// _bwd_kernel on f32 inputs (P and dS kept in f32, dq, dk and dv in f32).
// Two kernels, no atomics, so two calls give the same bits, on the header's
// pieces (attention_f32_hopper.cuh: 3xTF32, wgmma for the K-major products,
// mma.sync for those over a tile's rows). Each is warp-specialised as the
// forward is: the producer warpgroup's warp 0 TMA-loads the block's two
// resident tensors once and streams tiles of T rows through a ring; its
// warps 1-3 split each landed tile (big in place, small beside it), since
// each streamed tile is both a wgmma B operand and a mma.sync B operand.
//   * dq kernel, one block per (64 * NWG query rows, head, batch): Q and dO
//     resident (raw: the A operands, split per k8 step). Its prologue
//     computes Drow = rowsum(dO * O) over the head's columns and
//     L * log2(e) for its rows and writes both, (B, heads, Sq), into the
//     `delta` scratch for the second kernel. Per tile of T keys: S = Q K^T
//     and dP = dO V^T (wgmma), P = 2^(S scale log2(e) - L log2(e)) and
//     dS = P (dP - Drow) / sqrt(d) in registers, dQ += dS K (mma.sync, a
//     fresh accumulator a tile and slab).
//   * dk/dv kernel, one block per (64 * NWG keys, head, batch): K and V
//     resident. Per tile of T query rows (with their L * log2(e) and Drow,
//     bulk-copied from the scratch into the stage): S^T = K Q^T and dP^T =
//     V dO^T (wgmma), P^T and dS^T in registers, dV += P^T dO and
//     dK += dS^T Q (mma.sync). At three and four atoms dV and dK would
//     take 96-128 registers a thread each, so the kernel makes two passes
//     over the query tiles, dV in the first and dK in the second.
// Bound: 10 * B * Sq * Sk * C flops (the TPU kernel's count; these kernels
// form S and dP in both, 14) at 3xTF32's 165 TFLOP/s, on ~32 * B * (Sq +
// Sk) * C bytes. Plans (bwd_nwg, bwd_tile, bwd_stages, bwd_passes;
// kernels/packed_attention.py::backward_plan): one atom two consumer
// warpgroups on 64-row tiles; two to four atoms one warpgroup, on 32-, 16-
// and 8-row tiles (16 in the dk/dv kernel at two atoms): shared memory and
// registers.

constexpr int bwd_nwg(int da) { return da == 1 ? 2 : 1; }
// rows a streamed tile: 64, 32, 16, 8 at one to four atoms, but 16 in the
// dk/dv kernel at two (its dK and dV, live beside S^T and dP^T, spilled
// at 32)
constexpr int bwd_tile(int da, bool dkdv) { return dkdv && da == 2 ? 16 : 128 >> da; }
constexpr int bwd_stages(int da, bool dkdv) { return dkdv && da == 2 ? 4 : da == 4 ? 3 : 2; }
__host__ __device__ constexpr int bwd_passes(int da) { return da >= 3 ? 2 : 1; }

// Dynamic shared memory of a backward block: alignment slack, two resident
// tensors of 64 * nwg rows, the ring of four tiles (two tensors and their
// remainders), in the dk/dv kernel a stage's L * log2(e) and Drow, and the
// barriers.
constexpr int bwd_smem_bytes(int da, bool dkdv) {
  return 1024 + 2 * 64 * bwd_nwg(da) * 2 * da * kSlabBytes +
         bwd_stages(da, dkdv) *
             (4 * bwd_tile(da, dkdv) * 2 * da * kSlabBytes + (dkdv ? 8 * bwd_tile(da, dkdv) : 0)) +
         8 * (3 * bwd_stages(da, dkdv) + 1);
}

struct BwdParams {
  const float* o;
  const float* lse;   // (B, Sq, heads)
  const float* dout;
  float* l2;          // (B, heads, Sq): L * log2(e), the dq kernel's for the dk/dv kernel
  float* drow;        // (B, heads, Sq): rowsum(dO * O), likewise
  float* dq;
  float* dk;
  float* dv;
  int sq, sk, c, d, heads;
  float scale, scale_log2;
};

template <int DA, bool kDkdv>
struct BwdCfg {
  static constexpr int kNS = 2 * DA;
  static constexpr int kNWG = bwd_nwg(DA);
  static constexpr int kT = bwd_tile(DA, kDkdv);
  static constexpr int kStages = bwd_stages(DA, kDkdv);
  static constexpr int kBM = 64 * kNWG;  // rows a block: query rows (dq) or keys (dk/dv)
  static constexpr int kThreads = 128 * kNWG + kProducer;
  static constexpr int kRes = kBM * kNS * kSlabBytes;   // one resident tensor
  static constexpr int kTile = kT * kNS * kSlabBytes;   // one streamed tile
  static constexpr int kStage = 4 * kTile;  // X, X's remainders, Y, Y's remainders
  // k8 steps a wgmma group: one where two would spill
  static constexpr int kGroup = DA == 1 ? 2 : 1;
};

// The producer warpgroup of both kernels: warp 0's first thread loads the two
// resident tensors (rows r0 of maps ra, rb), then `tiles` tiles of T rows of
// maps sa and sb into the ring (with kRows, the tile's T values of `rows_a`
// and `rows_b` too, into `rows`); warps 1-3 split both tensors of each
// stage. Tile j reads rows (j % per_pass) * T.
template <int DA, bool kRows>  // kRows: the dk/dv kernel's
__device__ __forceinline__ void bwd_producer(const CUtensorMap* ra, const CUtensorMap* rb,
                                             const CUtensorMap* sa, const CUtensorMap* sb,
                                             uint8_t* res, uint8_t* ring, float* rows,
                                             uint64_t* full, uint64_t* ready, uint64_t* empty,
                                             uint64_t* res_full, int r0, int col, int batch,
                                             int tiles, int per_pass, const float* rows_a,
                                             const float* rows_b) {
  using C = BwdCfg<DA, kRows>;
  constexpr int NS = C::kNS, T = C::kT, S = C::kStages;
  const int warp = (threadIdx.x >> 5) - 4 * C::kNWG;
  int stage = 0;
  uint32_t phase = 0;
  if (warp == 0) {
    if ((threadIdx.x & 31) != 0) return;
    prefetch_tensormap(ra);
    prefetch_tensormap(rb);
    prefetch_tensormap(sa);
    prefetch_tensormap(sb);
    mbar_expect_tx(res_full, 2 * C::kRes);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load_3d(res + s * C::kBM * kSlabBytes, ra, res_full, col + 32 * s, r0, batch);
      tma_load_3d(res + C::kRes + s * C::kBM * kSlabBytes, rb, res_full, col + 32 * s, r0, batch);
    }
    for (int j = 0; j < tiles; ++j) {
      mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* st = ring + stage * C::kStage;
      const int row = (j % per_pass) * T;
      mbar_expect_tx(&full[stage], 2 * C::kTile + (kRows ? 8 * T : 0));
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        tma_load_3d(st + s * T * kSlabBytes, sa, &full[stage], col + 32 * s, row, batch);
        tma_load_3d(st + 2 * C::kTile + s * T * kSlabBytes, sb, &full[stage], col + 32 * s, row,
                    batch);
      }
      if constexpr (kRows) {
        bulk_load(rows + stage * 2 * T, rows_a + row, 4 * T, &full[stage]);
        bulk_load(rows + stage * 2 * T + T, rows_b + row, 4 * T, &full[stage]);
      }
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  const int sid = threadIdx.x - 128 * C::kNWG - 32;
  for (int j = 0; j < tiles; ++j) {
    mbar_wait(&full[stage], phase);
    uint8_t* st = ring + stage * C::kStage;
    split_tile(st, st + C::kTile, C::kTile, sid);
    split_tile(st + 2 * C::kTile, st + 3 * C::kTile, C::kTile, sid);
    fence_proxy_async();  // before wgmma reads them
    mbar_arrive(&ready[stage]);
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <class C>
__device__ __forceinline__ void bwd_barriers(uint64_t* full, uint64_t* ready, uint64_t* empty,
                                             uint64_t* res_full) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitters);
      mbar_init(&empty[s], 4 * C::kNWG);
    }
    mbar_init(res_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
}

template <int NS>
__device__ __forceinline__ void zero_slabs(float (&x)[NS][4][4]) {
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[s][nb][e] = 0.f;
}

// acc += X B for every slab, each into a fresh accumulator first (B's big
// tile at b, its remainders at b_small, T rows a slab).
template <int NS, int T>
__device__ __forceinline__ void add_xb(float (&acc)[NS][4][4], const float* x, const uint8_t* b,
                                       const uint8_t* b_small, int g, int t) {
#pragma unroll
  for (int sl = 0; sl < NS; ++sl) {
    float part[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nb][e] = 0.f;
    gemm_xb<T, true>(part, x, b + sl * T * kSlabBytes, b_small + sl * T * kSlabBytes, g, t);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[sl][nb][e] += part[nb][e];
  }
}

// dq for a block of query rows: Q and dO resident, K and V streamed.
template <int DA>
__global__ void __launch_bounds__(BwdCfg<DA, false>::kThreads, 1)
attention_f32_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const BwdParams p) {
  using C = BwdCfg<DA, false>;
  constexpr int NS = C::kNS, NWG = C::kNWG, T = C::kT, S = C::kStages;
  constexpr int kS = T / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = attn_hopper::align1024(smem_raw);
  uint8_t* res = smem;  // Q, then dO
  uint8_t* ring = smem + 2 * C::kRes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kStage);
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;
  uint64_t* res_full = empty + S;
  const int q0 = blockIdx.x * C::kBM, head = blockIdx.y, batch = blockIdx.z;
  bwd_barriers<C>(full, ready, empty, res_full);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4 * NWG) {
    if constexpr (NWG >= 2) setmaxnreg_dec<40>();
    bwd_producer<DA, false>(&map_q, &map_do, &map_k, &map_v, res, ring, nullptr, full, ready,
                            empty, res_full, q0, head * p.d, batch, p.sk / T, p.sk / T, nullptr,
                            nullptr);
    return;
  }
  if constexpr (NWG >= 2) setmaxnreg_inc<232>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + wq * 16;
  const int row = q0 + row0 + g;  // global row of r = 0; r = 1 is row + 8

  // Drow over the head's columns (dO and O from global memory, a float4 a
  // lane) and L * log2(e), for rows g and g + 8; rows past Sq: P = 0
  float l2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    float acc = 0.f;
    if (rr < p.sq) {
      const size_t at = (static_cast<size_t>(batch) * p.sq + rr) * p.c + head * p.d;
      for (int c = 4 * t; c < p.d; c += 16) {
        const float4 a = *reinterpret_cast<const float4*>(p.dout + at + c);
        const float4 b = *reinterpret_cast<const float4*>(p.o + at + c);
        acc = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
      }
    }
    acc += __shfl_xor_sync(0xffffffff, acc, 1);
    acc += __shfl_xor_sync(0xffffffff, acc, 2);
    dr[r] = acc;
    l2[r] = rr < p.sq ? p.lse[(static_cast<size_t>(batch) * p.sq + rr) * p.heads + head] * kLog2e
                      : INFINITY;
    if (t == 0 && rr < p.sq) {
      const size_t at = (static_cast<size_t>(batch) * p.heads + head) * p.sq + rr;
      p.l2[at] = l2[r];
      p.drow[at] = acc;
    }
  }

  float dq[NS][4][4];
  zero_slabs(dq);
  const uint32_t q_addr = smem_u32(res), do_addr = smem_u32(res + C::kRes);
  mbar_wait(res_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < p.sk / T; ++j) {
    mbar_wait(&full[stage], phase);
    mbar_wait(&ready[stage], phase);
    const uint8_t* kt = ring + stage * C::kStage;
    const uint8_t* vt = kt + 2 * C::kTile;
    float s[kS], dp[kS];
    gemm_abt<NS, C::kBM, T, C::kGroup>(s, q_addr, row0, kt, kt + C::kTile, lane, p.d);
    gemm_abt<NS, C::kBM, T, C::kGroup>(dp, do_addr, row0, vt, vt + C::kTile, lane, p.d);
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int r = (i >> 1) & 1;
      const float pv = attn_hopper::exp2_approx(fmaf(s[i], p.scale_log2, -l2[r]));
      s[i] = pv * (dp[i] - dr[r]) * p.scale;  // dS
    }
    add_xb<NS, T>(dq, s, kt, kt + C::kTile, g, t);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
  float* dst = p.dq + (static_cast<size_t>(batch) * p.sq + row) * p.c + head * p.d;
#pragma unroll
  for (int sl = 0; sl < NS; ++sl)
    store_slab(dst + 32 * sl, p.c, dq[sl], 1.f, 1.f, row < p.sq, row + 8 < p.sq, t, p.d - 32 * sl);
}

// One pass of the dk/dv kernel over the query tiles: dV (kDV) and / or dK
// (kDK) of this warp's keys.
template <int DA, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_pass(float (&dv)[2 * DA][4][4], float (&dk)[2 * DA][4][4],
                                          const BwdParams& p, uint32_t k_addr, uint32_t v_addr,
                                          const uint8_t* ring, const float* rows, uint64_t* full,
                                          uint64_t* ready, uint64_t* empty, int& stage,
                                          uint32_t& phase, int row0, int lane) {
  using C = BwdCfg<DA, true>;
  constexpr int NS = C::kNS, T = C::kT, kS = T / 2;
  const int g = lane >> 2, t = lane & 3;
  for (int j = 0; j < p.sq / T; ++j) {
    mbar_wait(&full[stage], phase);
    mbar_wait(&ready[stage], phase);
    const uint8_t* qt = ring + stage * C::kStage;
    const uint8_t* dot = qt + 2 * C::kTile;
    const float* l2 = rows + stage * 2 * T;
    const float* dr = l2 + T;
    // S^T and dP^T back to back, then P^T and dS^T, then dV and dK (forming
    // dP^T after dV += P^T dO holds fewer values at once and spills less,
    // but measured slower)
    float st[kS], dpt[kS];
    gemm_abt<NS, C::kBM, T, C::kGroup>(st, k_addr, row0, qt, qt + C::kTile, lane, p.d);
    if constexpr (kDK)
      gemm_abt<NS, C::kBM, T, C::kGroup>(dpt, v_addr, row0, dot, dot + C::kTile, lane, p.d);
#pragma unroll
    for (int i = 0; i < kS; i += 4) {  // query columns 8 (i / 4) + 2t and + 1
      const float2 l = *reinterpret_cast<const float2*>(l2 + 2 * i + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dr + 2 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[i + e] = attn_hopper::exp2_approx(fmaf(st[i + e], p.scale_log2, e & 1 ? -l.y : -l.x));
        if constexpr (kDK)  // dS^T
          dpt[i + e] = st[i + e] * (dpt[i + e] - (e & 1 ? d2.y : d2.x)) * p.scale;
      }
    }
    if constexpr (kDV) add_xb<NS, T>(dv, st, dot, dot + C::kTile, g, t);
    if constexpr (kDK) add_xb<NS, T>(dk, dpt, qt, qt + C::kTile, g, t);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// dk and dv for a block of keys: K and V resident, Q and dO streamed.
template <int DA>
__global__ void __launch_bounds__(BwdCfg<DA, true>::kThreads, 1)
attention_f32_dkdv_kernel(const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_do, const BwdParams p) {
  using C = BwdCfg<DA, true>;
  constexpr int NS = C::kNS, NWG = C::kNWG, T = C::kT, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = attn_hopper::align1024(smem_raw);
  uint8_t* res = smem;  // K, then V
  uint8_t* ring = smem + 2 * C::kRes;
  float* rows = reinterpret_cast<float*>(ring + S * C::kStage);  // a stage's L * log2(e), Drow
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + S * 2 * T);
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;
  uint64_t* res_full = empty + S;
  const int k0 = blockIdx.x * C::kBM, head = blockIdx.y, batch = blockIdx.z;
  bwd_barriers<C>(full, ready, empty, res_full);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4 * NWG) {
    if constexpr (NWG >= 2) setmaxnreg_dec<40>();
    const size_t at = (static_cast<size_t>(batch) * p.heads + head) * p.sq;
    bwd_producer<DA, true>(&map_k, &map_v, &map_q, &map_do, res, ring, rows, full, ready, empty,
                           res_full, k0, head * p.d, batch, bwd_passes(DA) * (p.sq / T), p.sq / T,
                           p.l2 + at, p.drow + at);
    return;
  }
  if constexpr (NWG >= 2) setmaxnreg_inc<232>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + wq * 16;
  const int key = k0 + row0 + g;
  const uint32_t k_addr = smem_u32(res), v_addr = smem_u32(res + C::kRes);
  const bool ok0 = key < p.sk, ok8 = key + 8 < p.sk;
  const size_t at = (static_cast<size_t>(batch) * p.sk + key) * p.c + head * p.d;
  mbar_wait(res_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  if constexpr (bwd_passes(DA) == 1) {
    float dv[NS][4][4], dk[NS][4][4];
    zero_slabs(dv);
    zero_slabs(dk);
    dkdv_pass<DA, true, true>(dv, dk, p, k_addr, v_addr, ring, rows, full, ready, empty, stage,
                              phase, row0, lane);
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      store_slab(p.dv + at + 32 * sl, p.c, dv[sl], 1.f, 1.f, ok0, ok8, t, p.d - 32 * sl);
      store_slab(p.dk + at + 32 * sl, p.c, dk[sl], 1.f, 1.f, ok0, ok8, t, p.d - 32 * sl);
    }
  } else {
    float acc[NS][4][4];
    zero_slabs(acc);
    dkdv_pass<DA, true, false>(acc, acc, p, k_addr, v_addr, ring, rows, full, ready, empty, stage,
                               phase, row0, lane);
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
      store_slab(p.dv + at + 32 * sl, p.c, acc[sl], 1.f, 1.f, ok0, ok8, t, p.d - 32 * sl);
    zero_slabs(acc);
    dkdv_pass<DA, false, true>(acc, acc, p, k_addr, v_addr, ring, rows, full, ready, empty, stage,
                               phase, row0, lane);
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
      store_slab(p.dk + at + 32 * sl, p.c, acc[sl], 1.f, 1.f, ok0, ok8, t, p.d - 32 * sl);
  }
}

template <int DA>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const BwdParams& p,
               int batch, cudaStream_t stream) {
  using C = BwdCfg<DA, false>;
  using D = BwdCfg<DA, true>;
  constexpr int dq_smem = bwd_smem_bytes(DA, false), dkdv_smem = bwd_smem_bytes(DA, true);
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
  // resident tensors in blocks of kBM rows, streamed ones in each kernel's tiles
  CUtensorMap rq, rdo, rk, rv, tq, tdo, tk, tv;
  int rc;
  if ((rc = seq_map(&rq, q, batch, p.sq, p.c, C::kBM))) return rc;
  if ((rc = seq_map(&rdo, dout, batch, p.sq, p.c, C::kBM))) return rc;
  if ((rc = seq_map(&rk, k, batch, p.sk, p.c, D::kBM))) return rc;
  if ((rc = seq_map(&rv, v, batch, p.sk, p.c, D::kBM))) return rc;
  if ((rc = seq_map(&tq, q, batch, p.sq, p.c, D::kT))) return rc;
  if ((rc = seq_map(&tdo, dout, batch, p.sq, p.c, D::kT))) return rc;
  if ((rc = seq_map(&tk, k, batch, p.sk, p.c, C::kT))) return rc;
  if ((rc = seq_map(&tv, v, batch, p.sk, p.c, C::kT))) return rc;
  attention_f32_dq_kernel<DA>
      <<<dim3((p.sq + C::kBM - 1) / C::kBM, p.heads, batch), C::kThreads, dq_smem, stream>>>(
          rq, rdo, tk, tv, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_f32_dkdv_kernel<DA>
      <<<dim3((p.sk + D::kBM - 1) / D::kBM, p.heads, batch), D::kThreads, dkdv_smem, stream>>>(
          rk, rv, tq, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

// --- heads of more than four atoms (d > 256) --------------------------------
//
// B2b on f32 at d > 256, as the bf16 wide backward above makes it: three
// launches (dq, dV, dK), each one block per (64 rows, output chunk, head,
// batch) with two consumer warpgroups holding 2 * OA atoms of the output
// (wide_bwd_oa_f32: 3 at five or six atoms, 4 above, past eight atoms
// chunks of eight, one a block) and a producer warpgroup (384 threads), S
// and dP formed once a tile of kWideT = 32 rows in each block and split
// between the warpgroups as there: dq / dK warpgroup 0 S and P, warpgroup 1
// dP and dS, handed over in f32 (16 values a thread); dV each warpgroup
// half the atoms of S^T, warpgroup 1's part added to warpgroup 0's. On the
// header's wide pieces (attention_f32_hopper.cuh): one ring of 32 KB slots,
// a tile's items in order: per atom an S item (the block's 64 rows of X
// raw, 16 KB, and the tile's 32 rows of Y, split by the producer's warps
// 1-3 into big and small), dq / dK the two warpgroups' items in turn (X, Y
// then X2, Y2), dV the atoms in turn; then an output item a warpgroup (the
// tile's rows of its OA atoms of K, Q or dO, raw: mma.sync's B, split on
// the fly). Each item is read by one warpgroup, whose four warps give it
// back. S (dP) is formed with a fresh wgmma accumulator an atom and the
// products a slab with a fresh mma.sync accumulator, added in f32, as the
// narrow f32 kernels do.

constexpr int kWideBwdItems = 6;              // the ring's slots
constexpr int kWideXBufF32 = 128 * (kWideT / 2) * 4;  // the hand-over: 16 values a thread
constexpr int kWideProducerRegsF32 = 40;  // as the bf16 kernel's
constexpr int kWideConsumerRegsF32 = (512 - kWideProducerRegsF32) / 2 / 8 * 8;

// Chunks of eight atoms at most (OA = 4: five would not fit the registers),
// the fewest atoms a warpgroup that cover the head in them (3 or 4: at ten
// atoms two chunks of six ran faster than two of eight on the H100, with
// less of the output product on zero atoms).
inline int wide_bwd_chunks_f32(int atoms) { return (atoms + 7) / 8; }
inline int wide_bwd_oa_f32(int atoms) {
  const int per = 2 * wide_bwd_chunks_f32(atoms);  // warpgroups over the head
  const int oa = (atoms + per - 1) / per;
  return oa < 3 ? 3 : oa;
}

// Alignment slack, the ring, the hand-over buffer, the barriers (full,
// ready, empty a slot); mirrored by kernels/packed_attention.py.
constexpr int wide_bwd_smem_bytes_f32() {
  return 1024 + kWideBwdItems * kWideSlotF32 + kWideXBufF32 + 8 * 3 * kWideBwdItems;
}

struct WideBwdParamsF32 {
  const float *o, *dout, *lse;
  float* l2;    // (B, heads, Sq): L * log2(e), the dq kernel's (chunk 0) for dK and dV
  float* drow;  // (B, heads, Sq): rowsum(dO * O), likewise
  float* out;
  int rows, n_tiles;  // the block's sequence (Sq or Sk) and the tiles of the other
  int sq, c, d, heads, atoms, chunks, splits;
  float scale, scale_log2;
};

// Maps: x, x2 64-row boxes of the block's rows (dq: q, dO; dK / dV: k, v),
// y, y2 kWideT-row boxes of the tiles (dq: k, v; dK / dV: q, dO), out the
// output product's (dq: k, dK: q, dV: dO).
template <int kMode, int OA>
__global__ void __launch_bounds__(384, 1)
attention_f32_bwd_wide_kernel(const __grid_constant__ CUtensorMap map_x,
                              const __grid_constant__ CUtensorMap map_x2,
                              const __grid_constant__ CUtensorMap map_y,
                              const __grid_constant__ CUtensorMap map_y2,
                              const __grid_constant__ CUtensorMap map_out,
                              const WideBwdParamsF32 p) {
  constexpr bool kDv = kMode == 2;
  constexpr int NS = 2 * OA, kS = kWideT / 2, S = kWideBwdItems;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = attn_hopper::align1024(smem_raw);
  float* xbuf = reinterpret_cast<float*>(ring + S * kWideSlotF32);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(xbuf) + kWideXBufF32);
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;
  const int A = p.atoms;
  const int split = blockIdx.x % p.splits;  // as the bf16 kernel's
  const int chunk = blockIdx.x / p.splits % p.chunks;
  const int r0 = blockIdx.x / p.splits / p.chunks * 64;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int c0 = chunk * 2 * OA;                    // the block's first output atom
  const int t0 = attn_hopper::split_begin(split, p.n_tiles, p.splits);
  const int tiles = attn_hopper::split_begin(split + 1, p.n_tiles, p.splits) - t0;
  const int n_s = kDv ? A : 2 * A;                  // S items a tile
  const int items = n_s + 2;                        // and an output item a warpgroup
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitters);
      mbar_init(&empty[s], 4);  // the reading warpgroup's warps
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 8) {  // the producer warpgroup: warp 0's first thread loads, warps 1-3 split
    setmaxnreg_dec<kWideProducerRegsF32>();
    const int pw = warp - 8;
    for (int j = t0, n = 0; j < t0 + tiles && (pw > 0 || lane == 0); ++j)
      for (int i = 0; i < items; ++i, ++n) {
        const int slot = n % S;
        const uint32_t phase = (n / S) & 1;
        uint8_t* st = ring + slot * kWideSlotF32;
        if (pw == 0) {
          mbar_wait(&empty[slot], phase ^ 1);
          if (i < n_s) {
            const bool second = !kDv && (i & 1);  // (X2, Y2) after (X, Y)
            const int atom = kDv ? i : i >> 1;
            mbar_expect_tx(&full[slot], kWideX + kWideY);
            tma_atom_x(st, second ? &map_x2 : &map_x, &full[slot], atom, head, r0, batch);
            tma_atom_y(st + kWideX, second ? &map_y2 : &map_y, &full[slot], atom, head,
                       j * kWideT, batch);
          } else {
            mbar_expect_tx(&full[slot], OA * 2 * kWideT * kSlabBytes);
            tma_chunk<OA>(st, &map_out, &full[slot], (c0 + (i - n_s) * OA) * 64, head, j * kWideT,
                          batch);
          }
        } else {
          mbar_wait(&full[slot], phase);
          if (i < n_s) split_tile(st + kWideX, st + kWideX + kWideY, kWideY, threadIdx.x - 288);
          fence_proxy_async();  // before wgmma reads them
          mbar_arrive(&ready[slot]);
        }
      }
    if (p.splits > 1) {  // the consumers' merge
      attn_hopper::cluster_sync();
      attn_hopper::cluster_sync();
    }
    return;
  }
  setmaxnreg_inc<kWideConsumerRegsF32>();
  const int wg = __shfl_sync(0xffffffff, threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127;
  const int wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int row0 = wq * 16;  // this warp's rows of the block

  // dq: L * log2(e) (warpgroup 0) or Drow (warpgroup 1) of rows g and g + 8;
  // chunk 0 writes them for dK and dV
  float rowv[2] = {0.f, 0.f};
  if constexpr (kMode == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r0 + row0 + g + 8 * r;
      if (wg == 0) {
        rowv[r] = p.lse[(static_cast<size_t>(batch) * p.sq + rr) * p.heads + head] * kLog2e;
      } else {
        const size_t at = (static_cast<size_t>(batch) * p.sq + rr) * p.c + head * p.d;
        float acc = 0.f;
        for (int c = 4 * t; c < p.d; c += 16) {
          const float4 a = *reinterpret_cast<const float4*>(p.dout + at + c);
          const float4 b = *reinterpret_cast<const float4*>(p.o + at + c);
          acc = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
        }
        acc += __shfl_xor_sync(0xffffffff, acc, 1);
        acc += __shfl_xor_sync(0xffffffff, acc, 2);
        rowv[r] = acc;
      }
      if (chunk == 0 && split == 0 && t == 0)
        (wg ? p.drow : p.l2)[(static_cast<size_t>(batch) * p.heads + head) * p.sq + rr] = rowv[r];
    }
  }
  const float* cols_src =
      (wg ? p.drow : p.l2) + (static_cast<size_t>(batch) * p.heads + head) * p.sq;

  float acc[NS][4][4];
  zero_slabs(acc);
  const int a0 = kDv ? wg : 0, astep = kDv ? 2 : 1;
  for (int jj = 0; jj < tiles; ++jj) {
    const int j = t0 + jj;
    const int base = jj * items;
    float2 colv[kS / 4];  // dK / dV: columns 8i + 2t and + 1 of this tile
    if constexpr (kMode != 0) {
#pragma unroll
      for (int i = 0; i < kS / 4; ++i)
        colv[i] = *reinterpret_cast<const float2*>(cols_src + j * kWideT + 8 * i + 2 * t);
    }
    float s[kS];
    zero(s);
    for (int a = a0; a < A; a += astep) {
      const int n = base + (kDv ? a : 2 * a + wg);
      const int slot = n % S;
      const uint32_t phase = (n / S) & 1;
      mbar_wait(&full[slot], phase);
      mbar_wait(&ready[slot], phase);
      const uint8_t* st = ring + slot * kWideSlotF32;
      float part[kS];
      gemm_abt<2, 64, kWideT, 1>(part, smem_u32(st), row0, st + kWideX, st + kWideX + kWideY,
                                 lane, 64);
#pragma unroll
      for (int i = 0; i < kS; ++i) s[i] += part[i];
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }

    // the hand-overs: after them s holds dS (dq, dK) or P^T (dV)
    if constexpr (kDv) {
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < kS; ++i) xbuf[i * 128 + tid] = s[i];  // the odd atoms' S^T
        named_arrive(1, 256);
        named_barrier(2, 256);
#pragma unroll
        for (int i = 0; i < kS; ++i) s[i] = xbuf[i * 128 + tid];
      } else {
        named_barrier(1, 256);
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const float l = i & 1 ? colv[i >> 2].y : colv[i >> 2].x;
          s[i] = attn_hopper::exp2_approx(fmaf(s[i] + xbuf[i * 128 + tid], p.scale_log2, -l));
          xbuf[i * 128 + tid] = s[i];
        }
        named_arrive(2, 256);
      }
    } else {
      if (wg == 0) {  // P from S
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          float l;
          if constexpr (kMode == 0) {
            l = rowv[(i >> 1) & 1];
          } else {
            l = i & 1 ? colv[i >> 2].y : colv[i >> 2].x;
          }
          xbuf[i * 128 + tid] = attn_hopper::exp2_approx(fmaf(s[i], p.scale_log2, -l));
        }
        named_arrive(1, 256);
        named_barrier(2, 256);
#pragma unroll
        for (int i = 0; i < kS; ++i) s[i] = xbuf[i * 128 + tid];
      } else {  // dS from P and dP (in s)
        named_barrier(1, 256);
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          float dr;
          if constexpr (kMode == 0) {
            dr = rowv[(i >> 1) & 1];
          } else {
            dr = i & 1 ? colv[i >> 2].y : colv[i >> 2].x;
          }
          s[i] = xbuf[i * 128 + tid] * (s[i] - dr) * p.scale;
          xbuf[i * 128 + tid] = s[i];
        }
        named_arrive(2, 256);
      }
    }

    // the output product over this warpgroup's OA atoms of the tile
    const int n = base + n_s + wg;
    const int slot = n % S;
    const uint32_t phase = (n / S) & 1;
    mbar_wait(&full[slot], phase);
    mbar_wait(&ready[slot], phase);
    const uint8_t* ot = ring + slot * kWideSlotF32;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      float part[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nb][e] = 0.f;
      gemm_xb<kWideT, false>(part, s, ot + sl * kWideT * kSlabBytes, nullptr, g, t);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[sl][nb][e] += part[nb][e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
  const int col0 = (c0 + wg * OA) * 64;
  float* dst = p.out + (static_cast<size_t>(batch) * p.rows + r0 + row0 + g) * p.c + head * p.d +
               col0;
  if (p.splits == 1) {
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
      store_slab(dst + 32 * sl, p.c, acc[sl], 1.f, 1.f, true, true, t, p.d - col0 - 32 * sl);
    return;
  }
  // the splits' merge, as the bf16 kernel's: atom a of warpgroup wg (two
  // slabs) summed in split order by split (wg * OA + a) % splits
  const int ct = threadIdx.x;  // 0..255
  float4* mine = reinterpret_cast<float4*>(ring);
  const uint32_t area = smem_u32(ring);
  named_barrier(1, 256);  // both warpgroups are done with the ring
#pragma unroll
  for (int sl = 0; sl < NS; ++sl)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
      mine[(4 * sl + nb) * 256 + ct] =
          make_float4(acc[sl][nb][0], acc[sl][nb][1], acc[sl][nb][2], acc[sl][nb][3]);
  attn_hopper::cluster_sync();
#pragma unroll
  for (int a = 0; a < OA; ++a) {
    if ((wg * OA + a) % p.splits != split) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sl = 2 * a + h;
      float sum[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int e = 4 * sl + nb;
        float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s2 = 0; s2 < p.splits; ++s2) {
          const float4 v =
              s2 == split ? mine[e * 256 + ct]
                          : attn_hopper::ld_cluster(attn_hopper::map_rank(area + (e * 256 + ct) * 16, s2));
          v4 = s2 == 0 ? v : make_float4(v4.x + v.x, v4.y + v.y, v4.z + v.z, v4.w + v.w);
        }
        sum[nb][0] = v4.x, sum[nb][1] = v4.y, sum[nb][2] = v4.z, sum[nb][3] = v4.w;
      }
      store_slab(dst + 32 * sl, p.c, sum, 1.f, 1.f, true, true, t, p.d - col0 - 32 * sl);
    }
  }
  attn_hopper::cluster_sync();
}

template <int kMode, int OA>
int launch_wide_f32(const CUtensorMap& mx, const CUtensorMap& mx2, const CUtensorMap& my,
                    const CUtensorMap& my2, const CUtensorMap& mo, WideBwdParamsF32 p, float* out,
                    int rows, int n_tiles, int batch, cudaStream_t st) {
  const auto kernel = attention_f32_bwd_wide_kernel<kMode, OA>;
  constexpr int smem = wide_bwd_smem_bytes_f32();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  p.out = out;
  p.rows = rows;
  p.n_tiles = n_tiles;
  p.splits = wide_bwd_splits(rows / 64 * p.chunks * p.heads * batch, n_tiles);
  const dim3 grid(rows / 64 * p.chunks * p.splits, p.heads, batch);
  if (p.splits > 1)
    return attn_hopper::launch_clustered(kernel, grid, 384, smem, p.splits, st, mx, mx2, my, my2,
                                         mo, p);
  kernel<<<grid, 384, smem, st>>>(mx, mx2, my, my2, mo, p);
  return static_cast<int>(cudaGetLastError());
}

// x*: maps of 64-row boxes (q, dO, k, v), y*: of kWideT-row boxes; dq first
// (it writes `delta`), then dV and dK.
template <int OA>
int launch_bwd_wide(const CUtensorMap (&x)[4], const CUtensorMap (&y)[4],
                    const WideBwdParamsF32& p, float* dq, float* dk, float* dv, int sk, int batch,
                    cudaStream_t st) {
  int rc = launch_wide_f32<0, OA>(x[0], x[1], y[2], y[3], y[2], p, dq, p.sq, sk / kWideT, batch, st);
  if (!rc)
    rc = launch_wide_f32<2, OA>(x[2], x[3], y[0], y[1], y[1], p, dv, sk, p.sq / kWideT, batch, st);
  if (!rc)
    rc = launch_wide_f32<1, OA>(x[2], x[3], y[0], y[1], y[0], p, dk, sk, p.sq / kWideT, batch, st);
  return rc;
}

// The f32 backward at d > 256; the arguments as `backward`'s.
int backward_wide(const void* q, const void* k, const void* v, const void* o, const void* lse,
                  const void* dout, void* delta, void* dq, void* dk, void* dv, int batch, int sq,
                  int sk, int heads, int d, int scale_dim, cudaStream_t stream) {
  const void* base[4] = {q, dout, k, v};
  const int rows[4] = {sq, sq, sk, sk};
  CUtensorMap x[4], y[4];
  for (int i = 0; i < 4; ++i) {
    int rc = head_map_f32(&x[i], base[i], batch, rows[i], heads, d, 64);
    if (!rc) rc = head_map_f32(&y[i], base[i], batch, rows[i], heads, d, kWideT);
    if (rc) return rc;
  }
  WideBwdParamsF32 p{};
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.l2 = static_cast<float*>(delta);
  p.drow = p.l2 + static_cast<size_t>(batch) * heads * sq;
  p.sq = sq;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.atoms = head_atoms(d);
  p.chunks = wide_bwd_chunks_f32(p.atoms);
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(scale_dim)));
  p.scale_log2 = kLog2e * p.scale;
  auto* fq = static_cast<float*>(dq);
  auto* fk = static_cast<float*>(dk);
  auto* fv = static_cast<float*>(dv);
  return wide_bwd_oa_f32(p.atoms) == 3
             ? launch_bwd_wide<3>(x, y, p, fq, fk, fv, sk, batch, stream)
             : launch_bwd_wide<4>(x, y, p, fq, fk, fv, sk, batch, stream);
}

// The backward of `forward` (with its o and L) on f32 tensors of heads of d
// columns (a multiple of 4) scaled by 1 / sqrt(scale_dim), Sq and Sk
// multiples of 64; `delta` is a (2, B, heads, Sq) f32 scratch the dq kernel
// fills with L * log2(e) and Drow; 0 or an error code.
int backward(const void* q, const void* k, const void* v, const void* o, const void* lse,
             const void* dout, void* delta, void* dq, void* dk, void* dv, int batch, int sq,
             int sk, int heads, int d, int scale_dim, cudaStream_t stream) {
  if (batch < 1 || heads < 1 || sq < 64 || sk < 64 || sq % 64 || sk % 64 ||
      !head_dim_ok(d, scale_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_atoms(d) > attn_hopper::kNarrowAtoms)
    return backward_wide(q, k, v, o, lse, dout, delta, dq, dk, dv, batch, sq, sk, heads, d,
                         scale_dim, stream);
  BwdParams p;
  p.o = static_cast<const float*>(o);
  p.lse = static_cast<const float*>(lse);
  p.dout = static_cast<const float*>(dout);
  p.l2 = static_cast<float*>(delta);
  p.drow = p.l2 + static_cast<size_t>(batch) * heads * sq;
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.sq = sq;
  p.sk = sk;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(scale_dim)));
  p.scale_log2 = kLog2e * p.scale;
  switch (head_atoms(d)) {
    case 1: return launch_bwd<1>(q, k, v, dout, p, batch, stream);
    case 2: return launch_bwd<2>(q, k, v, dout, p, batch, stream);
    case 3: return launch_bwd<3>(q, k, v, dout, p, batch, stream);
    default: return launch_bwd<4>(q, k, v, dout, p, batch, stream);
  }
}

}  // namespace
}  // namespace attn_f32

extern "C" {

// dq, dk, dv of packed (B, S, heads * d) bf16 attention, from the forward's
// o and (B, Sq, heads) f32 lse and the output gradient dout; Sq and Sk
// multiples of 64, d a multiple of 8 (above 256 the wide kernels),
// scale_dim d or the real head dim of heads zero-padded to d columns.
// `delta` is a (2, B, heads, Sq) f32 scratch the first kernel fills with
// L * log2(e) and rowsum(dO * O) for the second. Needs 16-byte aligned
// tensors (the wrapper checks). Launches both kernels on `stream`, does not synchronise, and
// returns 0 or the first error code for packed_attention_bwd_error_string.
int packed_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* lse, const void* dout, void* delta, void* dq, void* dk,
                         void* dv, int batch, int sq, int sk, int heads, int d, int scale_dim,
                         void* stream) {
  if (batch < 1 || heads < 1 || sq < 64 || sk < 64 || sq % 64 || sk % 64 ||
      !head_dim_ok(d, scale_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (head_atoms(d) > kNarrowAtoms)
    return backward_wide(q, k, v, o, lse, dout, delta, dq, dk, dv, batch, sq, sk, heads, d,
                         scale_dim, st);
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

// Shared memory each kernel asks for at head dim d (0 for a d there is no
// kernel for): dkdv 0 the dq kernel, 1 the dk/dv kernel (above four atoms
// the dK kernel), 2 above four atoms the dV kernel (below, 0: dV is the
// dk/dv kernel's).
int packed_attention_bwd_smem_bytes(int dkdv, int d) {
  if (!head_dim_ok(d, d) || dkdv < 0 || dkdv > 2) return 0;
  if (dkdv == 2 && head_atoms(d) <= kNarrowAtoms) return 0;
  switch (head_atoms(d)) {
    case 1: return dkdv ? BwdCfg<1>::kDkdvSmem : BwdCfg<1>::kDqSmem;
    case 2: return dkdv ? BwdCfg<2>::kDkdvSmem : BwdCfg<2>::kDqSmem;
    case 3: return dkdv ? BwdCfg<3>::kDkdvSmem : BwdCfg<3>::kDqSmem;
    case 4: return dkdv ? BwdCfg<4>::kDkdvSmem : BwdCfg<4>::kDqSmem;
    default: return wide_bwd_smem_bytes(dkdv, head_atoms(d));  // the wide kernels (d > 256)
  }
}

// The same on f32 tensors (3xTF32): d a multiple of 4 (the wrapper
// zero-pads any other head dim; above 256 the wide f32 kernels), scale_dim
// d or the real head dim of heads zero-padded to d columns; `delta` as
// above.
int packed_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                             const void* lse, const void* dout, void* delta, void* dq, void* dk,
                             void* dv, int batch, int sq, int sk, int heads, int d, int scale_dim,
                             void* stream) {
  return attn_f32::backward(q, k, v, o, lse, dout, delta, dq, dk, dv, batch, sq, sk, heads, d,
                            scale_dim, static_cast<cudaStream_t>(stream));
}

// Shared memory each f32 kernel asks for at head dim d, dkdv as for
// packed_attention_bwd_smem_bytes (0 for a d there is no kernel for).
int packed_attention_bwd_f32_smem_bytes(int dkdv, int d) {
  if (!attn_f32::head_dim_ok(d, d) || dkdv < 0 || dkdv > 2) return 0;
  const int da = attn_f32::head_atoms(d);
  if (da > kNarrowAtoms) return attn_f32::wide_bwd_smem_bytes_f32();  // dq, dK and dV alike
  return dkdv == 2 ? 0 : attn_f32::bwd_smem_bytes(da, dkdv != 0);
}

const char* packed_attention_bwd_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
