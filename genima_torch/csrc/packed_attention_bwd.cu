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
// A chunk of dQ, dK or dV of four atoms already holds 128 f32 a thread beside
// S and dP; the narrow kernels keep every atom of a block's resident
// tensors, which no shared memory holds at every d. So above four atoms each
// output is made in chunks of OA = 3 or 4 atoms (wide_chunk_atoms), one
// chunk a block, with nothing of the head resident: per streamed tile, S
// and dP (and their transposes) are summed over every atom of the head
// from a ring of 32 KB slots (attention_hopper.cuh's kWideSlot: four 64-row
// atom tiles), then the chunk's product runs on the chunk's atoms of the
// tile:
//   * dq kernel, one block per (64 query rows, chunk, head, batch): per
//     64-key tile, `atoms` items (Q, K, dO, V of one atom) for S = Q K^T and
//     dP = dO V^T, then one item of K's chunk atoms for dQ += dS K. Its
//     prologue forms Drow = rowsum(dO * O) over the whole of d (from global
//     memory) and L * log2(e); chunk 0 writes both into `delta`.
//   * dV kernel (kDK false), one block per (64 keys, chunk, head, batch):
//     per 64-query tile, ceil(atoms / 2) items (K and Q of two atoms) for
//     S^T = K Q^T, then one item of dO's chunk atoms, with the tile's
//     L * log2(e) and Drow, for dV += P^T dO;
//   * dK kernel (kDK true): `atoms` items (K, Q, V, dO of one atom) for S^T
//     and dP^T = V dO^T, then Q's chunk atoms for dK += dS^T Q.
// The dV and dK passes of the narrow kernels above two atoms are here two
// launches over separate grids (a kernel template each, so that no wgmma
// sits in a data-dependent branch). No atomics: two calls give the same
// bits. One consumer warpgroup and a one-warp producer (160 threads, up to
// 255 registers); the 4-D maps (head_map) give zeros past d and so no
// masking. The price of streaming: Q, K, dO, V re-read from L2 for every
// tile and chunk (S is formed 2 + 2 * chunks times, dP 1 + chunks).

constexpr int kWideThreads = 160;

struct WideBwdParams {
  const __nv_bfloat16 *o, *dout;
  const float* lse;  // (B, Sq, heads)
  float* l2;         // (B, heads, Sq): L * log2(e), written by the dq kernel (chunk 0)
  float* drow;       // (B, heads, Sq): rowsum(dO * O), likewise
  __nv_bfloat16* out;  // dq, dk or dv: the kernel's output
  int sq, sk, c, d, heads, atoms, chunks;
  float scale_log2, scale;
};

// Rings of the wide backward: slots of four 64-row atom tiles, a stage's 64
// values of L * log2(e) and Drow (the dk/dv kernels), the barriers.
constexpr int wide_bwd_smem_bytes(bool dkdv) {
  return 1024 + kMaxWideStages * (kWideSlot + (dkdv ? 2 * 64 * 4 : 0) + 16);
}

// S (and, with kDP, dP) for a tile: `items` slots from the ring, each one
// atom of X Y^T into s and of X2 Y2^T into dp (kDP), or two atoms of X Y^T
// into s; each slot goes back once the group after it has been issued and
// the one before it retired. `held` is the slot of the last committed group
// (-1: none).
template <bool kDP>
__device__ __forceinline__ void wide_scores(float (&s)[32], float (&dp)[32], int items,
                                            const uint8_t* ring, uint64_t* full, uint64_t* empty,
                                            int stages, int& slot, uint32_t& phase, int& held,
                                            bool arrives) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_operands(s);
  if constexpr (kDP) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    fence_operands(dp);
  }
  for (int i = 0; i < items; ++i) {
    mbar_wait(&full[slot], phase);
    const uint8_t* st = ring + slot * kWideSlot;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<64, 0>(s, desc_k(st, kk), desc_k(st + kAtomTile, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (kDP)
        wgmma_ss<64, 0>(dp, desc_k(st + 2 * kAtomTile, kk), desc_k(st + 3 * kAtomTile, kk));
      else
        wgmma_ss<64, 0>(s, desc_k(st + 2 * kAtomTile, kk), desc_k(st + 3 * kAtomTile, kk));
    }
    wgmma_commit();
    fence_operands(s);
    if constexpr (kDP) fence_operands(dp);
    wgmma_wait<1>();
    fence_operands(s);
    if constexpr (kDP) fence_operands(dp);
    if (held >= 0 && arrives) mbar_arrive(&empty[held]);
    held = slot;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(s);
  if constexpr (kDP) fence_operands(dp);
  if (arrives) mbar_arrive(&empty[held]);
}

template <int OA>
__device__ __forceinline__ void wide_chunk_mma(float* acc, const uint32_t (&af)[4][4],
                                               const uint8_t* tile) {
#pragma unroll
  for (int a = 0; a < OA; ++a)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64, 1>(acc + 32 * a, af[kk], desc_mn(tile + a * kAtomTile, kk));
}

// The chunk's 64 rows x OA atoms of an output from `row` (rows of stride c).
template <int OA>
__device__ __forceinline__ void wide_store(const WideBwdParams& p, const float* acc, int batch,
                                           int s, int row, int head, int chunk, int g, int t) {
  const int col0 = chunk * OA * kAtom;
  __nv_bfloat16* dst = p.out + (static_cast<size_t>(batch) * s + row) * p.c + head * p.d + col0;
#pragma unroll
  for (int a = 0; a < OA; ++a)
    store_acc(dst + a * kAtom, p.c, acc + 32 * a, 1.f, 1.f, true, true, g, t,
              p.d - col0 - a * kAtom);
}

template <int OA>
__global__ void __launch_bounds__(kWideThreads, 1)
bwd_wide_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const WideBwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kMaxWideStages * kWideSlot);
  uint64_t* empty = full + kMaxWideStages;
  const int chunk = blockIdx.x % p.chunks;
  const int q0 = blockIdx.x / p.chunks * 64;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int n_tiles = p.sk / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxWideStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4) {
    if (lane == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        for (int a = 0; a <= p.atoms; ++a) {  // `atoms` S/dP items, then the chunk's K
          mbar_wait(&empty[slot], phase ^ 1);
          uint8_t* st = ring + slot * kWideSlot;
          if (a < p.atoms) {
            mbar_expect_tx(&full[slot], kWideSlot);
            tma_load_4d(st, &map_q, &full[slot], a * kAtom, head, q0, batch);
            tma_load_4d(st + kAtomTile, &map_k, &full[slot], a * kAtom, head, j * 64, batch);
            tma_load_4d(st + 2 * kAtomTile, &map_do, &full[slot], a * kAtom, head, q0, batch);
            tma_load_4d(st + 3 * kAtomTile, &map_v, &full[slot], a * kAtom, head, j * 64, batch);
          } else {
            mbar_expect_tx(&full[slot], OA * kAtomTile);
            for (int c = 0; c < OA; ++c)
              tma_load_4d(st + c * kAtomTile, &map_k, &full[slot], (chunk * OA + c) * kAtom, head,
                          j * 64, batch);
          }
          if (++slot == kMaxWideStages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const bool arrives = warp == 0 && lane == 0;
  const int row0 = q0 + warp * 16;
  // Drow over every column of the head and L * log2(e), rows g and g + 8
  float drow[2] = {0.f, 0.f}, l2[2];
  const size_t rows_off = (static_cast<size_t>(batch) * p.sq + row0) * p.c + head * p.d;
  for (int col = 2 * t; col < p.d; col += 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t off = rows_off + static_cast<size_t>(g + 8 * r) * p.c + col;
      const float2 x = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p.dout + off));
      const float2 y = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p.o + off));
      drow[r] += x.x * y.x + x.y * y.y;
    }
  const size_t lrow = (static_cast<size_t>(batch) * p.sq + row0 + g) * p.heads + head;
  const size_t srow = (static_cast<size_t>(batch) * p.heads + head) * p.sq + row0 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    drow[r] += __shfl_xor_sync(0xffffffff, drow[r], 1);
    drow[r] += __shfl_xor_sync(0xffffffff, drow[r], 2);
    l2[r] = p.lse[lrow + static_cast<size_t>(8 * r) * p.heads] * kLog2e;
    if (chunk == 0 && t == 0) {
      p.l2[srow + 8 * r] = l2[r];
      p.drow[srow + 8 * r] = drow[r];
    }
  }

  float dq[32 * OA];
#pragma unroll
  for (int i = 0; i < 32 * OA; ++i) dq[i] = 0.f;
  uint32_t dsf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) dsf[kk][0] = dsf[kk][1] = dsf[kk][2] = dsf[kk][3] = 0u;
  fence_operands(dq);
  int slot = 0, held = -1;
  uint32_t phase = 0;
  for (int j = 0; j < n_tiles; ++j) {
    float s[32], dp[32];
    wide_scores<true>(s, dp, p.atoms, ring, full, empty, kMaxWideStages, slot, phase, held,
                      arrives);
    fence_operands(dq);
    fence_frags(dsf);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      dp[i] = exp2_approx(fmaf(s[i], p.scale_log2, -l2[r])) * (dp[i] - drow[r]) * p.scale;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(dsf[kk], dp, kk);
    mbar_wait(&full[slot], phase);  // the chunk's K
    fence_frags(dsf);
    fence_operands(dq);
    wgmma_fence();
    wide_chunk_mma<OA>(dq, dsf, ring + slot * kWideSlot);  // dQ += dS K
    wgmma_commit();
    fence_operands(dq);
    held = slot;
    if (++slot == kMaxWideStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(dq);
  fence_frags(dsf);
  wide_store<OA>(p, dq, batch, p.sq, row0, head, chunk, g, t);
}

template <int OA, bool kDK>
__global__ void __launch_bounds__(kWideThreads, 1)
bwd_wide_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const WideBwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* rows_ring = reinterpret_cast<float*>(ring + kMaxWideStages * kWideSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_ring + kMaxWideStages * 2 * 64);
  uint64_t* empty = full + kMaxWideStages;
  const int chunk = blockIdx.x % p.chunks;
  const int k0 = blockIdx.x / p.chunks * 64;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int n_tiles = p.sq / 64;
  const int items = kDK ? p.atoms : (p.atoms + 1) / 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxWideStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4) {
    if (lane == 0) {
      const size_t bh = (static_cast<size_t>(batch) * p.heads + head) * p.sq;
      int slot = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        for (int n = 0; n <= items; ++n) {  // S^T (/ dP^T) items, then the chunk's item
          mbar_wait(&empty[slot], phase ^ 1);
          uint8_t* st = ring + slot * kWideSlot;
          if (n < items) {
            mbar_expect_tx(&full[slot], kWideSlot);
            const int a = kDK ? n : 2 * n;
            tma_load_4d(st, &map_k, &full[slot], a * kAtom, head, k0, batch);
            tma_load_4d(st + kAtomTile, &map_q, &full[slot], a * kAtom, head, i * 64, batch);
            if (kDK) {
              tma_load_4d(st + 2 * kAtomTile, &map_v, &full[slot], a * kAtom, head, k0, batch);
              tma_load_4d(st + 3 * kAtomTile, &map_do, &full[slot], a * kAtom, head, i * 64,
                          batch);
            } else {
              tma_load_4d(st + 2 * kAtomTile, &map_k, &full[slot], (a + 1) * kAtom, head, k0,
                          batch);
              tma_load_4d(st + 3 * kAtomTile, &map_q, &full[slot], (a + 1) * kAtom, head, i * 64,
                          batch);
            }
          } else {
            float* rs = rows_ring + slot * 2 * 64;
            mbar_expect_tx(&full[slot], OA * kAtomTile + 2 * 64 * 4);
            for (int c = 0; c < OA; ++c)
              tma_load_4d(st + c * kAtomTile, kDK ? &map_q : &map_do, &full[slot],
                          (chunk * OA + c) * kAtom, head, i * 64, batch);
            bulk_load(rs, p.l2 + bh + i * 64, 64 * 4, &full[slot]);
            bulk_load(rs + 64, p.drow + bh + i * 64, 64 * 4, &full[slot]);
          }
          if (++slot == kMaxWideStages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const bool arrives = warp == 0 && lane == 0;
  float acc[32 * OA];
#pragma unroll
  for (int i = 0; i < 32 * OA; ++i) acc[i] = 0.f;
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) af[kk][0] = af[kk][1] = af[kk][2] = af[kk][3] = 0u;
  fence_operands(acc);
  int slot = 0, held = -1;
  uint32_t phase = 0;
  for (int i = 0; i < n_tiles; ++i) {
    // transposed scores: rows are this warp's keys g, g + 8; accumulator
    // value e of column group j is query 8j + 2t + (e & 1) of the tile
    float s[32], dp[32];
    wide_scores<kDK>(s, dp, items, ring, full, empty, kMaxWideStages, slot, phase, held,
                     arrives);
    fence_operands(acc);
    fence_frags(af);
    mbar_wait(&full[slot], phase);  // the chunk's tile and the rows' L * log2(e), Drow
    const float* rs = rows_ring + slot * 2 * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(rs + 8 * j + 2 * t);
      const float2 dr = *reinterpret_cast<const float2*>(rs + 64 + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i4 = 4 * j + e;
        s[i4] = exp2_approx(fmaf(s[i4], p.scale_log2, -(e & 1 ? l.y : l.x)));
        if constexpr (kDK) s[i4] = s[i4] * (dp[i4] - (e & 1 ? dr.y : dr.x)) * p.scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(af[kk], s, kk);
    fence_frags(af);
    fence_operands(acc);
    wgmma_fence();
    wide_chunk_mma<OA>(acc, af, ring + slot * kWideSlot);  // dK += dS^T Q, dV += P^T dO
    wgmma_commit();
    fence_operands(acc);
    held = slot;
    if (++slot == kMaxWideStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  fence_frags(af);
  wide_store<OA>(p, acc, batch, p.sk, k0 + warp * 16, head, chunk, g, t);
}

template <int OA>
int launch_bwd_wide(const CUtensorMap& mq, const CUtensorMap& mdo, const CUtensorMap& mk,
                    const CUtensorMap& mv, WideBwdParams p, __nv_bfloat16* dq,
                    __nv_bfloat16* dk, __nv_bfloat16* dv, int batch, cudaStream_t st) {
  constexpr int dq_smem = wide_bwd_smem_bytes(false), dkdv_smem = wide_bwd_smem_bytes(true);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(bwd_wide_dq_kernel<OA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_wide_dkdv_kernel<OA, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_wide_dkdv_kernel<OA, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  p.out = dq;
  bwd_wide_dq_kernel<OA><<<dim3(p.sq / 64 * p.chunks, p.heads, batch), kWideThreads, dq_smem,
                           st>>>(mq, mdo, mk, mv, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.sk / 64 * p.chunks, p.heads, batch);
  p.out = dv;
  bwd_wide_dkdv_kernel<OA, false><<<grid, kWideThreads, dkdv_smem, st>>>(mq, mdo, mk, mv, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  p.out = dk;
  bwd_wide_dkdv_kernel<OA, true><<<grid, kWideThreads, dkdv_smem, st>>>(mq, mdo, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
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
  WideBwdParams p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.l2 = static_cast<float*>(delta);
  p.drow = p.l2 + static_cast<size_t>(batch) * heads * sq;
  p.sq = sq;
  p.sk = sk;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.atoms = head_atoms(d);
  p.chunks = wide_chunks(p.atoms);
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(scale_dim)));
  p.scale_log2 = kLog2e * p.scale;
  auto* bq = static_cast<__nv_bfloat16*>(dq);
  auto* bk = static_cast<__nv_bfloat16*>(dk);
  auto* bv = static_cast<__nv_bfloat16*>(dv);
  return wide_chunk_atoms(p.atoms) == 3
             ? launch_bwd_wide<3>(mq, mdo, mk, mv, p, bq, bk, bv, batch, st)
             : launch_bwd_wide<4>(mq, mdo, mk, mv, p, bq, bk, bv, batch, st);
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
// B2b on f32 at d > 256, on the header's wide pieces (attention_f32_hopper.cuh:
// a ring of 32 KB slots of S items and chunk items, 4-D maps, a fresh
// accumulator an atom): dQ, dV and dK in chunks of OA atoms, one chunk a
// block, as the bf16 wide kernels above make them.
//   * dq kernel, one block per (64 query rows, chunk, head, batch): per tile
//     of kWideT keys, two S items an atom ((Q, K) into S, (dO, V) into dP),
//     then K's chunk atoms for dQ += dS K. The prologue as the narrow f32 dq
//     kernel's, over every column; chunk 0 writes `delta`.
//   * dk/dv kernel <kDK>, one block per (64 keys, chunk, head, batch): per
//     tile of kWideT query rows, (K, Q) into S^T (and with kDK (V, dO) into
//     dP^T) an atom, then the chunk item (dO's chunk atoms for dV += P^T dO,
//     or Q's for dK += dS^T Q) with the tile's L * log2(e) and Drow. dV and
//     dK are two launches.

template <int OA>
__global__ void __launch_bounds__(kWideThreadsF32, 1)
attention_f32_dq_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_do,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v, const WideParamsF32 p) {
  constexpr int NS = 2 * OA, kS = kWideT / 2, S = attn_hopper::kMaxWideStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = attn_hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kWideSlotF32);
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;
  const int chunk = blockIdx.x % p.chunks;
  const int q0 = blockIdx.x / p.chunks * 64;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int col0 = chunk * OA * 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitters);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4) {
    const CUtensorMap *mq = &map_q, *mdo = &map_do, *mk = &map_k, *mv = &map_v;
    const int items = 2 * p.atoms;
    wide_producer(p.sk / kWideT, items, ring, full, ready, empty, S, [=](int j, int n, int slot) {
      uint8_t* st = ring + slot * kWideSlotF32;
      if (n < items) {
        mbar_expect_tx(&full[slot], kWideX + kWideY);
        tma_atom_x(st, n & 1 ? mdo : mq, &full[slot], n >> 1, head, q0, batch);
        tma_atom_y(st + kWideX, n & 1 ? mv : mk, &full[slot], n >> 1, head, j * kWideT, batch);
      } else {
        mbar_expect_tx(&full[slot], OA * 2 * kWideT * kSlabBytes);
        tma_chunk<OA>(st, mk, &full[slot], col0, head, j * kWideT, batch);
      }
    });
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int row = q0 + row0 + g;  // global row of r = 0; r = 1 is row + 8
  float l2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    const size_t at = (static_cast<size_t>(batch) * p.sq + rr) * p.c + head * p.d;
    float acc = 0.f;
    for (int c = 4 * t; c < p.d; c += 16) {
      const float4 a = *reinterpret_cast<const float4*>(p.dout + at + c);
      const float4 b = *reinterpret_cast<const float4*>(p.o_in + at + c);
      acc = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
    }
    acc += __shfl_xor_sync(0xffffffff, acc, 1);
    acc += __shfl_xor_sync(0xffffffff, acc, 2);
    dr[r] = acc;
    l2[r] = p.lse_in[(static_cast<size_t>(batch) * p.sq + rr) * p.heads + head] * kLog2e;
    if (chunk == 0 && t == 0) {
      const size_t sat = (static_cast<size_t>(batch) * p.heads + head) * p.sq + rr;
      p.l2[sat] = l2[r];
      p.drow[sat] = acc;
    }
  }
  float dq[NS][4][4];
  zero_slabs(dq);
  int slot = 0;
  uint32_t phase = 0;
  for (int j = 0; j < p.sk / kWideT; ++j) {
    float s[kS], dp[kS];
    zero(s);
    zero(dp);
    for (int a = 0; a < p.atoms; ++a) {
      wide_scores_item(s, ring, full, ready, empty, S, slot, phase, row0, lane);
      wide_scores_item(dp, ring, full, ready, empty, S, slot, phase, row0, lane);
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = attn_hopper::exp2_approx(fmaf(s[i], p.scale_log2, -l2[r])) * (dp[i] - dr[r]) *
             p.scale;  // dS
    }
    mbar_wait(&full[slot], phase);  // the chunk's K
    mbar_wait(&ready[slot], phase);
    const uint8_t* kt = ring + slot * kWideSlotF32;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      float part[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nb][e] = 0.f;
      gemm_xb<kWideT, false>(part, s, kt + sl * kWideT * kSlabBytes, nullptr, g, t);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[sl][nb][e] += part[nb][e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (++slot == S) {
      slot = 0;
      phase ^= 1;
    }
  }
  float* dst = p.o + (static_cast<size_t>(batch) * p.sq + row) * p.c + head * p.d + col0;
#pragma unroll
  for (int sl = 0; sl < NS; ++sl)
    store_slab(dst + 32 * sl, p.c, dq[sl], 1.f, 1.f, true, true, t, p.d - col0 - 32 * sl);
}

template <int OA, bool kDK>
__global__ void __launch_bounds__(kWideThreadsF32, 1)
attention_f32_dkdv_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_do,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v, const WideParamsF32 p) {
  constexpr int NS = 2 * OA, kS = kWideT / 2, S = attn_hopper::kMaxWideStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = attn_hopper::align1024(smem_raw);
  float* rows = reinterpret_cast<float*>(ring + S * kWideSlotF32);  // a stage's L * log2(e), Drow
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + S * 2 * kWideT);
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;
  const int chunk = blockIdx.x % p.chunks;
  const int k0 = blockIdx.x / p.chunks * 64;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int col0 = chunk * OA * 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitters);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4) {
    const CUtensorMap *mq = &map_q, *mdo = &map_do, *mk = &map_k, *mv = &map_v;
    const int items = (kDK ? 2 : 1) * p.atoms;
    const size_t bh = (static_cast<size_t>(batch) * p.heads + head) * p.sq;
    const float *l2 = p.l2 + bh, *drow = p.drow + bh;
    wide_producer(p.sq / kWideT, items, ring, full, ready, empty, S, [=](int j, int n, int slot) {
      uint8_t* st = ring + slot * kWideSlotF32;
      if (n < items) {
        const bool second = kDK && (n & 1);  // (V, dO) after (K, Q)
        const int atom = kDK ? n >> 1 : n;
        mbar_expect_tx(&full[slot], kWideX + kWideY);
        tma_atom_x(st, second ? mv : mk, &full[slot], atom, head, k0, batch);
        tma_atom_y(st + kWideX, second ? mdo : mq, &full[slot], atom, head, j * kWideT, batch);
      } else {
        float* rs = rows + slot * 2 * kWideT;
        mbar_expect_tx(&full[slot], OA * 2 * kWideT * kSlabBytes + 2 * kWideT * 4);
        tma_chunk<OA>(st, kDK ? mq : mdo, &full[slot], col0, head, j * kWideT, batch);
        bulk_load(rs, l2 + j * kWideT, kWideT * 4, &full[slot]);
        bulk_load(rs + kWideT, drow + j * kWideT, kWideT * 4, &full[slot]);
      }
    });
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  float acc[NS][4][4];
  zero_slabs(acc);
  int slot = 0;
  uint32_t phase = 0;
  for (int j = 0; j < p.sq / kWideT; ++j) {
    // transposed scores: rows are this warp's keys; value e of column group
    // i / 4 is query 8 (i / 4) + 2t + (e & 1) of the tile
    float st[kS], dpt[kS];
    zero(st);
    if constexpr (kDK) zero(dpt);
    for (int a = 0; a < p.atoms; ++a) {
      wide_scores_item(st, ring, full, ready, empty, S, slot, phase, row0, lane);
      if constexpr (kDK)
        wide_scores_item(dpt, ring, full, ready, empty, S, slot, phase, row0, lane);
    }
    mbar_wait(&full[slot], phase);  // the chunk's tile, L * log2(e) and Drow
    mbar_wait(&ready[slot], phase);
    const uint8_t* ct = ring + slot * kWideSlotF32;
    const float* l2 = rows + slot * 2 * kWideT;
    const float* dr = l2 + kWideT;
#pragma unroll
    for (int i = 0; i < kS; i += 4) {
      const float2 l = *reinterpret_cast<const float2*>(l2 + 2 * i + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dr + 2 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[i + e] = attn_hopper::exp2_approx(fmaf(st[i + e], p.scale_log2, e & 1 ? -l.y : -l.x));
        if constexpr (kDK)  // dS^T
          st[i + e] = st[i + e] * (dpt[i + e] - (e & 1 ? d2.y : d2.x)) * p.scale;
      }
    }
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      float part[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nb][e] = 0.f;
      gemm_xb<kWideT, false>(part, st, ct + sl * kWideT * kSlabBytes, nullptr, g, t);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[sl][nb][e] += part[nb][e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (++slot == S) {
      slot = 0;
      phase ^= 1;
    }
  }
  const int key = k0 + row0 + g;
  float* dst = p.o + (static_cast<size_t>(batch) * p.sk + key) * p.c + head * p.d + col0;
#pragma unroll
  for (int sl = 0; sl < NS; ++sl)
    store_slab(dst + 32 * sl, p.c, acc[sl], 1.f, 1.f, true, true, t, p.d - col0 - 32 * sl);
}

// x*: maps of 64-row boxes (a block's rows: Q and dO in the dq kernel, K
// and V in the dk/dv kernels), y*: of kWideT-row boxes (a streamed tile's).
template <int OA>
int launch_bwd_wide(const CUtensorMap (&x)[4], const CUtensorMap (&y)[4], WideParamsF32 p,
                    float* dq, float* dk, float* dv, int batch, cudaStream_t st) {
  constexpr int dq_smem = wide_smem_bytes(attn_hopper::kMaxWideStages, false);
  constexpr int dkdv_smem = wide_smem_bytes(attn_hopper::kMaxWideStages, true);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attention_f32_dq_wide_kernel<OA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attention_f32_dkdv_wide_kernel<OA, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attention_f32_dkdv_wide_kernel<OA, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  p.o = dq;  // maps in the order q, dO, k, v
  attention_f32_dq_wide_kernel<OA><<<dim3(p.sq / 64 * p.chunks, p.heads, batch),
                                     kWideThreadsF32, dq_smem, st>>>(x[0], x[1], y[2], y[3], p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.sk / 64 * p.chunks, p.heads, batch);
  p.o = dv;
  attention_f32_dkdv_wide_kernel<OA, false>
      <<<grid, kWideThreadsF32, dkdv_smem, st>>>(y[0], y[1], x[2], x[3], p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  p.o = dk;
  attention_f32_dkdv_wide_kernel<OA, true>
      <<<grid, kWideThreadsF32, dkdv_smem, st>>>(y[0], y[1], x[2], x[3], p);
  return static_cast<int>(cudaGetLastError());
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
  WideParamsF32 p{};
  p.o_in = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse_in = static_cast<const float*>(lse);
  p.l2 = static_cast<float*>(delta);
  p.drow = p.l2 + static_cast<size_t>(batch) * heads * sq;
  p.sq = sq;
  p.sk = sk;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.atoms = head_atoms(d);
  p.chunks = attn_hopper::wide_chunks(p.atoms);
  p.stages = attn_hopper::kMaxWideStages;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(scale_dim)));
  p.scale_log2 = kLog2e * p.scale;
  auto* fq = static_cast<float*>(dq);
  auto* fk = static_cast<float*>(dk);
  auto* fv = static_cast<float*>(dv);
  return attn_hopper::wide_chunk_atoms(p.atoms) == 3
             ? launch_bwd_wide<3>(x, y, p, fq, fk, fv, batch, stream)
             : launch_bwd_wide<4>(x, y, p, fq, fk, fv, batch, stream);
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

// Shared memory each of the two kernels asks for at head dim d (0 for a d
// there is no kernel for).
int packed_attention_bwd_smem_bytes(int dkdv, int d) {
  if (!head_dim_ok(d, d)) return 0;
  switch (head_atoms(d)) {
    case 1: return dkdv ? BwdCfg<1>::kDkdvSmem : BwdCfg<1>::kDqSmem;
    case 2: return dkdv ? BwdCfg<2>::kDkdvSmem : BwdCfg<2>::kDqSmem;
    case 3: return dkdv ? BwdCfg<3>::kDkdvSmem : BwdCfg<3>::kDqSmem;
    case 4: return dkdv ? BwdCfg<4>::kDkdvSmem : BwdCfg<4>::kDqSmem;
    default: return wide_bwd_smem_bytes(dkdv != 0);  // the wide kernels (d > 256)
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

// Shared memory each of the two f32 kernels asks for at head dim d (0 for a
// d there is no kernel for).
int packed_attention_bwd_f32_smem_bytes(int dkdv, int d) {
  if (!attn_f32::head_dim_ok(d, d)) return 0;
  const int da = attn_f32::head_atoms(d);
  return da > kNarrowAtoms ? attn_f32::wide_smem_bytes(kMaxWideStages, dkdv != 0)
                           : attn_f32::bwd_smem_bytes(da, dkdv != 0);
}

const char* packed_attention_bwd_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
