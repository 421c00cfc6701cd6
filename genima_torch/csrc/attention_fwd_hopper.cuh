// The flash-attention forward for Hopper (sm_90a) on packed (B, S, heads * d)
// bf16 tensors, shared by B1/B2a (packed_attention.cu) and B3
// (flash_attention.cu).
//
// Computes softmax(Q_h K_h^T / sqrt(d)) V_h for every head h, non-causal, with an
// online softmax in f32, P rounded to bf16 before P V, keys at or past Sk
// masked to -1e30 and query rows at or past Sq never stored. With kWriteLse
// it also stores L = m + ln(l) per (row, head) into a (B, Sq, heads) f32
// tensor, the softmax normaliser the backward (packed_attention_bwd.cu)
// rebuilds P from. (B, S, H, d) is the packed (B, S, H * d) layout the
// projections emit, and a block reads head h as the d columns at offset
// h * d with row stride H * d: no (S, H, D) -> (H, S, D) transpose ever
// touches device memory.
//
// Head dims (attention_hopper.cuh): d, a multiple of 8 up to 256, is DA =
// ceil(d / 64) atoms of 64 columns, a template parameter; each Q, K and V
// tile is DA 64-column TMA boxes. The consumers zero Q's columns d..64 * DA
// in shared memory once a block, so S = Q K^T sums over the real d; O's
// extra columns are computed from V's and never stored. The scale
// 1/sqrt(scale_dim) follows the real head dim (d itself, or fewer columns
// that the wrapper zero-padded to d). d = 8..64 (DA = 1) runs every tile
// below; DA = 2, 3 (d = 72..192) take 64-key tiles (and B3's 80-key prompt
// tile) with one or two consumer warpgroups and one block an SM: a wider O
// accumulator (32 * DA registers a thread) and DA times the shared memory a
// stage. DA = 4 (d = 200..256) holds 128 f32 of O a thread: one consumer
// warpgroup and a one-warp producer (160 threads, so ptxas may give each
// thread 255 registers), 64-key tiles in a ring of three 64 KB stages, or
// B3's 80-key prompt tile in two. Heads of more than four atoms (d > 256)
// take the wide kernels below.
//
// Bound: 4 * B * Sq * Sk * C flops on 2 * B * (2 * Sq + 2 * Sk) * C bytes.
// Self-attention at 4096 and 1024 tokens is bound by tensor-core
// operations; cross-attention over 77 keys does 4 * 77 flops per q byte
// pair and is bound by reading q and writing o, where what costs is the
// fixed latency of a block (load Q, one K/V tile, store O).
//
// Design (FlashAttention-3-style, warp-specialised): one block per
// (64 * nwg query rows, head, batch), nwg = 1, 2 or 3 consumer warpgroups of
// 64 rows and a producer: a warpgroup when nwg > 1 (setmaxnreg moves
// registers by warpgroup), else one warp, so that short key loops, where a
// block's fixed latency dominates, fit two (128-key) or three (64-key)
// blocks on an SM, and a four-atom block's consumers may take 255
// registers.
//   * The producer's first thread TMA-loads the block's Q tile once, then
//     streams K and V tiles of bn keys (64, 80 or 128) through a ring of
//     `stages` stages behind "full" / "empty" mbarriers. The maps are 3-D
//     (C, S, B) with a (64, rows, 1) box at column head * d + 64 * atom, 128-byte
//     swizzled, so TMA zero-fills rows at or past S within the batch: a
//     ragged last tile never reads the next batch's keys.
//   * Each consumer warpgroup owns 64 rows of the Q tile. Per K/V tile:
//     S = Q K^T with wgmma m64n{bn}k16, both operands read K-major from
//     shared memory (Q from its tile, K from the stage). Q's fragments are
//     not held in registers across the loop: built that way, the 64-key
//     instantiations came out of the compiler with the P fragments in the
//     same registers (SASS), so every tile after the first multiplied P by
//     K. Keys at or past Sk are set to -1e30 in the last tile only; the
//     online softmax in base 2 on the accumulator; P rounded to bf16 A
//     fragments in place (the accumulator layout is the A layout); and
//     O += P V with wgmma m64n64k16 an atom, V read MN-major from the same
//     stage.
//     The P V group runs while the warpgroup waits for the next tile and
//     issues its S; a stage goes back to the producer once the group that
//     reads it has been retired.
//   * With two or three consumer warpgroups, setmaxnreg moves registers
//     from the producer warpgroup (24) to the consumers (240 or 160).
//   * Rows at or past Sq are computed on TMA's zeros and stored neither to
//     O nor to L: with Sq an odd multiple of 64 and 128-row blocks, the
//     rows past the last block's first half are the next batch's in the
//     contiguous (B, Sq, .) outputs, and the row guard is what keeps them.
// The wrappers' plans (kernels/flash_attention.py::plan,
// kernels/packed_attention.py::forward_plan) pick nwg, bn and the ring depth
// per shape (python -m genima_torch.tune_kernels {attn,packed}).

#pragma once

#include "attention_hopper.cuh"

namespace attn_hopper {

// Internal linkage: packed_attention.cu and flash_attention.cu are built into
// two libraries loaded into one process, and a function-local static of a
// template with external linkage (launch_fwd's `configured`) would be one
// object for both (a GNU unique symbol): one library's launch would then
// skip setting the shared-memory size of the other's kernel.
namespace {

constexpr float kLn2 = 0.6931471805599453f;

struct FwdParams {
  __nv_bfloat16* o;
  float* lse;  // (B, Sq, heads) f32, written only by the kWriteLse kernels
  int sq, sk, c, d, heads, n_tiles, stages;
  float scale_log2;
};

template <int DA, int NWG, int BN>
struct FwdCfg {
  static constexpr int kBM = 64 * NWG;  // query rows a block
  // the consumers, then the producer: a warpgroup where setmaxnreg moves
  // registers (it acts on whole warpgroups), else one warp
  static constexpr int kThreads = 128 * NWG + (NWG == 1 ? 32 : 128);
  static constexpr int kQAtom = kBM * kRowBytes;    // one atom of the Q tile
  static constexpr int kQBytes = DA * kQAtom;
  static constexpr int kKVAtom = BN * kRowBytes;    // one atom of a K or V tile (whole KB)
  static constexpr int kKVBytes = DA * kKVAtom;
  static constexpr int kStage = 2 * kKVBytes;
  // one 64-key tile's one-atom block fits three times on an SM (<= 136
  // registers)
  static constexpr int kMinBlocks = DA == 1 && NWG == 1 && BN == 64 ? 3 : 1;
  // registers a consumer thread takes from the producer warpgroup's 24
  // (NWG > 1; a one-warpgroup block of 160 threads needs no setmaxnreg)
  static constexpr int kConsumerRegs = NWG == 2 ? 240 : 160;
  static_assert(DA <= 4 && (DA < 4 || NWG == 1), "four atoms: one consumer warpgroup");
};

// Dynamic shared memory of a block: alignment slack, the Q tile, the K/V
// ring and its barriers.
int fwd_smem_bytes(int nwg, int bn, int stages, int atoms) {
  return 1024 + 64 * nwg * kRowBytes * atoms + stages * 2 * bn * kRowBytes * atoms +
         16 * stages + 16;
}

template <int DA, int NWG, int BN, bool kWriteLse>
__global__ void __launch_bounds__(FwdCfg<DA, NWG, BN>::kThreads, FwdCfg<DA, NWG, BN>::kMinBlocks)
attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const FwdParams p) {
  using namespace hopper;
  using C = FwdCfg<DA, NWG, BN>;
  constexpr int kS = BN / 2;    // score accumulator values a thread
  constexpr int kKS = BN / 16;  // k-steps of P V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* q_tile = smem;
  uint8_t* ring = smem + C::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * C::kStage);
  uint64_t* empty = full + p.stages;
  uint64_t* q_full = empty + p.stages;

  const int q0 = blockIdx.x * C::kBM;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= 4 * NWG) {  // the producer; its first thread issues every load
    if constexpr (NWG >= 2) setmaxnreg_dec<24>();
    if (warp == 4 * NWG && lane == 0) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      const int col = head * p.d;
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int a = 0; a < DA; ++a)
        tma_load_3d(q_tile + a * C::kQAtom, &map_q, q_full, col + a * kAtom, q0, batch);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < p.n_tiles; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * C::kStage;
        mbar_expect_tx(&full[stage], C::kStage);
#pragma unroll
        for (int a = 0; a < DA; ++a) {
          tma_load_3d(st + a * C::kKVAtom, &map_k, &full[stage], col + a * kAtom, j * BN, batch);
          tma_load_3d(st + C::kKVBytes + a * C::kKVAtom, &map_v, &full[stage], col + a * kAtom,
                      j * BN, batch);
        }
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if constexpr (NWG >= 2) setmaxnreg_inc<C::kConsumerRegs>();
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;

  mbar_wait(q_full, 0);
  // this warpgroup's 64 rows (of each atom, C::kQAtom apart)
  uint8_t* q_rows = q_tile + wg * 64 * kRowBytes;
  const int tail = p.d - (DA - 1) * kAtom;  // real columns of the last atom
  if (tail < kAtom) {  // the next head's columns (or TMA's zeros past C): zero them
    zero_tail(q_rows + (DA - 1) * C::kQAtom, 64, tail, threadIdx.x & 127, 128);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }

  float o[32 * DA];
#pragma unroll
  for (int i = 0; i < 32 * DA; ++i) o[i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  uint32_t pf[kKS][4];
#pragma unroll
  for (int k = 0; k < kKS; ++k) pf[k][0] = pf[k][1] = pf[k][2] = pf[k][3] = 0u;
  fence_operands(o);

  int stage = 0;
  uint32_t phase = 0;
  int prev = -1;  // the stage the P V group in flight reads
  for (int j = 0; j < p.n_tiles; ++j) {
    mbar_wait(&full[stage], phase);
    const uint8_t* ks = ring + stage * C::kStage;
    const uint8_t* vs = ks + C::kKVBytes;

    float s[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) s[i] = 0.f;
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < DA; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<BN, 0>(s, desc_k(q_rows + a * C::kQAtom, kk), desc_k(ks + a * C::kKVAtom, kk));
    wgmma_commit();
    fence_operands(s);
    wgmma_wait<0>();  // S, and the previous tile's P V
    fence_operands(s);
    fence_operands(o);
    fence_frags(pf);
    if (prev >= 0 && wq == 0 && lane == 0) mbar_arrive(&empty[prev]);

    const int kv0 = j * BN;
    if (kv0 + BN > p.sk) {  // the ragged last tile: keys >= Sk
#pragma unroll
      for (int i = 0; i < kS; ++i)
        if (kv0 + 8 * (i >> 2) + 2 * t + (i & 1) >= p.sk) s[i] = kMasked;
    }

    // online softmax in base 2: rows g (r = 0) and g + 8 (r = 1); row_max is
    // kept pre-scaled, so p = 2^(s * scale - max) is one FFMA and one EX2
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kS; ++i) tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 2));
      const float m_new = fmaxf(row_max[r], tile_max[r] * p.scale_log2);
      alpha[r] = exp2_approx(row_max[r] - m_new);
      row_max[r] = m_new;
      row_sum[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2_approx(fmaf(s[i], p.scale_log2, -row_max[r]));
      row_sum[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < 32 * DA; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) acc_to_a(pf[kk], s, kk);
    fence_frags(pf);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < DA; ++a)
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
        wgmma_rs<64, 1>(o + 32 * a, pf[kk], desc_mn(vs + a * C::kKVAtom, kk));
    wgmma_commit();
    fence_operands(o);
    prev = stage;
    if (++stage == p.stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(o);
  fence_frags(pf);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 2);
  }
  const int row0 = q0 + wg * 64 + wq * 16;
  __nv_bfloat16* rows = p.o + (static_cast<size_t>(batch) * p.sq + row0) * p.c + head * p.d;
#pragma unroll
  for (int a = 0; a < DA; ++a)
    store_acc(rows + a * kAtom, p.c, o + 32 * a, 1.f / row_sum[0], 1.f / row_sum[1],
              row0 + g < p.sq, row0 + g + 8 < p.sq, g, t, p.d - a * kAtom);
  if constexpr (kWriteLse) {
    // L = m + ln(l) in natural-log units: row_max is m * log2(e)
    if (t == 0) {
      const int heads = p.heads;
      float* l0 = p.lse + (static_cast<size_t>(batch) * p.sq + row0 + g) * heads + head;
      if (row0 + g < p.sq) l0[0] = (row_max[0] + log2f(row_sum[0])) * kLn2;
      if (row0 + g + 8 < p.sq)
        l0[static_cast<size_t>(8) * heads] = (row_max[1] + log2f(row_sum[1])) * kLn2;
    }
  }
}

template <int DA, int NWG, int BN, bool kWriteLse>
int launch_fwd(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
               const FwdParams& p, int batch, cudaStream_t stream) {
  using C = FwdCfg<DA, NWG, BN>;
  const int smem = fwd_smem_bytes(NWG, BN, p.stages, DA);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(attention_fwd_kernel<DA, NWG, BN, kWriteLse>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((p.sq + C::kBM - 1) / C::kBM, p.heads, batch);
  attention_fwd_kernel<DA, NWG, BN, kWriteLse><<<grid, C::kThreads, smem, stream>>>(mq, mk, mv,
                                                                                    p);
  return static_cast<int>(cudaGetLastError());
}

// A (C, S, B) map of a packed (B, S, C) bf16 tensor with a (64, rows, 1) box.
int seq_map(CUtensorMap* map, const void* x, int batch, int s, int c, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * 2,
                                 static_cast<cuuint64_t>(s) * c * 2};
  const cuuint32_t box[3] = {kAtom, static_cast<cuuint32_t>(rows), 1};
  return hopper_host::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

// The three maps and the parameters of one launch of the (nwg, bn) kernel
// on heads of d columns, scaled by 1 / sqrt(scale_dim), with a ring of
// `stages`; 0, or an error code for a launch that cannot be made.
int prepare_fwd(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv, FwdParams* p, const void* q,
                const void* k, const void* v, void* o, float* lse, int batch, int sq, int sk,
                int heads, int d, int scale_dim, int nwg, int bn, int stages) {
  if (sq < 1 || sk < 1 || !head_dim_ok(d, scale_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = heads * d;
  int rc = seq_map(mq, q, batch, sq, c, 64 * nwg);
  if (rc) return rc;
  if ((rc = seq_map(mk, k, batch, sk, c, bn))) return rc;
  if ((rc = seq_map(mv, v, batch, sk, c, bn))) return rc;
  p->o = static_cast<__nv_bfloat16*>(o);
  p->lse = lse;
  p->sq = sq;
  p->sk = sk;
  p->c = c;
  p->d = d;
  p->heads = heads;
  p->n_tiles = (sk + bn - 1) / bn;
  p->stages = stages;
  // log2(e) / sqrt(scale_dim), rounded once (at 64: kLog2e / 8 exactly)
  p->scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(scale_dim)));
  // a stage goes back to the producer only once the next tile has arrived:
  // more than one tile needs two stages
  if (stages < (p->n_tiles > 1 ? 2 : 1)) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// --- the wide forwards' key split --------------------------------------------
//
// Where a wide forward's grid is short, its keys are split `splits` ways
// (1 to kMaxSplits), each split a contiguous range of key tiles
// (split_begin) and its own block; the splits of one output tile are the
// CTAs of a thread-block cluster (rank = split). At the end each block
// leaves its O (unnormalised), m and l in its ring, consumer thread by
// thread, as float4s, and after a cluster barrier merges a share of the
// atoms over the splits in split order (m = max, l and O rescaled by
// 2^(m_s - m) and summed), reading its peers' through distributed shared
// memory, once a launch: the result does not depend on timing, and B2a
// writes one L a row from the merged m and l.

constexpr int kMaxSplits = 4;  // key ranges a launch: CTAs a cluster

// The merge, by the kThreads consumer threads of a block (ct its thread, its
// O the OA atoms `o` starting at atom `atom0` of its output, rows at `rows`
// with row stride ld and columns d_left = d - that atom's first column left):
// O, m and l (row_max, row_sum after their quad sums) into `area`, a cluster
// barrier, then atom a merged and stored by split (atom0 + a) % splits; m
// and l come back merged. The caller's other threads run cluster_sync once
// while this runs.
template <int OA, int kThreads>
__device__ __forceinline__ void merge_splits(const float* o, const float (&row_max)[2],
                                             const float (&row_sum)[2], uint8_t* area, int ct,
                                             int split, int splits, int atom0,
                                             __nv_bfloat16* rows, int ld, bool ok0, bool ok8,
                                             int g, int t, int d_left, float (&m)[2],
                                             float (&l)[2]) {
  float4* mine = reinterpret_cast<float4*>(area);
  const uint32_t area_addr = hopper::smem_u32(area);
  hopper::named_barrier(1, kThreads);  // every consumer is done with the ring
#pragma unroll
  for (int k = 0; k < 8 * OA; ++k)
    mine[k * kThreads + ct] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
  mine[8 * OA * kThreads + ct] = make_float4(row_max[0], row_max[1], row_sum[0], row_sum[1]);
  cluster_sync();
  // the splits' m, l in split order: m the max, l rescaled and summed
  float f[kMaxSplits][2];  // each split's rescale 2^(m_s - m), rows g and g + 8
  float ms[kMaxSplits][2], ls[kMaxSplits][2];
#pragma unroll
  for (int s2 = 0; s2 < kMaxSplits; ++s2) {
    if (s2 >= splits) continue;
    const float4 v =
        s2 == split ? make_float4(row_max[0], row_max[1], row_sum[0], row_sum[1])
                    : ld_cluster(map_rank(area_addr + (8 * OA * kThreads + ct) * 16, s2));
    ms[s2][0] = v.x, ms[s2][1] = v.y, ls[s2][0] = v.z, ls[s2][1] = v.w;
    m[0] = s2 == 0 ? v.x : fmaxf(m[0], v.x);
    m[1] = s2 == 0 ? v.y : fmaxf(m[1], v.y);
  }
#pragma unroll
  for (int s2 = 0; s2 < kMaxSplits; ++s2) {
    if (s2 >= splits) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      f[s2][r] = exp2_approx(ms[s2][r] - m[r]);
      l[r] = s2 == 0 ? ls[s2][r] * f[s2][r] : fmaf(ls[s2][r], f[s2][r], l[r]);
    }
  }
#pragma unroll
  for (int a = 0; a < OA; ++a) {
    if ((atom0 + a) % splits != split) continue;
    float acc[32];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      const int e = 8 * a + k;  // float4 e of the thread's O
#pragma unroll
      for (int s2 = 0; s2 < kMaxSplits; ++s2) {
        if (s2 >= splits) continue;
        const float4 v = s2 == split
                             ? make_float4(o[4 * e], o[4 * e + 1], o[4 * e + 2], o[4 * e + 3])
                             : ld_cluster(map_rank(area_addr + (e * kThreads + ct) * 16, s2));
        // elements 4e..4e+3: rows g, g, g + 8, g + 8
        const float f0 = f[s2][0], f8 = f[s2][1];
        sum = s2 == 0 ? make_float4(v.x * f0, v.y * f0, v.z * f8, v.w * f8)
                      : make_float4(fmaf(v.x, f0, sum.x), fmaf(v.y, f0, sum.y),
                                    fmaf(v.z, f8, sum.z), fmaf(v.w, f8, sum.w));
      }
      acc[4 * k] = sum.x, acc[4 * k + 1] = sum.y, acc[4 * k + 2] = sum.z, acc[4 * k + 3] = sum.w;
    }
    store_acc(rows + a * kAtom, ld, acc, 1.f / l[0], 1.f / l[1], ok0, ok8, g, t,
              d_left - a * kAtom);
  }
}

// --- heads of more than four atoms (d > 256) --------------------------------
//
// attention_fwd_wide_kernel: a fifth atom of O would hold 160 f32 a thread
// beside S and P, so a block keeps O for one chunk of OA = 3 or 4 atoms
// (wide_chunk_atoms) and the grid walks the chunks: one block per (64 query
// rows, chunk, head, batch). S's registers do not depend on d, so each block
// sums S = Q K^T over every atom of the head, runs the online softmax, and
// accumulates O += P V for its own chunk's columns only; every chunk forms the
// same S, m and l (bit for bit: the same wgmmas in the same order), and chunk
// 0 alone stores L. That forms Q K^T once per chunk: at d = 512 (two chunks of
// four) 1.5x the forward's flops of one pass.
//   * Nothing of the head is resident: the producer warp's first thread
//     streams, per 64-key tile, ceil(atoms / 2) "S items" (Q's and K's tiles
//     of two atoms, 64 rows x 64 columns each) and one "V item" (V's tiles
//     of the chunk's atoms) through one ring of 32 KB slots behind "full" /
//     "empty" mbarriers, so shared memory does not grow with d. The maps are
//     4-D (d, heads, S, B) (head_map): columns past d and rows past S come in
//     as zeros, so the sums over d need no masking and an odd atom count's
//     last S item adds zeros.
//   * One consumer warpgroup of 64 rows (160 threads: it may take 255
//     registers): per S item, wgmma m64n64k16 with both operands K-major in
//     the slot, committed as a group; once the group before it is retired its
//     slot goes back (the V item of the tile before, at the first S item). The
//     online softmax as the narrow kernel's; P as A fragments in registers;
//     O += P V for the chunk's atoms, V MN-major, runs under the next tile's
//     first S item.
//   * Where the grid is short, the keys are split (merge_splits above): one
//     block per (64 query rows, chunk, key range, head, batch), the ranges of
//     one (rows, chunk) a cluster. The variant without the merge (kSplit
//     false) keeps the kernel's 170 and 202 registers at three and four
//     atoms; with the merge compiled in it takes 235-255.
// Bound as the narrow kernel; the price of streaming is Q re-read from L2 for
// every key tile (and each chunk's S), which holds it under the narrow
// kernels' share of the tensor-core peak. Five- and six-atom heads over more
// than two key tiles take the paired kernel below instead.

struct WideFwdParams {
  __nv_bfloat16* o;
  float* lse;  // (B, Sq, heads) f32, written only by the kWriteLse kernels (chunk 0)
  int sq, sk, c, d, heads, atoms, chunks, splits, n_tiles, stages;
  float scale_log2;
};

constexpr int kWideThreads = 160;  // one consumer warpgroup and the producer warp
constexpr int kAtomTile = 64 * kRowBytes;  // 64 rows x one atom: 8 KB

int wide_fwd_smem_bytes(int stages) { return 1024 + stages * kWideSlot + 16 * stages; }

template <int OA, bool kWriteLse, bool kSplit>
__global__ void __launch_bounds__(kWideThreads, 1)
attention_fwd_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const WideFwdParams p) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kWideSlot);
  uint64_t* empty = full + p.stages;

  // the key range (the rank in the cluster) and the (query tile, chunk) block
  const int split = kSplit ? blockIdx.x % p.splits : 0;
  const int block = kSplit ? blockIdx.x / p.splits : blockIdx.x;
  const int chunk = block % p.chunks;
  const int q0 = block / p.chunks * 64;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int s_items = (p.atoms + 1) / 2;
  const int col0 = chunk * OA * kAtom;  // the chunk's first column
  const int t0 = kSplit ? split_begin(split, p.n_tiles, p.splits) : 0;
  const int t1 = kSplit ? split_begin(split + 1, p.n_tiles, p.splits) : p.n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == 4) {  // the producer; its first thread issues every load
    if (lane == 0) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      int slot = 0;
      uint32_t phase = 0;
      const auto next = [&] {
        if (++slot == p.stages) {
          slot = 0;
          phase ^= 1;
        }
      };
      for (int j = t0; j < t1; ++j) {
        for (int i = 0; i < s_items; ++i) {
          mbar_wait(&empty[slot], phase ^ 1);
          uint8_t* st = ring + slot * kWideSlot;
          mbar_expect_tx(&full[slot], kWideSlot);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = (2 * i + h) * kAtom;
            tma_load_4d(st + 2 * h * kAtomTile, &map_q, &full[slot], col, head, q0, batch);
            tma_load_4d(st + (2 * h + 1) * kAtomTile, &map_k, &full[slot], col, head, j * 64,
                        batch);
          }
          next();
        }
        mbar_wait(&empty[slot], phase ^ 1);
        uint8_t* st = ring + slot * kWideSlot;
        mbar_expect_tx(&full[slot], OA * kAtomTile);
#pragma unroll
        for (int a = 0; a < OA; ++a)
          tma_load_4d(st + a * kAtomTile, &map_v, &full[slot], col0 + a * kAtom, head, j * 64,
                      batch);
        next();
      }
    }
    if constexpr (kSplit) {  // the consumers' merge
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int wq = warp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool arrives = wq == 0 && lane == 0;

  float o[32 * OA];
#pragma unroll
  for (int i = 0; i < 32 * OA; ++i) o[i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  uint32_t pf[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) pf[k][0] = pf[k][1] = pf[k][2] = pf[k][3] = 0u;
  fence_operands(o);

  int slot = 0;
  uint32_t phase = 0;
  int held = -1;  // the slot the last committed group reads
  for (int j = t0; j < t1; ++j) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_operands(s);
    for (int i = 0; i < s_items; ++i) {
      mbar_wait(&full[slot], phase);
      const uint8_t* st = ring + slot * kWideSlot;
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<64, 0>(s, desc_k(st + 2 * h * kAtomTile, kk),
                          desc_k(st + (2 * h + 1) * kAtomTile, kk));
      wgmma_commit();
      fence_operands(s);
      wgmma_wait<1>();  // the group before this one (the tile before's P V at i = 0)
      fence_operands(s);
      if (held >= 0 && arrives) mbar_arrive(&empty[held]);
      held = slot;
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(o);
    fence_frags(pf);
    if (arrives) mbar_arrive(&empty[held]);

    const int kv0 = j * 64;
    if (kv0 + 64 > p.sk) {  // the ragged last tile: keys >= Sk
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kv0 + 8 * (i >> 2) + 2 * t + (i & 1) >= p.sk) s[i] = kMasked;
    }
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 2));
      const float m_new = fmaxf(row_max[r], tile_max[r] * p.scale_log2);
      alpha[r] = exp2_approx(row_max[r] - m_new);
      row_max[r] = m_new;
      row_sum[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2_approx(fmaf(s[i], p.scale_log2, -row_max[r]));
      row_sum[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < 32 * OA; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pf[kk], s, kk);

    mbar_wait(&full[slot], phase);  // the chunk's V
    const uint8_t* vs = ring + slot * kWideSlot;
    fence_frags(pf);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < OA; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64, 1>(o + 32 * a, pf[kk], desc_mn(vs + a * kAtomTile, kk));
    wgmma_commit();
    fence_operands(o);
    held = slot;
    if (++slot == p.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(o);
  fence_frags(pf);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 2);
  }
  const int row0 = q0 + wq * 16;
  __nv_bfloat16* rows =
      p.o + (static_cast<size_t>(batch) * p.sq + row0) * p.c + head * p.d + col0;
  const bool ok0 = row0 + g < p.sq, ok8 = row0 + g + 8 < p.sq;
  float m[2] = {row_max[0], row_max[1]}, l[2] = {row_sum[0], row_sum[1]};
  if constexpr (kSplit) {  // the ring is idle: every load has been consumed
    merge_splits<OA, 128>(o, row_max, row_sum, ring, threadIdx.x, split, p.splits, 0, rows, p.c,
                          ok0, ok8, g, t, p.d - col0, m, l);
  } else {
#pragma unroll
    for (int a = 0; a < OA; ++a)
      store_acc(rows + a * kAtom, p.c, o + 32 * a, 1.f / l[0], 1.f / l[1], ok0, ok8, g, t,
                p.d - col0 - a * kAtom);
  }
  if constexpr (kWriteLse) {
    if (chunk == 0 && split == 0 && t == 0) {
      float* l0 = p.lse + (static_cast<size_t>(batch) * p.sq + row0 + g) * p.heads + head;
      if (ok0) l0[0] = (m[0] + log2f(l[0])) * kLn2;
      if (ok8) l0[static_cast<size_t>(8) * p.heads] = (m[1] + log2f(l[1])) * kLn2;
    }
  }
  if constexpr (kSplit) cluster_sync();  // no block leaves while a peer may still read its ring
}

template <int OA, bool kWriteLse, bool kSplit>
int launch_fwd_wide(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                    const WideFwdParams& p, int batch, cudaStream_t stream) {
  const int smem = wide_fwd_smem_bytes(p.stages);
  const auto kernel = attention_fwd_wide_kernel<OA, kWriteLse, kSplit>;
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((p.sq + 63) / 64 * p.chunks * p.splits, p.heads, batch);
  if constexpr (kSplit) {
    return launch_clustered(kernel, grid, kWideThreads, smem, p.splits, stream, mq, mk, mv, p);
  } else {
    kernel<<<grid, kWideThreads, smem, stream>>>(mq, mk, mv, p);
    return static_cast<int>(cudaGetLastError());
  }
}

// --- heads of five or six atoms (d = 264..384): the paired kernel ----------
//
// attention_fwd_pair_kernel: one block per (64 query rows, key range, head,
// batch) holds O for the whole head: two consumer warpgroups of the same 64
// rows, each owning three of the six atoms of O (96 f32 a thread, where a
// block of one warpgroup would need 192). Each warpgroup forms S = Q K^T
// over all six atoms itself (wgmma m64n64k16, both operands K-major in
// shared memory: Q resident, loaded once; the ring's K item), the same
// wgmmas in the same order, so both hold the same S, m and l bit for bit;
// the online softmax, P as A fragments in registers and O += P V for the
// warpgroup's atoms (the ring's V item) as the narrow kernel's, P V under
// the next tile's S. The two warpgroups share every K and V load and never
// wait for each other. A producer warpgroup, whose first thread issues every
// TMA load (Q once, then per key tile a K item and a V item of the six atoms
// of 64 keys, 48 KB each, through a ring of three), gives its registers to
// the consumers (setmaxnreg: 24 and 240).
//   Measured against it on the H100: summing two partial S of three
// atoms through shared memory behind a barrier a tile was 1-12% slower;
// chunks of O in the CTAs of a cluster exchanging partial S (16 KB a peer a
// key tile over the SM-to-SM network, ~1.5 us a peer) twice the streaming
// kernel's time.
//   Where the grid is short (the plan's why_short: 1x4096 in one head gives
// 64 blocks), the keys are split (merge_splits above: the splits of a query
// tile the CTAs of one cluster, merging O, m and l once, the (warpgroup,
// atom) pairs shared out over the splits; B2a writes one L a row, split 0).
// Bound as the narrow kernel: the tensor-core operations of one pass over
// the six atoms (d = 264 and 320 compute on 1.45x and 1.2x the columns they
// need: the sixth atom is TMA's zeros), S formed twice; a block reads K and
// V of every atom from L2 once a key tile, 403 MB a call at 1x4096 and
// d = 320.

constexpr int kPairAtoms = 3;  // atoms of O a consumer warpgroup
constexpr int kPairThreads = 384;  // two consumer warpgroups and the producer warpgroup
constexpr int kPairItem = 2 * kPairAtoms * kAtomTile;  // a K or V item: six atoms of 64 keys

struct PairFwdParams {
  __nv_bfloat16* o;
  float* lse;  // (B, Sq, heads) f32, written only by the kWriteLse kernels
  int sq, sk, c, d, heads, splits, n_tiles, stages;
  float scale_log2;
};

// Dynamic shared memory of a paired block: alignment slack, Q's six atoms,
// the ring of `stages` items, and the barriers (full and empty a slot, Q's).
inline int pair_fwd_smem_bytes(int stages) {
  return 1024 + (1 + stages) * kPairItem + 8 * (2 * stages + 1);
}

// The ring's depth: as many slots as shared memory leaves (three; mirrored by
// kernels/flash_attention.py::pair_stages).
inline int pair_fwd_stages() {
  int s = kMaxWideStages;
  while (s > 2 && pair_fwd_smem_bytes(s) > 232448) --s;
  return s;
}

template <bool kWriteLse, bool kSplit>
__global__ void __launch_bounds__(kPairThreads, 1)
attention_fwd_pair_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const PairFwdParams p) {
  using namespace hopper;
  constexpr int OA = kPairAtoms;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = align1024(smem_raw);
  uint8_t* ring = q_tile + kPairItem;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kPairItem);
  uint64_t* empty = full + p.stages;
  uint64_t* q_full = empty + p.stages;

  const int split = blockIdx.x % p.splits;  // the key range (the rank in the cluster)
  const int q0 = blockIdx.x / p.splits * 64;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int t0 = split_begin(split, p.n_tiles, p.splits);
  const int tiles = split_begin(split + 1, p.n_tiles, p.splits) - t0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // each consumer warpgroup
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {  // the producer warpgroup
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {  // its first thread issues every load
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      mbar_expect_tx(q_full, kPairItem);
#pragma unroll
      for (int a = 0; a < 2 * OA; ++a)
        tma_load_4d(q_tile + a * kAtomTile, &map_q, q_full, a * kAtom, head, q0, batch);
      int slot = 0;
      uint32_t phase = 0;
      for (int j = t0; j < t0 + tiles; ++j)
        for (int kv = 0; kv < 2; ++kv) {  // the K item, then the V item
          mbar_wait(&empty[slot], phase ^ 1);
          uint8_t* st = ring + slot * kPairItem;
          mbar_expect_tx(&full[slot], kPairItem);
#pragma unroll
          for (int a = 0; a < 2 * OA; ++a)
            tma_load_4d(st + a * kAtomTile, kv ? &map_v : &map_k, &full[slot], a * kAtom, head,
                        j * 64, batch);
          if (++slot == p.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
    }
    if constexpr (kSplit) {  // the consumers' merge
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp >> 2;            // the warpgroup: its atoms 3 wg .. 3 wg + 2
  const int tid = threadIdx.x & 127;   // within the warpgroup
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + (warp & 3) * 16;
  const int col0 = wg * OA * kAtom;  // the warpgroup's first column
  float o[32 * OA];
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  {
    const bool arrives = (warp & 3) == 0 && lane == 0;
#pragma unroll
    for (int i = 0; i < 32 * OA; ++i) o[i] = 0.f;
    uint32_t pf[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) pf[k][0] = pf[k][1] = pf[k][2] = pf[k][3] = 0u;
    fence_operands(o);
    mbar_wait(q_full, 0);

    int slot = 0;
    uint32_t phase = 0;
    int held = -1;  // the slot of the V item the P V group in flight reads
    for (int jj = 0; jj < tiles; ++jj) {
      mbar_wait(&full[slot], phase);  // the K item
      const uint8_t* ks = ring + slot * kPairItem;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < 2 * OA; ++a)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<64, 0>(s, desc_k(q_tile + a * kAtomTile, kk), desc_k(ks + a * kAtomTile, kk));
      wgmma_commit();
      fence_operands(s);
      wgmma_wait<0>();  // S over the six atoms, and the tile before's P V
      fence_operands(s);
      fence_operands(o);
      fence_frags(pf);
      if (arrives) {
        mbar_arrive(&empty[slot]);
        if (held >= 0) mbar_arrive(&empty[held]);
      }
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }

      const int kv0 = (t0 + jj) * 64;
      if (kv0 + 64 > p.sk) {  // the ragged last tile: keys >= Sk
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (kv0 + 8 * (i >> 2) + 2 * t + (i & 1) >= p.sk) s[i] = kMasked;
      }
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], s[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 1));
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 2));
        const float m_new = fmaxf(row_max[r], tile_max[r] * p.scale_log2);
        alpha[r] = exp2_approx(row_max[r] - m_new);
        row_max[r] = m_new;
        row_sum[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2_approx(fmaf(s[i], p.scale_log2, -row_max[r]));
        row_sum[r] += s[i];
      }
#pragma unroll
      for (int i = 0; i < 32 * OA; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(pf[kk], s, kk);

      mbar_wait(&full[slot], phase);  // the V item
      const uint8_t* vs = ring + slot * kPairItem + wg * OA * kAtomTile;
      fence_frags(pf);
      fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < OA; ++a)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<64, 1>(o + 32 * a, pf[kk], desc_mn(vs + a * kAtomTile, kk));
      wgmma_commit();
      fence_operands(o);
      held = slot;
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(o);
    fence_frags(pf);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 2);
    }
  }

  __nv_bfloat16* rows =
      p.o + (static_cast<size_t>(batch) * p.sq + row0) * p.c + head * p.d + col0;
  const bool ok0 = row0 + g < p.sq, ok8 = row0 + g + 8 < p.sq;
  float m[2] = {row_max[0], row_max[1]}, l[2] = {row_sum[0], row_sum[1]};
  if constexpr (kSplit) {  // the ring is idle: every load has been consumed
    merge_splits<OA, 256>(o, row_max, row_sum, ring, threadIdx.x, split, p.splits, OA * wg, rows,
                          p.c, ok0, ok8, g, t, p.d - col0, m, l);
  } else {
#pragma unroll
    for (int a = 0; a < OA; ++a)
      store_acc(rows + a * kAtom, p.c, o + 32 * a, 1.f / l[0], 1.f / l[1], ok0, ok8, g, t,
                p.d - col0 - a * kAtom);
  }
  if constexpr (kWriteLse) {
    if (wg == 0 && split == 0 && t == 0) {
      float* l0 = p.lse + (static_cast<size_t>(batch) * p.sq + row0 + g) * p.heads + head;
      if (ok0) l0[0] = (m[0] + log2f(l[0])) * kLn2;
      if (ok8) l0[static_cast<size_t>(8) * p.heads] = (m[1] + log2f(l[1])) * kLn2;
    }
  }
  if constexpr (kSplit) cluster_sync();  // no block leaves while a peer may still read it
}

template <bool kWriteLse, bool kSplit>
int launch_fwd_pair(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                    const PairFwdParams& p, int batch, cudaStream_t stream) {
  const int smem = pair_fwd_smem_bytes(p.stages);
  const auto kernel = attention_fwd_pair_kernel<kWriteLse, kSplit>;
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((p.sq + 63) / 64 * p.splits, p.heads, batch);
  if constexpr (kSplit) {
    return launch_clustered(kernel, grid, kPairThreads, smem, p.splits, stream, mq, mk, mv, p);
  } else {
    kernel<<<grid, kPairThreads, smem, stream>>>(mq, mk, mv, p);
    return static_cast<int>(cudaGetLastError());
  }
}

// Whether heads of `atoms` atoms may take the paired kernel: five or six.
inline bool paired(int atoms) { return atoms > kNarrowAtoms && atoms <= 2 * kPairAtoms; }

// Shared memory a wide forward launch of (nwg, bn) asks for at head dim d
// with `stages` (0 for a launch there is no kernel for): the paired
// kernel's (2, 64) at five or six atoms, its ring as deep as
// pair_fwd_stages gives; the streaming kernel's (1, 64), 2 to
// kMaxWideStages slots.
inline int wide_launch_smem(int nwg, int bn, int d, int stages) {
  if (bn != 64) return 0;
  if (nwg == 2)
    return paired(head_atoms(d)) && stages == pair_fwd_stages() ? pair_fwd_smem_bytes(stages) : 0;
  return nwg == 1 && stages >= 2 && stages <= kMaxWideStages ? wide_fwd_smem_bytes(stages) : 0;
}

// The wide forward (heads of more than four atoms: d > 256, a multiple of
// 8) with the plan's (nwg, bn, stages) and its keys split `splits` ways (1
// to kMaxSplits, a key tile each at least): (2, 64) the paired kernel, (1,
// 64) the streaming kernel. 0 or an error code.
template <bool kWriteLse>
int forward_wide(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                 int sq, int sk, int heads, int d, int scale_dim, int nwg, int bn, int stages,
                 int splits, cudaStream_t stream) {
  const int atoms = head_atoms(d), n_tiles = (sk + 63) / 64;
  if (batch < 1 || sq < 1 || sk < 1 || heads < 1 || !head_dim_ok(d, scale_dim) ||
      atoms <= kNarrowAtoms || wide_launch_smem(nwg, bn, d, stages) == 0 ||
      splits < 1 || splits > kMaxSplits || splits > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int rc = head_map(&mq, q, batch, sq, heads, d, 64);
  if (rc) return rc;
  if ((rc = head_map(&mk, k, batch, sk, heads, d, 64))) return rc;
  if ((rc = head_map(&mv, v, batch, sk, heads, d, 64))) return rc;
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(scale_dim)));
  const bool split = splits > 1;
  if (nwg == 2) {
    PairFwdParams p;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.lse = lse;
    p.sq = sq;
    p.sk = sk;
    p.c = heads * d;
    p.d = d;
    p.heads = heads;
    p.splits = splits;
    p.n_tiles = n_tiles;
    p.stages = stages;
    p.scale_log2 = scale_log2;
    return split ? launch_fwd_pair<kWriteLse, true>(mq, mk, mv, p, batch, stream)
                 : launch_fwd_pair<kWriteLse, false>(mq, mk, mv, p, batch, stream);
  }
  WideFwdParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.sq = sq;
  p.sk = sk;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.atoms = atoms;
  p.chunks = wide_chunks(atoms);
  p.splits = splits;
  p.n_tiles = n_tiles;
  p.stages = stages;
  p.scale_log2 = scale_log2;
  if (wide_chunk_atoms(atoms) == 3)
    return split ? launch_fwd_wide<3, kWriteLse, true>(mq, mk, mv, p, batch, stream)
                 : launch_fwd_wide<3, kWriteLse, false>(mq, mk, mv, p, batch, stream);
  return split ? launch_fwd_wide<4, kWriteLse, true>(mq, mk, mv, p, batch, stream)
               : launch_fwd_wide<4, kWriteLse, false>(mq, mk, mv, p, batch, stream);
}

}  // namespace
}  // namespace attn_hopper
