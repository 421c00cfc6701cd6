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
// take the wide kernel below.
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
// Bound as the narrow kernel; the price of streaming is Q re-read from L2 for
// every key tile (and each chunk's S), which holds it under the narrow
// kernels' share of the tensor-core peak.

struct WideFwdParams {
  __nv_bfloat16* o;
  float* lse;  // (B, Sq, heads) f32, written only by the kWriteLse kernels (chunk 0)
  int sq, sk, c, d, heads, atoms, chunks, n_tiles, stages;
  float scale_log2;
};

constexpr int kWideThreads = 160;  // one consumer warpgroup and the producer warp
constexpr int kAtomTile = 64 * kRowBytes;  // 64 rows x one atom: 8 KB

int wide_fwd_smem_bytes(int stages) { return 1024 + stages * kWideSlot + 16 * stages; }

template <int OA, bool kWriteLse>
__global__ void __launch_bounds__(kWideThreads, 1)
attention_fwd_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const WideFwdParams p) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kWideSlot);
  uint64_t* empty = full + p.stages;

  const int chunk = blockIdx.x % p.chunks;
  const int q0 = blockIdx.x / p.chunks * 64;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int s_items = (p.atoms + 1) / 2;
  const int col0 = chunk * OA * kAtom;  // the chunk's first column

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
      for (int j = 0; j < p.n_tiles; ++j) {
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
  for (int j = 0; j < p.n_tiles; ++j) {
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
#pragma unroll
  for (int a = 0; a < OA; ++a)
    store_acc(rows + a * kAtom, p.c, o + 32 * a, 1.f / row_sum[0], 1.f / row_sum[1],
              row0 + g < p.sq, row0 + g + 8 < p.sq, g, t, p.d - col0 - a * kAtom);
  if constexpr (kWriteLse) {
    if (chunk == 0 && t == 0) {
      float* l0 = p.lse + (static_cast<size_t>(batch) * p.sq + row0 + g) * p.heads + head;
      if (row0 + g < p.sq) l0[0] = (row_max[0] + log2f(row_sum[0])) * kLn2;
      if (row0 + g + 8 < p.sq)
        l0[static_cast<size_t>(8) * p.heads] = (row_max[1] + log2f(row_sum[1])) * kLn2;
    }
  }
}

template <int OA, bool kWriteLse>
int launch_fwd_wide(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                    const WideFwdParams& p, int batch, cudaStream_t stream) {
  const int smem = wide_fwd_smem_bytes(p.stages);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(attention_fwd_wide_kernel<OA, kWriteLse>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((p.sq + 63) / 64 * p.chunks, p.heads, batch);
  attention_fwd_wide_kernel<OA, kWriteLse><<<grid, kWideThreads, smem, stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

// The wide forward (heads of more than four atoms: d > 256, a multiple of
// 8) with a ring of `stages` slots; 0 or an error code. The plans' (nwg,
// bn) of the wide kernel are (1, 64).
template <bool kWriteLse>
int forward_wide(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                 int sq, int sk, int heads, int d, int scale_dim, int stages,
                 cudaStream_t stream) {
  if (batch < 1 || sq < 1 || sk < 1 || heads < 1 || !head_dim_ok(d, scale_dim) ||
      head_atoms(d) <= kNarrowAtoms || stages < 2 || stages > kMaxWideStages)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int rc = head_map(&mq, q, batch, sq, heads, d, 64);
  if (rc) return rc;
  if ((rc = head_map(&mk, k, batch, sk, heads, d, 64))) return rc;
  if ((rc = head_map(&mv, v, batch, sk, heads, d, 64))) return rc;
  WideFwdParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.sq = sq;
  p.sk = sk;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.atoms = head_atoms(d);
  p.chunks = wide_chunks(p.atoms);
  p.n_tiles = (sk + 63) / 64;
  p.stages = stages;
  p.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(scale_dim)));
  return wide_chunk_atoms(p.atoms) == 3
             ? launch_fwd_wide<3, kWriteLse>(mq, mk, mv, p, batch, stream)
             : launch_fwd_wide<4, kWriteLse>(mq, mk, mv, p, batch, stream);
}

}  // namespace
}  // namespace attn_hopper
