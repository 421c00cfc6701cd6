// Flash-attention forward on (B, S, H, 64) for Hopper (sm_90a), any S.
//
// Replaces genima_tpu/kernels/flash_attention.py::_flash_forward /
// _flash_kernel: non-causal softmax(Q K^T / sqrt(64)) V with an online
// softmax in f32, P rounded to bf16 before P V, keys at or past Sk masked to
// -1e30 and padded query rows never stored. The JAX wrapper transposes
// (B, S, H, D) to (B*H, S, D) around its kernel, a TPU tiling artifact that
// is not carried over: (B, S, H, 64) is the packed (B, S, H*64) layout the
// projections emit, and a block reads head h as the 64 columns at offset
// h * 64 with row stride H * 64.
//
// Bound: 4 * B * Sq * Sk * C flops on 2 * B * (2 * Sq + 2 * Sk) * C bytes.
// Self-attention at 4096 and 1024 tokens is bound by tensor-core
// operations; cross-attention over 77 keys does 4 * 77 flops per q byte
// pair and is bound by reading q and writing o, where what costs is the
// fixed latency of a block (load Q, one K/V tile, store O).
//
// Design (FlashAttention-3-style, warp-specialised): one block per
// (64 * nwg query rows, head, batch), nwg = 1 or 2 consumer warpgroups of
// 64 rows and one producer warpgroup.
//   * The producer's first thread TMA-loads the block's Q tile once, then
//     streams K and V tiles of bn keys (64, 80 or 128) through a ring of
//     `stages` stages behind "full" / "empty" mbarriers. The maps are 3-D
//     (C, S, B) with a (64, rows, 1) box at column head * 64, 128-byte
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
//     O += P V with wgmma m64n64k16, V read MN-major from the same stage.
//     The P V group runs while the warpgroup waits for the next tile and
//     issues its S; a stage goes back to the producer once the group that
//     reads it has been retired.
//   * With two consumer warpgroups, setmaxnreg moves registers from the
//     producer warpgroup (24) to the consumers (240).
//   * Rows at or past Sq are computed on TMA's zeros and not stored.
// kernels/flash_attention.py::plan picks nwg, bn and the ring depth per
// shape (python -m genima_torch.tune_kernels attn times every candidate).

#include "attention_hopper.cuh"

namespace {

using namespace hopper;
using namespace attn_hopper;

struct Params {
  __nv_bfloat16* o;
  int sq, sk, c, n_tiles, stages;
  float scale_log2;
};

template <int NWG, int BN>
struct Cfg {
  static constexpr int kBM = 64 * NWG;             // query rows a block
  static constexpr int kThreads = 128 * NWG + 128;  // consumers + the producer warpgroup
  static constexpr int kQBytes = kBM * kRowBytes;
  static constexpr int kKVBytes = BN * kRowBytes;   // one K or V tile (whole KB)
  static constexpr int kStage = 2 * kKVBytes;
  // one 64-key tile's block fits twice on an SM (<= 128 registers)
  static constexpr int kMinBlocks = NWG == 1 && BN == 64 ? 2 : 1;
  static int smem_bytes(int stages) { return 1024 + kQBytes + stages * kStage + 16 * stages + 16; }
};

template <int NWG, int BN>
__global__ void __launch_bounds__(Cfg<NWG, BN>::kThreads, Cfg<NWG, BN>::kMinBlocks)
flash_attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const Params p) {
  using C = Cfg<NWG, BN>;
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

  if (warp >= 4 * NWG) {  // the producer warpgroup; its first thread issues every load
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (warp == 4 * NWG && lane == 0) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      mbar_expect_tx(q_full, C::kQBytes);
      tma_load_3d(q_tile, &map_q, q_full, head * kHeadDim, q0, batch);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < p.n_tiles; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * C::kStage;
        mbar_expect_tx(&full[stage], C::kStage);
        tma_load_3d(st, &map_k, &full[stage], head * kHeadDim, j * BN, batch);
        tma_load_3d(st + C::kKVBytes, &map_v, &full[stage], head * kHeadDim, j * BN, batch);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if constexpr (NWG == 2) setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;

  mbar_wait(q_full, 0);
  const uint8_t* q_rows = q_tile + wg * 64 * kRowBytes;  // this warpgroup's 64 rows

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
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
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<BN, 0>(s, desc_k(q_rows, kk), desc_k(ks, kk));
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

    // online softmax in base 2: rows g (r = 0) and g + 8 (r = 1)
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
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) acc_to_a(pf[kk], s, kk);
    fence_frags(pf);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) wgmma_rs<64, 1>(o, pf[kk], desc_mn(vs, kk));
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
  __nv_bfloat16* rows = p.o + (static_cast<size_t>(batch) * p.sq + row0) * p.c + head * kHeadDim;
  store_acc(rows, p.c, o, 1.f / row_sum[0], 1.f / row_sum[1], row0 + g < p.sq,
            row0 + g + 8 < p.sq, g, t);
}

template <int NWG, int BN>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, const Params& p,
           int batch, int heads, cudaStream_t stream) {
  using C = Cfg<NWG, BN>;
  const int smem = C::smem_bytes(p.stages);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_fwd_kernel<NWG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((p.sq + C::kBM - 1) / C::kBM, heads, batch);
  flash_attention_fwd_kernel<NWG, BN><<<grid, C::kThreads, smem, stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

// A (C, S, B) map of a packed (B, S, C) bf16 tensor with a (64, rows, 1) box.
int seq_map(CUtensorMap* map, const void* x, int batch, int s, int c, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * 2,
                                 static_cast<cuuint64_t>(s) * c * 2};
  const cuuint32_t box[3] = {kHeadDim, static_cast<cuuint32_t>(rows), 1};
  return hopper_host::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

extern "C" {

int flash_attention_smem_bytes(int nwg, int bn, int stages);

// softmax(Q_h K_h^T / 8) V_h for every head h of (B, S, heads, 64) bf16
// tensors, Sq and Sk >= 1, with the consumer warpgroups (nwg), key tile
// (bn) and ring depth of kernels/flash_attention.py::plan. Needs 16-byte
// aligned tensors (the wrapper checks). Launches on `stream`, does not
// synchronise; returns 0 or an error code for flash_attention_error_string.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                        int sk, int heads, int nwg, int bn, int stages, void* stream) {
  if (flash_attention_smem_bytes(nwg, bn, stages) == 0 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = heads * kHeadDim;
  CUtensorMap mq, mk, mv;
  int rc = seq_map(&mq, q, batch, sq, c, 64 * nwg);
  if (rc) return rc;
  if ((rc = seq_map(&mk, k, batch, sk, c, bn))) return rc;
  if ((rc = seq_map(&mv, v, batch, sk, c, bn))) return rc;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.sq = sq;
  p.sk = sk;
  p.c = c;
  p.n_tiles = (sk + bn - 1) / bn;
  p.stages = stages;
  p.scale_log2 = kLog2e / 8.0f;  // log2(e) / sqrt(64)
  // a stage goes back to the producer only once the next tile has arrived:
  // more than one tile needs two stages
  if (stages < (p.n_tiles > 1 ? 2 : 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nwg == 1 && bn == 64) return launch<1, 64>(mq, mk, mv, p, batch, heads, s);
  if (nwg == 1 && bn == 80) return launch<1, 80>(mq, mk, mv, p, batch, heads, s);
  if (nwg == 1 && bn == 128) return launch<1, 128>(mq, mk, mv, p, batch, heads, s);
  if (nwg == 2 && bn == 64) return launch<2, 64>(mq, mk, mv, p, batch, heads, s);
  if (nwg == 2 && bn == 80) return launch<2, 80>(mq, mk, mv, p, batch, heads, s);
  return launch<2, 128>(mq, mk, mv, p, batch, heads, s);
}

// Shared memory a block of the (nwg, bn) kernel asks for at `stages`; 0 for
// a launch there is no kernel for.
int flash_attention_smem_bytes(int nwg, int bn, int stages) {
  if ((nwg != 1 && nwg != 2) || (bn != 64 && bn != 80 && bn != 128) || stages < 1) return 0;
  return 1024 + 64 * nwg * kRowBytes + stages * 2 * bn * kRowBytes + 16 * stages + 16;
}

const char* flash_attention_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
