// Float32 attention for Hopper (sm_90a) on the TF32 tensor cores, every f32
// product split in three (3xTF32), on packed (B, S, heads * d) f32 tensors:
// the forward shared by B1/B2a (packed_attention.cu) and B3
// (flash_attention.cu), and the pieces B2b's f32 dq and dk/dv kernels
// (packed_attention_bwd.cu) are built from.
//
// Replaces, on f32 inputs, genima_tpu/kernels/packed_attention.py:194
// _forward/_packed_kernel, :153 _forward_streaming, :274
// _forward_with_lse/_packed_kernel_lse and flash_attention.py:129
// _flash_forward/_flash_kernel, which take the input's dtype through:
// non-causal softmax(Q K^T / sqrt(d)) V with an online softmax in f32, P
// kept in f32, keys at or past Sk masked out, query rows at or past Sq never
// stored; with kWriteLse also L = m + ln(l) per (row, head) into a
// (B, Sq, heads) f32 tensor.
//
// 3xTF32. The tensor cores take f32 only as TF32: they read the top 19 bits
// of each operand, and one such pass misses the f32 results by ~1e-3 at
// unit-scale inputs, where these kernels are held to 1e-4. Each operand x is
// split into big = x with its low 13 bits cleared (tf32 exactly) and small =
// x - big (exact in f32; the tensor cores read its top 19 bits), and a * b
// is summed as a_small b_big + a_big b_small + a_big b_big: ~1e-6 of the
// result, as B4's f32 kernel reads. Big is cleared explicitly, so nothing
// rests on how the tensor cores treat the low bits of big. The tensor cores'
// own f32 sums cut low bits of each addend, so an error grows with the
// number of products summed into one accumulator: every P V (and dQ, dK, dV)
// sum of a key (or query) tile goes into a fresh accumulator, added in f32
// to the running one.
//
// Bound: the forward does 4 * B * Sq * Sk * C flops (three TF32 passes of
// each: at 495 / 3 = 165 TFLOP/s) on 4 * B * (2 Sq + 2 Sk) * C bytes; at the
// SD levels the flops bound it, the 77-key cross rows are bound by bytes.
//
// Which products run where. wgmma takes 32-bit operands from shared memory
// only K-major. S = Q K^T (and the backward's dP = dO V^T, S^T = K Q^T,
// dP^T = V dO^T) is K-major on the row-major tiles TMA lands: wgmma with A
// from registers (ldmatrix of the raw tile, split per k8 step; columns at
// or past d zeroed there) and B the streamed tile, which the producer
// warpgroup's warps 1-3 split in place (big) and into a remainder tile
// (small). O += P V (and dQ += dS K, dV += P^T dO, dK += dS^T Q) contracts
// over the rows of a row-major tile, which is not K-major: these run on
// mma.sync m16n8k8.tf32 (route c), A = P straight from the S accumulator
// (a thread holds columns 2t and 2t + 1 of each 8-key slice, which as the
// A fragment's k = t and t + 4 means keys 2t and 2t + 1: the B fragment
// reads its k rows in that order, so nothing is shuffled), B read from the
// raw row-major tile with one 16-byte load per row and 32-column slab (the
// n8 blocks take slab columns 4n + nb, so a thread's loads are contiguous
// and free of bank conflicts, and its output columns 8t..8t+7 too). Why not
// a transposing producer (route a): it would add two transposed tiles to
// every stage, which at 64-key tiles of 256 columns would not fit, and a
// wgmma accumulator a key tile would double O's registers (256 f32 a
// thread at d = 256); mma.sync keeps a fresh accumulator at 16 registers a
// slab, and needs no transposed copy at any head dim. Above 256 columns O
// is kept in chunks of at most four atoms (two in the clustered forward),
// one a block (the wide kernels at the end of this file).
//
// Layout: a head of d columns (the wrappers zero-pad a d that is not a
// multiple of 4 to the next one: TMA needs 16-byte row strides, and the
// float4 stores 16-byte columns; scale_dim is the real head dim) is read
// as DA = ceil(d / 64) atoms, 2 * DA slabs of 32 f32 columns (128 bytes a row, 128-byte swizzled: 16-byte chunk c of row r
// at chunk c ^ (r % 8)), one TMA box (32, rows, 1) each from 3-D (C, S, B)
// maps, so rows at or past S are zero-filled within the batch. Columns past
// d come from the next head (or TMA's zeros past C): every sum over d sees
// them times zeros of its A operand, and output columns past d are never
// stored.
//
// Forward design: one block per (64 * NWG query rows, head, batch): NWG
// consumer warpgroups of 64 rows and a producer warpgroup, whose warp 0's
// first thread TMA-loads the block's Q tile once and streams (K, V) tiles
// of BN keys through a ring behind "full" / "empty" mbarriers, and whose
// warps 1-3 split each landed K tile (big in place, small beside it) and
// arrive on a "ready" barrier; setmaxnreg moves registers to the consumers
// where there are two. Per tile, a consumer warpgroup: S = Q K^T (3xTF32
// wgmma m64nBNk8, two k8 steps a group, two register sets so that one group
// is in flight while the next one's A is split), the online softmax in base
// 2 in registers, and per slab O = O * alpha + P V (a fresh 3xTF32 mma.sync
// accumulator). A warp gives the stage back once it has read V. Tiles
// (fwd_tile_ok; kernels/flash_attention.py::f32_plan picks one and the ring
// depth per shape): one atom two consumer warpgroups on 64-key tiles (B3's
// 77-key prompt: one warpgroup on one 80-key tile); two atoms two
// warpgroups on 32-key tiles; three and four one, on 32- and 16-key tiles
// (shared memory). One warpgroup on 64-key tiles, and rings of three or
// four stages, measured no faster at the SD shapes.

#pragma once

#include <math.h>

#include "attention_hopper.cuh"

namespace attn_f32 {

// Internal linkage, as attention_fwd_hopper.cuh: the launch functions'
// `configured` statics must be one per library.
namespace {

using namespace hopper;

constexpr int kSlabBytes = 128;  // 32 f32 columns: the swizzle span
constexpr int kProducer = 128;   // the producer warpgroup
constexpr int kSplitters = 96;   // its warps 1-3
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;  // the JAX kernels' _NEG_INF
constexpr uint32_t kTf32Mask = 0xFFFFE000u;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take

inline int head_atoms(int d) { return (d + 63) / 64; }

// Whether the kernels take heads of d columns (packed width), scaled by
// 1 / sqrt(scale_dim): d a multiple of 4 (16-byte rows and column offsets
// for TMA and the float4 stores), scale_dim the real head dim it pads (d
// itself, or up to 3 columns fewer that the wrapper zero-padded). Above four
// atoms (d > 256) the wide kernels (below) take the head.
inline bool head_dim_ok(int d, int scale_dim) {
  return d >= 4 && d % 4 == 0 && scale_dim <= d && scale_dim > d - 4;
}

// --- plans (mirrored by kernels/flash_attention.py and packed_attention.py) --

// Dynamic shared memory of a forward block of nwg consumer warpgroups, bn-key
// tiles and a ring of `stages`: alignment slack, the Q tile, the ring of
// (K, K's remainders, V) and its barriers.
constexpr int fwd_smem_bytes(int da, int nwg, int bn, int stages) {
  return 1024 + 64 * nwg * 2 * da * kSlabBytes + stages * 3 * bn * 2 * da * kSlabBytes +
         8 * (3 * stages + 1);
}

// --- device helpers ----------------------------------------------------------

__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & kTf32Mask);
}

// x as TF32 operands: big (x's low 13 bits cleared) and small (x - big).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  const float b = tf32_trunc(x);
  big = __float_as_uint(b);
  small = __float_as_uint(x - b);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Byte offset of 16-byte chunk c of row r in a swizzled slab.
__device__ __forceinline__ int swz(int r, int c) { return r * kSlabBytes + ((c ^ (r & 7)) << 4); }

// The splitters' work on a landed tile of `bytes`: each value x becomes big
// in place and x - big at the same offset of `small` (the swizzle is the
// same in both, so the walk ignores it). Generic-proxy writes: the caller
// fences them for wgmma (fence_proxy_async) before it arrives.
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* small, int bytes, int sid) {
  float4* big = reinterpret_cast<float4*>(tile);
  float4* rem = reinterpret_cast<float4*>(small);
  for (int i = sid; i < bytes / 16; i += kSplitters) {
    const float4 v = big[i];
    const float4 b = make_float4(tf32_trunc(v.x), tf32_trunc(v.y), tf32_trunc(v.z), tf32_trunc(v.w));
    big[i] = b;
    rem[i] = make_float4(v.x - b.x, v.y - b.y, v.z - b.z, v.w - b.w);
  }
}

// The A fragments (big, small) of k8 step kk of a warp's 16 rows (from row
// row0, a multiple of 16) of a raw R-row tile at shared address `tile`;
// columns at or past `cols` are zero. ldmatrix on 32-bit data: an 8x8 b16
// matrix is 8 rows x 4 f32, so the four matrices are m16n8k8.tf32's A.
template <int R>
__device__ __forceinline__ void load_a(uint32_t big[4], uint32_t small[4], uint32_t tile,
                                       int row0, int kk, int lane, int cols) {
  uint32_t r[4];
  ldmatrix_x4(r, tile + (kk >> 2) * R * kSlabBytes + (row0 + (lane & 15)) * kSlabBytes +
                     (((2 * (kk & 3) + (lane >> 4)) ^ (lane & 7)) << 4));
  const int c = 8 * kk + (lane & 3);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = c + (e >= 2 ? 4 : 0) < cols ? __uint_as_float(r[e]) : 0.f;
    split(x, big[e], small[e]);
  }
}

template <int G>
__device__ __forceinline__ void fence_frag_set(uint32_t (&a)[G][2][4]) {
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][h][e])::"memory");
}

// acc (this warpgroup's 64 rows x N, wgmma's accumulator layout) = A B^T
// over the 4 * NS k8 steps of NS slabs, 3xTF32: A this warp's 16 rows from
// row0 of a raw R-row tile at shared address `a_tile` (split per k8 step,
// columns at or past `cols` zeroed), B an N-row tile split into `b_big`
// (in place) and `b_small`. G k8 steps (3 G wgmmas) a group, two register
// sets: a group is issued while the one before it may still run, and a set
// is refilled only once the group that read it is retired. G = 2 where the
// registers allow, 1 where 16 more would spill.
template <int NS, int R, int N, int G>
__device__ __forceinline__ void gemm_abt(float (&acc)[N / 2], uint32_t a_tile, int row0,
                                         const uint8_t* b_big, const uint8_t* b_small, int lane,
                                         int cols) {
  constexpr int kGroups = 4 * NS / G;
  uint32_t a[2][G][2][4];  // [set][k8 step][big, small][4]
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_operands(acc);
#pragma unroll
  for (int grp = 0; grp < kGroups; ++grp) {
    uint32_t(&set)[G][2][4] = a[grp & 1];
#pragma unroll
    for (int j = 0; j < G; ++j) load_a<R>(set[j][0], set[j][1], a_tile, row0, G * grp + j, lane, cols);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int kk = G * grp + j;
      const int off = (kk >> 2) * N * kSlabBytes + (kk & 3) * 32;
      const uint64_t db = make_desc(b_big + off, 128, 16, 1024);
      const uint64_t ds = make_desc(b_small + off, 128, 16, 1024);
      wgmma_tf32_rs<N>(acc, set[j][1], db);
      wgmma_tf32_rs<N>(acc, set[j][0], ds);
      wgmma_tf32_rs<N>(acc, set[j][0], db);
    }
    wgmma_commit();
    fence_operands(acc);
    wgmma_wait<1>();  // the group before this one is retired: its set is free
    fence_frag_set(a[(grp + 1) & 1]);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  fence_frag_set(a[0]);
  fence_frag_set(a[1]);
}

// acc (a warp's 16 rows x one 32-column slab: n8 block nb holds slab
// columns 4n + nb) += X B over K rows, 3xTF32 on mma.sync: X this warp's
// rows of a wgmma accumulator over K columns (x, split here), B the slab
// `b` of a row-major K-row tile, raw (split here) or, with kSplit, already
// split into `b` (big) and `b_small`. k8 step j takes rows 8j + 2t (k = t)
// and 8j + 2t + 1 (k = t + 4): the order in which x holds them.
template <int K, bool kSplit>
__device__ __forceinline__ void gemm_xb(float (&acc)[4][4], const float* x, const uint8_t* b,
                                        const uint8_t* b_small, int g, int t) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    uint32_t xb[4], xs[4];
    split(x[4 * j], xb[0], xs[0]);
    split(x[4 * j + 2], xb[1], xs[1]);
    split(x[4 * j + 1], xb[2], xs[2]);
    split(x[4 * j + 3], xb[3], xs[3]);
    const int o0 = swz(8 * j + 2 * t, g), o1 = swz(8 * j + 2 * t + 1, g);
    const float4 v0 = *reinterpret_cast<const float4*>(b + o0);
    const float4 v1 = *reinterpret_cast<const float4*>(b + o1);
    const float r0[4] = {v0.x, v0.y, v0.z, v0.w}, r1[4] = {v1.x, v1.y, v1.z, v1.w};
    float s0[4], s1[4];
    if constexpr (kSplit) {
      const float4 w0 = *reinterpret_cast<const float4*>(b_small + o0);
      const float4 w1 = *reinterpret_cast<const float4*>(b_small + o1);
      s0[0] = w0.x, s0[1] = w0.y, s0[2] = w0.z, s0[3] = w0.w;
      s1[0] = w1.x, s1[1] = w1.y, s1[2] = w1.z, s1[3] = w1.w;
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t b0, b0s, b1, b1s;
      if constexpr (kSplit) {
        b0 = __float_as_uint(r0[nb]), b0s = __float_as_uint(s0[nb]);
        b1 = __float_as_uint(r1[nb]), b1s = __float_as_uint(s1[nb]);
      } else {
        split(r0[nb], b0, b0s);
        split(r1[nb], b1, b1s);
      }
      mma_tf32(acc[nb], xs, b0, b1);
      mma_tf32(acc[nb], xb, b0s, b1s);
      mma_tf32(acc[nb], xb, b0, b1);
    }
  }
}

// Rows g and g + 8 of a warp's slab accumulator (gemm_xb's layout), times
// inv0 / inv8, into f32 rows at dst0 (row g's element at the slab's column
// 0; rows ld floats apart, 16-byte aligned), each row only if its flag is
// set, columns at or past `cols` (a multiple of 4, from the slab's first)
// never.
__device__ __forceinline__ void store_slab(float* dst0, int ld, const float (&o)[4][4], float inv0,
                                           float inv8, bool ok0, bool ok8, int t, int cols) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!(r ? ok8 : ok0)) continue;
    float* dst = dst0 + static_cast<size_t>(8 * r) * ld;
    const float inv = r ? inv8 : inv0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * t + 4 * h;
      if (c < cols)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(o[0][2 * r + h] * inv, o[1][2 * r + h] * inv, o[2][2 * r + h] * inv,
                        o[3][2 * r + h] * inv);
    }
  }
}

// A (C, S, B) map of a packed (B, S, C) f32 tensor with a (32, rows, 1) box.
int seq_map(CUtensorMap* map, const void* x, int batch, int s, int c, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * 4,
                                 static_cast<cuuint64_t>(s) * c * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows), 1};
  return hopper_host::encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

// --- forward -----------------------------------------------------------------

struct FwdParams {
  float* o;
  float* lse;  // (B, Sq, heads), written by the kWriteLse kernels
  int sq, sk, c, d, heads, n_tiles, stages;
  float scale_log2;  // log2(e) / sqrt(scale_dim)
};

template <int DA, int NWG, int BN>
struct FwdCfg {
  static constexpr int kNS = 2 * DA;  // slabs
  static constexpr int kBM = 64 * NWG;  // query rows a block
  static constexpr int kThreads = 128 * NWG + kProducer;
  static constexpr int kQBytes = kBM * kNS * kSlabBytes;
  static constexpr int kTile = BN * kNS * kSlabBytes;  // one K or V tile
  static constexpr int kStage = 3 * kTile;             // K (big), its remainders, V
  // k8 steps a wgmma group: one where two would spill (O takes 32 f32 a
  // thread an atom)
  static constexpr int kGroup = DA >= 3 ? 1 : 2;
};

template <int DA, int NWG, int BN, bool kWriteLse>
__global__ void __launch_bounds__(FwdCfg<DA, NWG, BN>::kThreads, 1)
attention_f32_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, const FwdParams p) {
  using C = FwdCfg<DA, NWG, BN>;
  constexpr int NS = C::kNS;
  const int S = p.stages;
  constexpr int kS = BN / 2;  // score accumulator values a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = attn_hopper::align1024(smem_raw);
  uint8_t* q_tile = smem;
  uint8_t* ring = smem + C::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kStage);
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;
  uint64_t* q_full = empty + S;

  const int q0 = blockIdx.x * C::kBM;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitters);
      mbar_init(&empty[s], 4 * NWG);  // each consumer warp, once it has read V
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= 4 * NWG) {  // the producer warpgroup
    if constexpr (NWG >= 2) setmaxnreg_dec<40>();
    if (warp == 4 * NWG) {
      if (lane == 0) {
        prefetch_tensormap(&map_q);
        prefetch_tensormap(&map_k);
        prefetch_tensormap(&map_v);
        const int col = head * p.d;
        mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load_3d(q_tile + s * C::kBM * kSlabBytes, &map_q, q_full, col + 32 * s, q0, batch);
        int stage = 0;
        uint32_t phase = 0;
        for (int j = 0; j < p.n_tiles; ++j) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = ring + stage * C::kStage;
          mbar_expect_tx(&full[stage], 2 * C::kTile);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            tma_load_3d(st + s * BN * kSlabBytes, &map_k, &full[stage], col + 32 * s, j * BN, batch);
            tma_load_3d(st + 2 * C::kTile + s * BN * kSlabBytes, &map_v, &full[stage],
                        col + 32 * s, j * BN, batch);
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else {  // splitters: K of every stage, in ring order
      const int sid = threadIdx.x - 128 * NWG - 32;
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < p.n_tiles; ++j) {
        mbar_wait(&full[stage], phase);
        uint8_t* st = ring + stage * C::kStage;
        split_tile(st, st + C::kTile, C::kTile, sid);
        fence_proxy_async();  // before wgmma reads them
        mbar_arrive(&ready[stage]);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if constexpr (NWG >= 2) setmaxnreg_inc<232>();
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = wg * 64 + wq * 16;  // this warp's rows in the Q tile
  const uint32_t q_addr = smem_u32(q_tile);

  float o[NS][4][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[s][nb][e] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < p.n_tiles; ++j) {
    mbar_wait(&full[stage], phase);  // V, read by this thread's loads
    mbar_wait(&ready[stage], phase);
    const uint8_t* kt = ring + stage * C::kStage;
    const uint8_t* vt = kt + 2 * C::kTile;

    float s[kS];
    gemm_abt<NS, C::kBM, BN, C::kGroup>(s, q_addr, row0, kt, kt + C::kTile, lane, p.d);

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
      alpha[r] = attn_hopper::exp2_approx(row_max[r] - m_new);  // 0 at the first tile
      row_max[r] = m_new;
      row_sum[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = attn_hopper::exp2_approx(fmaf(s[i], p.scale_log2, -row_max[r]));
      row_sum[r] += s[i];
    }
    // O = O * alpha + P V, a fresh accumulator a slab
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      float acc[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
      gemm_xb<BN, false>(acc, s, vt + sl * BN * kSlabBytes, nullptr, g, t);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[sl][nb][e] = fmaf(o[sl][nb][e], alpha[e >> 1], acc[nb][e]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 2);
  }
  const int row = q0 + row0 + g;
  const bool ok0 = row < p.sq, ok8 = row + 8 < p.sq;
  float* dst = p.o + (static_cast<size_t>(batch) * p.sq + row) * p.c + head * p.d;
  const float inv0 = 1.f / row_sum[0], inv8 = 1.f / row_sum[1];
#pragma unroll
  for (int sl = 0; sl < NS; ++sl)
    store_slab(dst + 32 * sl, p.c, o[sl], inv0, inv8, ok0, ok8, t, p.d - 32 * sl);
  if constexpr (kWriteLse) {
    // L = m + ln(l) in natural-log units: row_max is m * log2(e)
    if (t == 0) {
      float* l0 = p.lse + (static_cast<size_t>(batch) * p.sq + row) * p.heads + head;
      if (ok0) l0[0] = (row_max[0] + log2f(row_sum[0])) * kLn2;
      if (ok8) l0[static_cast<size_t>(8) * p.heads] = (row_max[1] + log2f(row_sum[1])) * kLn2;
    }
  }
}

template <int DA, int NWG, int BN, bool kWriteLse>
int launch_fwd(const void* q, const void* k, const void* v, FwdParams& p, int batch,
               cudaStream_t stream) {
  using C = FwdCfg<DA, NWG, BN>;
  CUtensorMap mq, mk, mv;
  int rc = seq_map(&mq, q, batch, p.sq, p.c, C::kBM);
  if (rc) return rc;
  if ((rc = seq_map(&mk, k, batch, p.sk, p.c, BN))) return rc;
  if ((rc = seq_map(&mv, v, batch, p.sk, p.c, BN))) return rc;
  p.n_tiles = (p.sk + BN - 1) / BN;
  const int smem = fwd_smem_bytes(DA, NWG, BN, p.stages);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(attention_f32_fwd_kernel<DA, NWG, BN, kWriteLse>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((p.sq + C::kBM - 1) / C::kBM, p.heads, batch);
  attention_f32_fwd_kernel<DA, NWG, BN, kWriteLse><<<grid, C::kThreads, smem, stream>>>(mq, mk, mv,
                                                                                        p);
  return static_cast<int>(cudaGetLastError());
}

// The (nwg, bn) tiles the f32 forward has at each atom count: one atom
// (2, 64) and, with kCross (flash_attention.cu's B3, whose prompt has 77
// keys), (1, 80); two (2, 32); three (1, 32); four (1, 16).
template <bool kCross>
bool fwd_tile_ok(int da, int nwg, int bn) {
  switch (da) {
    case 1: return (nwg == 2 && bn == 64) || (kCross && nwg == 1 && bn == 80);
    case 2: return nwg == 2 && bn == 32;
    case 3: return nwg == 1 && bn == 32;
    case 4: return nwg == 1 && bn == 16;
    default: return false;
  }
}

// --- heads of more than four atoms (d > 256) --------------------------------
//
// As the bf16 streaming wide forward (attention_fwd_hopper.cuh): O in
// chunks of OA = 3 or 4 atoms (attn_hopper::wide_chunk_atoms), one chunk a
// block; S summed over every atom of the head, nothing of it resident, so
// shared memory does not grow with d (the wide backward in
// packed_attention_bwd.cu uses the same items and ring). A ring of 32 KB slots
// carries, per streamed tile of kWideT = 32 rows, one "S item" an atom (the
// block's 64 rows of X raw, 16 KB, for the A operand's ldmatrix; the tile's
// 32 rows of Y, which the producer warpgroup's warps 1-3 split into big in
// place and small beside it, 8 + 8 KB) and one "chunk item" (the tile's
// rows of the chunk's atoms, raw: the B operand of the mma.sync products,
// split on the fly). Each atom's S part goes into a fresh wgmma accumulator,
// added in f32: the tensor cores' own sums cut low bits with every addend,
// and a wide head sums up to d products. Maps are 4-D (head_map_f32): zeros
// past d and past S. One consumer warpgroup (256 threads: up to 255
// registers a thread).

constexpr int kWideT = 32;                         // rows of a streamed tile
constexpr int kWideX = 64 * 2 * kSlabBytes;        // X's 64 rows of an atom: 16 KB
constexpr int kWideY = kWideT * 2 * kSlabBytes;    // Y's 32 rows of an atom: 8 KB
constexpr int kWideSlotF32 = kWideX + 2 * kWideY;  // 32 KB: also a chunk item's 4 atoms
constexpr int kWideThreadsF32 = 128 + kProducer;

// Shared memory of a wide f32 block with a ring of `stages` slots (and, for
// the dk/dv kernels, a stage's kWideT values of L * log2(e) and Drow).
constexpr int wide_smem_bytes(int stages, bool rows) {
  return 1024 + stages * (kWideSlotF32 + (rows ? 2 * kWideT * 4 : 0)) + 8 * (3 * stages);
}

// A (d, heads, S, B) map of a packed (B, S, heads * d) f32 tensor with a
// (32, 1, rows, 1) box: zeros past a head's d columns and past S.
inline int head_map_f32(CUtensorMap* map, const void* x, int batch, int s, int heads, int d,
                        int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 4,
                                 static_cast<cuuint64_t>(heads) * d * 4,
                                 static_cast<cuuint64_t>(s) * heads * d * 4};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  return hopper_host::encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

__device__ __forceinline__ void tma_atom_x(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                           int atom, int head, int row, int batch) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
    tma_load_4d(dst + s * 64 * kSlabBytes, map, bar, 64 * atom + 32 * s, head, row, batch);
}

__device__ __forceinline__ void tma_atom_y(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                           int atom, int head, int row, int batch) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
    tma_load_4d(dst + s * kWideT * kSlabBytes, map, bar, 64 * atom + 32 * s, head, row, batch);
}

// The chunk's OA atoms of a tile's kWideT rows, raw: slab sl at sl * kWideT rows.
template <int OA>
__device__ __forceinline__ void tma_chunk(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int col0, int head, int row, int batch) {
#pragma unroll
  for (int sl = 0; sl < 2 * OA; ++sl)
    tma_load_4d(dst + sl * kWideT * kSlabBytes, map, bar, col0 + 32 * sl, head, row, batch);
}

// The producer warpgroup of the wide f32 kernels: per tile j of `tiles`,
// `items` S items and the chunk item (n == items), each issued by warp 0's
// first thread as `issue(j, n, slot)` once the slot is free, and each S
// item's Y tile split by warps 1-3, who then arrive on `ready` (for a chunk
// item too, so that its phases keep step).
template <class Issue>
__device__ __forceinline__ void wide_producer(int tiles, int items, uint8_t* ring, uint64_t* full,
                                              uint64_t* ready, uint64_t* empty, int stages,
                                              Issue issue) {
  const int warp = (threadIdx.x >> 5) - 4;
  if (warp == 0 && (threadIdx.x & 31) != 0) return;
  int slot = 0;
  uint32_t phase = 0;
  for (int j = 0; j < tiles; ++j)
    for (int n = 0; n <= items; ++n) {
      uint8_t* st = ring + slot * kWideSlotF32;
      if (warp == 0) {
        mbar_wait(&empty[slot], phase ^ 1);
        issue(j, n, slot);
      } else {
        mbar_wait(&full[slot], phase);
        if (n < items) split_tile(st + kWideX, st + kWideX + kWideY, kWideY, threadIdx.x - 160);
        fence_proxy_async();  // before wgmma reads them
        mbar_arrive(&ready[slot]);
      }
      if (++slot == stages) {
        slot = 0;
        phase ^= 1;
      }
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// acc += X Y^T of the S item in `slot` (this warp's 16 rows of X from row0),
// through a fresh accumulator; the slot goes back to the producer.
__device__ __forceinline__ void wide_scores_item(float (&acc)[kWideT / 2], const uint8_t* ring,
                                                 uint64_t* full, uint64_t* ready,
                                                 uint64_t* empty, int stages, int& slot,
                                                 uint32_t& phase, int row0, int lane) {
  mbar_wait(&full[slot], phase);
  mbar_wait(&ready[slot], phase);
  const uint8_t* st = ring + slot * kWideSlotF32;
  float part[kWideT / 2];
  gemm_abt<2, 64, kWideT, 1>(part, smem_u32(st), row0, st + kWideX, st + kWideX + kWideY, lane,
                             64);
#pragma unroll
  for (int i = 0; i < kWideT / 2; ++i) acc[i] += part[i];
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[slot]);
  if (++slot == stages) {
    slot = 0;
    phase ^= 1;
  }
}

struct WideParamsF32 {
  float* o;
  float* lse;
  int sq, sk, c, d, heads, atoms, chunks, stages;
  float scale, scale_log2;
};

template <int OA, bool kWriteLse>
__global__ void __launch_bounds__(kWideThreadsF32, 1)
attention_f32_fwd_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v, const WideParamsF32 p) {
  constexpr int NS = 2 * OA, kS = kWideT / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = attn_hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kWideSlotF32);
  uint64_t* ready = full + p.stages;
  uint64_t* empty = ready + p.stages;
  const int chunk = blockIdx.x % p.chunks;
  const int q0 = blockIdx.x / p.chunks * 64;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int col0 = chunk * OA * 64;
  const int n_tiles = (p.sk + kWideT - 1) / kWideT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitters);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4) {
    const CUtensorMap *mq = &map_q, *mk = &map_k, *mv = &map_v;
    const int atoms = p.atoms;
    wide_producer(n_tiles, atoms, ring, full, ready, empty, p.stages, [=](int j, int n, int slot) {
      uint8_t* st = ring + slot * kWideSlotF32;
      if (n < atoms) {
        mbar_expect_tx(&full[slot], kWideX + kWideY);
        tma_atom_x(st, mq, &full[slot], n, head, q0, batch);
        tma_atom_y(st + kWideX, mk, &full[slot], n, head, j * kWideT, batch);
      } else {
        mbar_expect_tx(&full[slot], OA * 2 * kWideT * kSlabBytes);
        tma_chunk<OA>(st, mv, &full[slot], col0, head, j * kWideT, batch);
      }
    });
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  float o[NS][4][4];
#pragma unroll
  for (int sl = 0; sl < NS; ++sl)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[sl][nb][e] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  int slot = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_tiles; ++j) {
    float s[kS];
    zero(s);
    for (int a = 0; a < p.atoms; ++a)
      wide_scores_item(s, ring, full, ready, empty, p.stages, slot, phase, row0, lane);
    const int kv0 = j * kWideT;
    if (kv0 + kWideT > p.sk) {  // the ragged last tile: keys >= Sk
#pragma unroll
      for (int i = 0; i < kS; ++i)
        if (kv0 + 8 * (i >> 2) + 2 * t + (i & 1) >= p.sk) s[i] = kMasked;
    }
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kS; ++i) tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 2));
      const float m_new = fmaxf(row_max[r], tile_max[r] * p.scale_log2);
      alpha[r] = attn_hopper::exp2_approx(row_max[r] - m_new);
      row_max[r] = m_new;
      row_sum[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = attn_hopper::exp2_approx(fmaf(s[i], p.scale_log2, -row_max[r]));
      row_sum[r] += s[i];
    }
    mbar_wait(&full[slot], phase);  // the chunk's V
    mbar_wait(&ready[slot], phase);
    const uint8_t* vt = ring + slot * kWideSlotF32;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      float acc[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
      gemm_xb<kWideT, false>(acc, s, vt + sl * kWideT * kSlabBytes, nullptr, g, t);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[sl][nb][e] = fmaf(o[sl][nb][e], alpha[e >> 1], acc[nb][e]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (++slot == p.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 2);
  }
  const int row = q0 + row0 + g;
  const bool ok0 = row < p.sq, ok8 = row + 8 < p.sq;
  float* dst = p.o + (static_cast<size_t>(batch) * p.sq + row) * p.c + head * p.d + col0;
  const float inv0 = 1.f / row_sum[0], inv8 = 1.f / row_sum[1];
#pragma unroll
  for (int sl = 0; sl < NS; ++sl)
    store_slab(dst + 32 * sl, p.c, o[sl], inv0, inv8, ok0, ok8, t, p.d - col0 - 32 * sl);
  if constexpr (kWriteLse) {
    if (chunk == 0 && t == 0) {
      float* l0 = p.lse + (static_cast<size_t>(batch) * p.sq + row) * p.heads + head;
      if (ok0) l0[0] = (row_max[0] + log2f(row_sum[0])) * kLn2;
      if (ok8) l0[static_cast<size_t>(8) * p.heads] = (row_max[1] + log2f(row_sum[1])) * kLn2;
    }
  }
}

template <int OA, bool kWriteLse>
int launch_fwd_wide(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                    const WideParamsF32& p, int batch, cudaStream_t stream) {
  const int smem = wide_smem_bytes(p.stages, false);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(attention_f32_fwd_wide_kernel<OA, kWriteLse>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((p.sq + 63) / 64 * p.chunks, p.heads, batch);
  attention_f32_fwd_wide_kernel<OA, kWriteLse><<<grid, kWideThreadsF32, smem, stream>>>(mq, mk,
                                                                                        mv, p);
  return static_cast<int>(cudaGetLastError());
}

// --- the clustered wide f32 forward (d = 260..1024) --------------------------
//
// attention_f32_fwd_cluster_kernel: O in chunks of two atoms (four 32-column
// slabs), the chunks of one 64-row query tile the CTAs of a thread-block
// cluster (3 to 8), so S = Q K^T is formed once per key tile for the whole
// head, as in the bf16 clustered kernel (attention_fwd_hopper.cuh). Two
// atoms of O hold 64 f32 a thread, where three or four held 96 or 128 beside
// S, P and the 3xTF32 operands and spilled; the grid has two to three times
// the blocks. Each CTA (a consumer warpgroup and the producer warpgroup: 256
// threads) keeps its chunk's slabs of Q resident, raw (32 KB), and streams
// per 32-key tile a K item (its slabs of K, which the producer's warps 1-3
// split into big in place and small beside it) and a V item (raw) through a
// ring of 32 KB slots. Per tile: its partial S over its own 128 columns
// (3xTF32 wgmma, A split per k8 step from an ldmatrix of Q; one accumulator
// over the 128 columns, as the narrow kernels sum up to 256), bulk-copied
// to every peer; while the copies fly, O = O * alpha + P V of the tile
// before, a slab at a time with a fresh mma.sync accumulator; then the
// peers' partials, summed in chunk order, so every CTA holds the same S, m
// and l bit for bit; the online softmax. The keys are not split.
// Bound as the narrow f32 kernel; the exchange adds 8 KB a peer a key tile
// over the SM-to-SM network, ~1.5 us a peer on the H100: from 9 atoms (five
// chunks) on, where the streaming kernel forms S three or more times and
// spills, the cluster is faster (1x1024 at d = 640: 0.150 ms against 0.385);
// at five to eight atoms the streaming kernel is (1x4096 at d = 320: 0.828
// against 1.08), and takes the head.

constexpr int kClusterAtomsF32 = 2;          // atoms of O a CTA
constexpr int kClusterChunksF32 = 8;         // the most chunks: a portable cluster
constexpr int kXBytesF32 = 64 * kWideT * 4;  // one partial S: 64 rows x 32 keys f32
constexpr int kClusterQ = 64 * 2 * kClusterAtomsF32 * kSlabBytes;      // Q's slabs: 32 KB
constexpr int kClusterTile = kWideT * 2 * kClusterAtomsF32 * kSlabBytes;  // a tile's: 16 KB
constexpr int kClusterSlot = 2 * kClusterTile;  // K big and small, or V raw: 32 KB

inline int cluster_chunks_f32(int atoms) {
  return (atoms + kClusterAtomsF32 - 1) / kClusterAtomsF32;
}

// Whether an f32 head of `atoms` atoms takes the clustered kernel: 9 to 16
// (d = 516..1024; mirrored by kernels/flash_attention.py::f32_clustered).
inline bool f32_clustered(int atoms) {
  return atoms > 2 * attn_hopper::kNarrowAtoms && cluster_chunks_f32(atoms) <= kClusterChunksF32;
}

// Dynamic shared memory of a clustered f32 block: alignment slack, Q's slabs,
// the ring, two out buffers and two exchange buffers a peer, and the
// barriers (full, ready and empty a slot, Q's, two exchanges').
constexpr int cluster_smem_bytes_f32(int chunks, int stages) {
  return 1024 + kClusterQ + stages * kClusterSlot + 2 * chunks * kXBytesF32 +
         8 * (3 * stages + 3);
}

// The ring's depth: as many slots as shared memory leaves, at most
// kMaxWideStages (mirrored by kernels/flash_attention.py::f32_cluster_stages).
inline int cluster_stages_f32(int chunks) {
  int s = attn_hopper::kMaxWideStages;
  while (s > 2 && cluster_smem_bytes_f32(chunks, s) > kMaxSmem) --s;
  return s;
}

struct ClusterParamsF32 {
  float* o;
  float* lse;
  int sq, sk, c, d, heads, chunks, stages;
  float scale_log2;
};

template <bool kWriteLse>
__global__ void __launch_bounds__(kWideThreadsF32, 1)
attention_f32_fwd_cluster_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const ClusterParamsF32 p) {
  constexpr int OA = kClusterAtomsF32;
  using attn_hopper::cluster_sync;
  using attn_hopper::map_rank;
  constexpr int NS = 2 * OA, kS = kWideT / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = attn_hopper::align1024(smem_raw);
  uint8_t* ring = q_tile + kClusterQ;
  uint8_t* xout = ring + p.stages * kClusterSlot;  // this CTA's partial S, by tile parity
  uint8_t* xbuf = xout + 2 * kXBytesF32;            // the peers', by tile parity and peer
  const int peers = p.chunks - 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(xbuf + 2 * peers * kXBytesF32);
  uint64_t* ready = full + p.stages;
  uint64_t* empty = ready + p.stages;
  uint64_t* q_full = empty + p.stages;
  uint64_t* xfull = q_full + 1;  // the two exchange buffers'
  const int chunk = static_cast<int>(attn_hopper::cluster_rank());
  const int q0 = blockIdx.x / p.chunks * 64;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int col0 = chunk * OA * 64;
  const int n_tiles = (p.sk + kWideT - 1) / kWideT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitters);
      mbar_init(&empty[s], 4);  // each consumer warp, once it has read the item
    }
    mbar_init(q_full, 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&xfull[b], 1);
      mbar_expect_tx(&xfull[b], peers * kXBytesF32);  // tiles 0 and 1
    }
    mbar_fence_init();
  }
  cluster_sync();  // every peer's barriers are set before anything reaches them
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4) {  // the producer warpgroup: warp 0 loads, warps 1-3 split K
    const bool loader = warp == 4;
    if (!loader || lane == 0) {
      if (loader) {
        prefetch_tensormap(&map_q);
        prefetch_tensormap(&map_k);
        prefetch_tensormap(&map_v);
        mbar_expect_tx(q_full, kClusterQ);
#pragma unroll
        for (int sl = 0; sl < NS; ++sl)
          tma_load_4d(q_tile + sl * 64 * kSlabBytes, &map_q, q_full, col0 + 32 * sl, head, q0,
                      batch);
      }
      int slot = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j)
        for (int kv = 0; kv < 2; ++kv) {  // the K item, then the V item
          uint8_t* st = ring + slot * kClusterSlot;
          if (loader) {
            mbar_wait(&empty[slot], phase ^ 1);
            mbar_expect_tx(&full[slot], kClusterTile);
#pragma unroll
            for (int sl = 0; sl < NS; ++sl)
              tma_load_4d(st + sl * kWideT * kSlabBytes, kv ? &map_v : &map_k, &full[slot],
                          col0 + 32 * sl, head, j * kWideT, batch);
          } else {
            mbar_wait(&full[slot], phase);
            if (kv == 0) split_tile(st, st + kClusterTile, kClusterTile, threadIdx.x - 160);
            fence_proxy_async();  // before wgmma reads them
            mbar_arrive(&ready[slot]);
          }
          if (++slot == p.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
    }
  } else {
    const int g = lane >> 2, t = lane & 3, tid = threadIdx.x;
    const int row0 = warp * 16;
    const uint32_t q_addr = smem_u32(q_tile), x_addr = smem_u32(xbuf), x_bar = smem_u32(xfull);
    float o[NS][4][4];
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[sl][nb][e] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);
    // the ring carries K(0), V(0), K(1), ...: item i in slot i % stages, its
    // (i / stages)-th use; the consumers take K(j) before V(j - 1) and give
    // each slot back in its order of use
    const auto wait_item = [&](int i) {
      mbar_wait(&full[i % p.stages], (i / p.stages) & 1);
      mbar_wait(&ready[i % p.stages], (i / p.stages) & 1);
      return ring + i % p.stages * kClusterSlot;
    };
    const auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % p.stages]);
    };
    float pp[kS];  // P of the tile whose P V is pending
    float alpha_p[2] = {0.f, 0.f};
    // O = O * alpha + P V of tile j, a fresh accumulator a slab
    const auto pv = [&](int j) {
      const uint8_t* vt = wait_item(2 * j + 1);
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        float acc[4][4];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
        gemm_xb<kWideT, false>(acc, pp, vt + sl * kWideT * kSlabBytes, nullptr, g, t);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[sl][nb][e] = fmaf(o[sl][nb][e], alpha_p[e >> 1], acc[nb][e]);
      }
      release(2 * j + 1);
    };
    for (int j = 0; j < n_tiles; ++j) {
      const uint8_t* kt = wait_item(2 * j);  // the K item
      float s[kS];
      gemm_abt<NS, 64, kWideT, 1>(s, q_addr, row0, kt, kt + kClusterTile, lane, 128);
      release(2 * j);

      // the partial to every peer
      const int b = j & 1;
      float4* out = reinterpret_cast<float4*>(xout + b * kXBytesF32);
#pragma unroll
      for (int k = 0; k < kS / 4; ++k)
        out[k * 128 + tid] = make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
      fence_proxy_async();  // before the bulk copies read them
      named_barrier(1, 128);
      if (tid == 0) {
        for (int c = 0; c < p.chunks; ++c) {
          if (c == chunk) continue;
          const int idx = chunk < c ? chunk : chunk - 1;  // this CTA's buffer at the peer
          attn_hopper::bulk_copy_peer(map_rank(x_addr + (b * peers + idx) * kXBytesF32, c),
                                      smem_u32(out), kXBytesF32, map_rank(x_bar + b * 8, c));
        }
        attn_hopper::bulk_commit();
      }
      // the tile before's P V runs while the partials travel
      if (j > 0) pv(j - 1);

      // the sum in chunk order
      attn_hopper::mbar_wait_cluster(&xfull[b], (j >> 1) & 1);
#pragma unroll
      for (int k = 0; k < kS / 4; ++k) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < p.chunks; ++c) {
          float4 v;
          if (c == chunk) {
            v = make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
          } else {
            const int idx = c < chunk ? c : c - 1;
            v = *reinterpret_cast<const float4*>(xbuf + (b * peers + idx) * kXBytesF32 +
                                                 (k * 128 + tid) * 16);
          }
          sum = c == 0 ? v : make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
        }
        s[4 * k] = sum.x, s[4 * k + 1] = sum.y, s[4 * k + 2] = sum.z, s[4 * k + 3] = sum.w;
      }
      // buffer b's next phase (tile j + 2): no peer sends it before this
      // CTA's partial for tile j + 1, which comes after this
      if (tid == 0) mbar_expect_tx(&xfull[b], peers * kXBytesF32);

      const int kv0 = j * kWideT;
      if (kv0 + kWideT > p.sk) {  // the ragged last tile: keys >= Sk
#pragma unroll
        for (int i = 0; i < kS; ++i)
          if (kv0 + 8 * (i >> 2) + 2 * t + (i & 1) >= p.sk) s[i] = kMasked;
      }
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kS; ++i) tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 1));
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffff, tile_max[r], 2));
        const float m_new = fmaxf(row_max[r], tile_max[r] * p.scale_log2);
        alpha_p[r] = attn_hopper::exp2_approx(row_max[r] - m_new);
        row_max[r] = m_new;
        row_sum[r] *= alpha_p[r];
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int r = (i >> 1) & 1;
        pp[i] = attn_hopper::exp2_approx(fmaf(s[i], p.scale_log2, -row_max[r]));
        row_sum[r] += pp[i];
      }
    }
    pv(n_tiles - 1);
    if (tid == 0) attn_hopper::bulk_wait_read();  // before the CTA may leave
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffff, row_sum[r], 2);
    }
    const int row = q0 + row0 + g;
    const bool ok0 = row < p.sq, ok8 = row + 8 < p.sq;
    float* dst = p.o + (static_cast<size_t>(batch) * p.sq + row) * p.c + head * p.d + col0;
    const float inv0 = 1.f / row_sum[0], inv8 = 1.f / row_sum[1];
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
      store_slab(dst + 32 * sl, p.c, o[sl], inv0, inv8, ok0, ok8, t, p.d - col0 - 32 * sl);
    if constexpr (kWriteLse) {
      if (chunk == 0 && t == 0) {
        float* l0 = p.lse + (static_cast<size_t>(batch) * p.sq + row) * p.heads + head;
        if (ok0) l0[0] = (row_max[0] + log2f(row_sum[0])) * kLn2;
        if (ok8) l0[static_cast<size_t>(8) * p.heads] = (row_max[1] + log2f(row_sum[1])) * kLn2;
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still write to its shared memory
}

template <bool kWriteLse>
int launch_fwd_cluster(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                       const ClusterParamsF32& p, int batch, cudaStream_t stream) {
  const int smem = cluster_smem_bytes_f32(p.chunks, p.stages);
  const auto kernel = attention_f32_fwd_cluster_kernel<kWriteLse>;
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((p.sq + 63) / 64 * p.chunks, p.heads, batch);
  return attn_hopper::launch_clustered(kernel, grid, kWideThreadsF32, smem, p.chunks, stream, mq,
                                       mk, mv, p);
}

// The wide f32 forward (d > 256, a multiple of 4) with a ring of `stages`:
// at 9 to 16 atoms the clustered kernel (chunks of two atoms), else the
// streaming one.
template <bool kWriteLse>
int forward_wide(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                 int sq, int sk, int heads, int d, int scale_dim, int stages,
                 cudaStream_t stream) {
  const int atoms = head_atoms(d), chunks = cluster_chunks_f32(atoms);
  const bool clustered = f32_clustered(atoms);
  CUtensorMap mq, mk, mv;
  int rc = head_map_f32(&mq, q, batch, sq, heads, d, 64);
  if (rc) return rc;
  if ((rc = head_map_f32(&mk, k, batch, sk, heads, d, kWideT))) return rc;
  if ((rc = head_map_f32(&mv, v, batch, sk, heads, d, kWideT))) return rc;
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(scale_dim)));
  if (clustered) {
    ClusterParamsF32 p{};
    p.o = static_cast<float*>(o);
    p.lse = lse;
    p.sq = sq;
    p.sk = sk;
    p.c = heads * d;
    p.d = d;
    p.heads = heads;
    p.chunks = chunks;
    p.stages = stages;
    p.scale_log2 = scale_log2;
    return launch_fwd_cluster<kWriteLse>(mq, mk, mv, p, batch, stream);
  }
  WideParamsF32 p{};
  p.o = static_cast<float*>(o);
  p.lse = lse;
  p.sq = sq;
  p.sk = sk;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.atoms = atoms;
  p.chunks = attn_hopper::wide_chunks(atoms);
  p.stages = stages;
  p.scale_log2 = scale_log2;
  return attn_hopper::wide_chunk_atoms(atoms) == 3
             ? launch_fwd_wide<3, kWriteLse>(mq, mk, mv, p, batch, stream)
             : launch_fwd_wide<4, kWriteLse>(mq, mk, mv, p, batch, stream);
}

// Shared memory of a forward launch with (nwg, bn, stages) at `da` atoms; 0
// for a launch there is no kernel for (wide heads: one warpgroup on
// kWideT-key tiles; the clustered kernel's ring as deep as
// cluster_stages_f32 gives, the streaming kernel's 2 to kMaxWideStages
// slots).
template <bool kCross>
int fwd_launch_smem(int da, int nwg, int bn, int stages) {
  if (da > attn_hopper::kNarrowAtoms) {
    if (nwg != 1 || bn != kWideT) return 0;
    const int chunks = cluster_chunks_f32(da);
    if (f32_clustered(da))
      return stages == cluster_stages_f32(chunks) ? cluster_smem_bytes_f32(chunks, stages) : 0;
    return stages >= 2 && stages <= attn_hopper::kMaxWideStages ? wide_smem_bytes(stages, false)
                                                                : 0;
  }
  return fwd_tile_ok<kCross>(da, nwg, bn) ? fwd_smem_bytes(da, nwg, bn, stages) : 0;
}

// The forward on (B, Sq, heads * d) q, (B, Sk, heads * d) k and v, f32,
// 16-byte aligned, d a multiple of 4, into o and, with kWriteLse, L, with
// the (nwg, bn, stages) of the wrapper's plan; 0 or an error code for
// hopper_host::error_string. A template, so that each library instantiates
// only the kernels it launches.
template <bool kWriteLse, bool kCross>
int forward(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int sq,
            int sk, int heads, int d, int scale_dim, int nwg, int bn, int stages,
            cudaStream_t stream) {
  const int da = head_atoms(d);
  if (batch < 1 || sq < 1 || sk < 1 || heads < 1 || !head_dim_ok(d, scale_dim) || stages < 1 ||
      fwd_launch_smem<kCross>(da, nwg, bn, stages) == 0 ||
      fwd_launch_smem<kCross>(da, nwg, bn, stages) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (da > attn_hopper::kNarrowAtoms)
    return forward_wide<kWriteLse>(q, k, v, o, lse, batch, sq, sk, heads, d, scale_dim, stages,
                                   stream);
  FwdParams p;
  p.o = static_cast<float*>(o);
  p.lse = lse;
  p.sq = sq;
  p.sk = sk;
  p.c = heads * d;
  p.d = d;
  p.heads = heads;
  p.stages = stages;
  p.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(scale_dim)));
  const auto s = stream;
  switch (da) {
    case 1:
      if constexpr (kCross) {
        if (bn == 80) return launch_fwd<1, 1, 80, kWriteLse>(q, k, v, p, batch, s);
      }
      return launch_fwd<1, 2, 64, kWriteLse>(q, k, v, p, batch, s);
    case 2: return launch_fwd<2, 2, 32, kWriteLse>(q, k, v, p, batch, s);
    case 3: return launch_fwd<3, 1, 32, kWriteLse>(q, k, v, p, batch, s);
    default: return launch_fwd<4, 1, 16, kWriteLse>(q, k, v, p, batch, s);
  }
}

}  // namespace
}  // namespace attn_f32
