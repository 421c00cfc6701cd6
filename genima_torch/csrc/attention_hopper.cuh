// Device helpers of the Hopper attention kernels (the forward in
// attention_fwd_hopper.cuh, B2b's backward in packed_attention_bwd.cu):
// operands of wgmma m64nNk16 with A in registers and B a 128-byte-swizzled
// tile of 64-wide bf16 rows in shared memory, as TMA writes it.
//
// Head dims: a head of d columns (a multiple of 8) is handled as ceil(d / 64)
// atoms of 64 columns. Up to four atoms (d <= 256) the atom count is the
// kernels' template parameter DA and d itself a runtime value; above four
// the wide kernels keep O for the whole head in two warpgroups of three
// atoms (the paired forward, five or six atoms) or read the head atom by
// atom through a ring and keep O for one chunk of at most four atoms a
// block (wide_chunks below); the wide backward keeps dQ, dK or dV for up
// to ten atoms a block in two warpgroups (packed_attention_bwd.cu); their
// atom count a runtime value: no d is too wide. (A head dim
// that is not a multiple of 8 reaches the kernels zero-padded to the next
// one by the wrappers, since TMA needs 16-byte row strides; the scale
// follows the real head dim, `scale_dim`.)
// In the narrow kernels an atom's TMA box at column h * d + 64 * a
// reaches into the next head's columns (and past C, where TMA zero-fills):
// every product that contracts over d sees zeros there, because one of its
// operands has its columns d..64 * DA zeroed (zero_tail in shared memory,
// or a masked load_a_global into registers), and the columns past d of a
// product's output are computed and never stored (store_acc's `cols`). So
// d = 40 and 80 compute on 1.6x the columns they need, d = 160 on 1.2x,
// d = 200 on 1.28x. A
// non-finite value in the next head's columns still reaches this head's
// sums (0 * inf): such a value makes that head's own output non-finite too.
// The wide kernels' 4-D maps (head_map) bring zeros past d instead: there
// is nothing to zero or mask, and no other head's value reaches a sum.
//
// Layouts (lane = 4 * g + t, warp w of a warpgroup owns rows 16w..16w+15):
//   A fragment (16 x 16 bf16 a warp): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
//                                     a2 = (g, 2t+8..),   a3 = (g+8, 2t+8..)
//   D accumulator (16 x N f32 a warp, N / 2 values a thread): d[i] is row
//     g + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2t + (i & 1).
// So accumulator columns 16kk..16kk+15, rounded to bf16, are exactly the A
// fragment of k-step kk of a product whose K runs over those columns
// (acc_to_a): P = softmax(S) feeds P V, and P^T, dS^T feed dV, dK, without
// leaving the registers.
//
// A tile of R rows x 64 bf16 (128 bytes a row), 128-byte swizzled (16-byte
// chunk c of row r at chunk c ^ (r % 8)), 1024-byte aligned, is read two
// ways:
//   * K-major (desc_k): as the B operand of X Y^T, the 64 columns are the
//     contraction; k-step kk starts 32 bytes further, 8-row groups 1024 B
//     apart;
//   * MN-major (desc_mn): as the B operand of X Y, the R rows are the
//     contraction; k-step kk starts 16 rows (2048 B) further.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace attn_hopper {

constexpr int kAtom = 64;                // columns of a head atom
constexpr int kRowBytes = kAtom * 2;     // one 64-wide bf16 row: the swizzle span
constexpr int kNarrowAtoms = 4;  // the most atoms a block holds O for: d <= 256
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;  // the JAX kernels' _NEG_INF

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return hopper::make_desc(static_cast<const uint8_t*>(tile) + kk * 32, 128, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return hopper::make_desc(static_cast<const uint8_t*>(tile) + kk * 16 * kRowBytes, 128,
                           64 * kRowBytes, 1024);
}

// Atoms of a head of d columns, on the host.
inline int head_atoms(int d) { return (d + kAtom - 1) / kAtom; }

// Whether the kernels take heads of d columns, scaled by 1 / sqrt(scale_dim):
// d a multiple of 8, scale_dim the real head dim it pads (d itself, or up to
// 7 columns fewer).
inline bool head_dim_ok(int d, int scale_dim) {
  return d >= 8 && d % 8 == 0 && scale_dim <= d && scale_dim > d - 8;
}

// The streaming wide forwards (heads of more than four atoms): O's columns
// in wide_chunks(atoms) chunks of wide_chunk_atoms(atoms) atoms, three or
// four, one chunk a block; S summed over every atom in each. Mirrored by
// kernels/flash_attention.py::wide_chunking.
inline int wide_chunks(int atoms) { return (atoms + kNarrowAtoms - 1) / kNarrowAtoms; }
inline int wide_chunk_atoms(int atoms) {
  return (atoms + wide_chunks(atoms) - 1) / wide_chunks(atoms);
}
// Their ring: slots of four 64-row atom tiles (bf16; 32 KB), two at least
// (a block holds one slot across key tiles), as many as the plans give.
constexpr int kWideSlot = 4 * 64 * kRowBytes;
constexpr int kMaxWideStages = 6;

// A (d, heads, S, B) map of a packed (B, S, heads * d) bf16 tensor with a
// (64, 1, rows, 1) box, for the wide kernels: a box's columns at or past d
// (the next head's in memory) and rows at or past S come in as TMA's zeros,
// so every sum over d sees zeros there with no masking in the kernel.
inline int head_map(CUtensorMap* map, const void* x, int batch, int s, int heads, int d,
                    int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(heads) * d * 2,
                                 static_cast<cuuint64_t>(s) * heads * d * 2};
  const cuuint32_t box[4] = {kAtom, 1, static_cast<cuuint32_t>(rows), 1};
  return hopper_host::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

// A fragments of a warp's 16 rows x 64 columns of a packed tensor, straight
// from global memory (row stride ld elements; `rows` points at row 0);
// columns at or past `cols` (a multiple of 8) are neither read nor kept:
// they are zero.
__device__ __forceinline__ void load_a_global(uint32_t frag[4][4], const __nv_bfloat16* rows,
                                              int ld, int g, int t, int cols) {
  const __nv_bfloat16* p0 = rows + static_cast<size_t>(g) * ld + t * 2;
  const __nv_bfloat16* p8 = p0 + static_cast<size_t>(8) * ld;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bool lo = kk * 16 < cols, hi = kk * 16 + 8 < cols;
    frag[kk][0] = lo ? *reinterpret_cast<const uint32_t*>(p0 + kk * 16) : 0u;
    frag[kk][1] = lo ? *reinterpret_cast<const uint32_t*>(p8 + kk * 16) : 0u;
    frag[kk][2] = hi ? *reinterpret_cast<const uint32_t*>(p0 + kk * 16 + 8) : 0u;
    frag[kk][3] = hi ? *reinterpret_cast<const uint32_t*>(p8 + kk * 16 + 8) : 0u;
  }
}

// Zero columns cols..63 (cols a multiple of 8) of `rows` rows of a
// 128-byte-swizzled tile of 64-wide bf16 rows (1024-byte aligned), by the
// `threads` threads numbered `tid`. Generic-proxy writes: the caller fences
// them for the async proxy (fence_proxy_async) and syncs its threads before
// a wgmma reads the tile.
__device__ __forceinline__ void zero_tail(uint8_t* tile, int rows, int cols, int tid,
                                          int threads) {
  const int c0 = cols / 8, n = 8 - c0;  // 16-byte chunks to clear a row
  for (int i = tid; i < rows * n; i += threads) {
    const int r = i / n, c = c0 + i % n;
    *reinterpret_cast<uint4*>(tile + r * kRowBytes + ((c ^ (r & 7)) << 4)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Accumulator columns 16kk..16kk+15 as a bf16 A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float* d, int kk) {
  a[0] = pack_bf16x2(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

// Keep A fragments alive (and unmoved) up to this point: an issued wgmma
// reads them until a wait_group retires it.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

// Rows g and g + 8 of a warp's 16 x 64 f32 accumulator, times inv0 / inv8,
// as bf16 into a packed tensor at `rows` (row stride ld), each row only if
// its flag is set, columns at or past `cols` (a multiple of 8) never.
__device__ __forceinline__ void store_acc(__nv_bfloat16* rows, int ld, const float* d, float inv0,
                                          float inv8, bool ok0, bool ok8, int g, int t,
                                          int cols) {
  __nv_bfloat16* o0 = rows + static_cast<size_t>(g) * ld + t * 2;
  __nv_bfloat16* o8 = o0 + static_cast<size_t>(8) * ld;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j * 8 >= cols) continue;
    if (ok0)
      *reinterpret_cast<uint32_t*>(o0 + j * 8) = pack_bf16x2(d[4 * j] * inv0, d[4 * j + 1] * inv0);
    if (ok8)
      *reinterpret_cast<uint32_t*>(o8 + j * 8) = pack_bf16x2(d[4 * j + 2] * inv8, d[4 * j + 3] * inv8);
  }
}

// Tie an accumulator reached through a pointer to this point of the
// program, as hopper::fence_operands does for an array.
template <int N>
__device__ __forceinline__ void fence_acc(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// --- thread-block clusters (the wide forwards) -------------------------------
//
// The CTAs of a cluster run on neighbouring SMs and reach each other's
// shared memory: the wide forwards' key splits merge their O through it
// once a launch, and the clustered f32 forward pushes its partial scores
// into its peers' buffers with a bulk copy, which completes bytes on an
// mbarrier in the peer's shared memory, each CTA waiting on its own
// barrier, as for a TMA load. (st.async of 16 bytes a thread, one barrier
// update each, took 2.6-7.5 ns an update on the H100.)

// This CTA's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of this CTA's shared address `addr` in the
// CTA of rank `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Every thread of every CTA of the cluster arrives (releasing its earlier
// writes) and waits for all (acquiring theirs). No thread of a clustered
// kernel returns before its last cluster_sync.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// `bytes` (a multiple of 16) of this CTA's shared memory at `src` to the
// shared::cluster address `dst` in a peer CTA, by the bulk-copy engine,
// completing `bytes` of transaction on the peer's mbarrier at `bar` (a
// shared::cluster address): one transaction, where st.async takes one a 16
// bytes. The caller fences its generic writes of `src` for the async proxy
// first (fence_proxy_async) and commits the copy (bulk_commit).
__device__ __forceinline__ void bulk_copy_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's committed bulk copies have read their sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// 16 bytes from the shared::cluster address `addr` (a peer CTA's shared
// memory).
__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Wait until this CTA's barrier's phase with parity `parity` has completed,
// acquiring at cluster scope what peers' copies wrote before completing it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = hopper::smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The wide forwards' key ranges: split s of `splits` takes key tiles
// [s * tiles / splits, (s + 1) * tiles / splits).
__host__ __device__ __forceinline__ int split_begin(int s, int tiles, int splits) {
  return s * tiles / splits;
}

// A launch of `kernel` over `grid` in clusters of `cluster` blocks along x;
// 0 or an error code.
template <class Kernel, class... Args>
int launch_clustered(Kernel kernel, dim3 grid, int threads, int smem, int cluster,
                     cudaStream_t stream, const Args&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_hopper
