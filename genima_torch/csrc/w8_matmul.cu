// Weight-only int8 matmul for Hopper (sm_90a): out = (x @ w_q^T) * scale.
//
// Replaces genima_tpu/kernels/w8_matmul.py::_w8_matmul_2d / _kernel (and
// w8_matmul_interpret, the same kernel body): x (M, K) bf16, w_q (N, K) int8
// (the nn.Linear layout, one row per output column), scale (N,) f32, out
// (M, N) bf16. The weights stay int8 in device and shared memory and are
// widened to bf16 in registers on their way into the tensor cores: no
// dequantised copy is ever written. The f32 scale is applied once, in the
// epilogue.
//
// What bounds it on the H100: 2*M*K*N operations on K*N + 2*M*K + 2*M*N
// bytes. On the serving path M is 64, 77, 256, 1024 or 4096 tokens; at
// M <= 256 the weight bytes bound it, and a call moves 0.3-13 MB, which is
// a few microseconds at 3.35 TB/s: the kernel has to fill all 132 SMs and
// keep enough weight bytes in flight on each, or latency sets its time.
//
// Design (one block per (64 weight rows, token tile, K split); a consumer
// warpgroup and a producer warp, two blocks an SM):
//   * swap-AB: the block computes out^T = W x^T. The 64 weight rows are
//     wgmma's A operand, so each int8 weight is loaded from shared memory
//     and widened by exactly one thread, in registers; the token tile (64,
//     80 or 128 tokens) is wgmma's N, read as B straight from shared
//     memory. At M = 4096 the same orientation runs with 128-token tiles
//     (the usual one would widen the weight into shared memory first);
//   * a ring of `stages` K tiles, 128 wide, filled by TMA behind mbarriers:
//     the producer warp issues the W box (64 x 128 int8) and two x boxes
//     (BT x 64 bf16 each), all 128-byte swizzled, and waits only on "empty"
//     barriers; the consumers wait on "full" barriers. Out-of-range rows
//     and columns arrive as zeros, so ragged M, N and K need no masks in
//     the main loop. A stage is two wgmma groups of four k16 steps with
//     their own A registers, so the warps widen one group's weights while
//     the tensor cores run the other's (wait_group 1);
//   * widening: a 32-bit word of four int8 values becomes four exact bf16
//     by byte permutes into the f32 magic number 2^23 + 128 + v, one
//     subtraction, and taking the high halves (|v| <= 127 is exact in bf16);
//   * split-K: `plan` in kernels/w8_matmul.py picks the token tile, a split
//     of the K tiles and the ring depth. Small-M calls split K until about
//     half a wave of blocks runs (measured: beyond that the partials cost
//     more than the extra blocks gain). With a split, each block writes its f32 partial tile to a workspace in
//     its own register order, takes a ticket from a per-tile counter, and
//     the block that takes the last ticket reads the partials back and sums
//     them in split order 0, 1, ..., so the result does not depend on which
//     block finishes last: two calls give the same bits. That block resets
//     the counter for the next call. No float atomics, no second launch;
//   * epilogue: * scale in f32, one rounding to bf16, staged through shared
//     memory so the (M, N) output is written in 16-byte rows, masked to M
//     and N.
// Every shape with K % 16 == 0 and N % 8 == 0 runs (TMA needs 16-byte row
// strides).
//
// Float32 x (w8_matmul_f32_kernel): the TPU kernel's body casts x to bf16
// before the product and accumulates in f32, and writes x's dtype. So here
// each f32 value of x is rounded to bf16 as the block loads it into shared
// memory (no cast pass over x in device memory), the product of a bf16 and
// an int8 value is exact in f32, sums are f32, the scale is applied once and
// out is f32. A simple tiled GEMM on the CUDA cores (FFMA): a block of 256
// threads owns 64 tokens x 64 weight rows, each thread 4 x 4, over K tiles
// of 32 held in shared memory 33 floats a row apart (so the rows a warp
// reads lie in distinct banks). No split, so two calls give the same bits.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 128;  // K per ring stage (the W box's 128-byte rows)

struct Params {
  const float* scale;
  __nv_bfloat16* out;
  float* ws;     // split > 1: [split][tiles][BN * BT] f32 partials
  int* tickets;  // split > 1: [tiles], zero between calls
  int m, n, k_tiles, split, stages;
};

// A block: one consumer warpgroup (64 weight rows) and one producer warp.
constexpr int BN = 64;
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;

template <int BT>
struct Cfg {
  static constexpr int kWBytes = BN * kBK;
  static constexpr int kXBox = BT * 128;  // BT rows x 64 bf16
  static constexpr int kStage = kWBytes + 2 * kXBox;
  static constexpr int kAcc = BT / 2;
  static constexpr int kStageRow = 72;  // bf16 per staged output row (64 + 8)
  static int smem_bytes(int stages) { return 1024 + stages * kStage + 16 * stages + 16; }
};

// Four int8 (bytes of w) as two bf16 pairs: lo = bytes 0, 1; hi = bytes 2, 3.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // v + 128, unsigned
  constexpr float kMagic = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kMagic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kMagic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kMagic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kMagic;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 2)
w8_matmul_kernel(const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_x, const Params p) {
  using C = Cfg<BT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * C::kStage);
  uint64_t* empty = full + p.stages;
  int* last_flag = reinterpret_cast<int*>(empty + p.stages);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BT;
  const int z = blockIdx.z;
  const int kt0 = static_cast<int>(static_cast<long long>(z) * p.k_tiles / p.split);
  const int kt1 = static_cast<int>(static_cast<long long>(z + 1) * p.k_tiles / p.split);

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

  if (warp == 4) {  // producer warp: keeps the ring full
    if (lane == 0) {
      prefetch_tensormap(&map_w);
      prefetch_tensormap(&map_x);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = smem + stage * C::kStage;
        mbar_expect_tx(&full[stage], C::kStage);
        tma_load_2d(st, &map_w, &full[stage], kt * kBK, n0);
        tma_load_2d(st + C::kWBytes, &map_x, &full[stage], kt * kBK, m0);
        tma_load_2d(st + C::kWBytes + C::kXBox, &map_x, &full[stage], kt * kBK + 64, m0);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroup: warp wq owns weight rows 16wq .. 16wq + 15
  const int ctid = threadIdx.x;  // 0 .. 127
  const int wq = warp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = wq * 16 + g;  // and row0 + 8; row0 % 8 == g

  const int col0 = n0 + row0;
  const float s0 = col0 < p.n ? p.scale[col0] : 0.f;
  const float s1 = col0 + 8 < p.n ? p.scale[col0 + 8] : 0.f;

  float acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
  fence_operands(acc);

  // Each stage is two groups of four k16 steps, each with its own A
  // registers: while the tensor cores run one group, the warps widen the
  // next one's weights. wait_group 1 after issuing a group retires the one
  // before it; its A registers are then free (fence_operands keeps the
  // compiler from reusing them earlier), and when that was a stage's second
  // group the stage goes back to the producer.
  uint32_t a0[4][4], a1[4][4];
  auto widen_half = [&](const uint8_t* ws, int half, uint32_t (&a)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ks = 4 * half + j;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // row row0 + 8r, K bytes 16ks + 2t, +1 and 16ks + 2t + 8, +9; the
        // 16-byte chunk ks sits at chunk ks ^ (row % 8) (128-byte swizzle)
        const uint8_t* rp = ws + (row0 + 8 * r) * kBK + ((ks ^ g) << 4) + 2 * t;
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(rp);
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(rp + 8);
        widen4(lo | (hi << 16), a[j][r], a[j][2 + r]);
      }
    }
  };
  auto mma_half = [&](const uint8_t* xs, int half, uint32_t (&a)[4][4]) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // x rows are K-major, 128-byte swizzled: 8-row groups 1024 bytes
      // apart; a k16 step inside a 64-wide box is 32 bytes further
      const uint64_t desc = make_desc(xs + half * C::kXBox + j * 32, 128, 16, 1024);
      wgmma_rs<BT, 0>(acc, a[j], desc);
    }
    wgmma_commit();
  };
  auto fence_a = [](uint32_t (&a)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[j][r])::"memory");
  };
  // hand a stage back: the group reading it has completed, so every warp
  // of this warpgroup has read its weights and x
  auto release = [&](int st) {
    if (wq == 0 && lane == 0) mbar_arrive(&empty[st]);
  };

  int stage = 0;
  uint32_t phase = 0;
  int prev = -1;  // the stage whose second group may still be running
  for (int kt = kt0; kt < kt1; ++kt) {
    mbar_wait(&full[stage], phase);
    const uint8_t* ws = smem + stage * C::kStage;
    const uint8_t* xs = ws + C::kWBytes;
    widen_half(ws, 0, a0);
    mma_half(xs, 0, a0);
    wgmma_wait<1>();
    fence_a(a1);
    if (prev >= 0) release(prev);
    widen_half(ws, 1, a1);
    mma_half(xs, 1, a1);
    wgmma_wait<1>();
    fence_a(a0);
    prev = stage;
    if (++stage == p.stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_a(a1);
  fence_operands(acc);

  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (p.split > 1) {
    // partial tile in register order: float4 i of thread ctid at
    // [i][ctid], so the stores and the loads below are coalesced
    float4* part = reinterpret_cast<float4*>(
        p.ws + (static_cast<size_t>(z) * tiles + tile) * (BN * BT));
#pragma unroll
    for (int i = 0; i < C::kAcc / 4; ++i)
      part[i * kConsumers + ctid] =
          make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    __threadfence();
    named_barrier(1, kConsumers);
    if (ctid == 0) *last_flag = atomicAdd(&p.tickets[tile], 1) == p.split - 1;
    named_barrier(1, kConsumers);
    if (!*last_flag) return;
    __threadfence();
    // the sum in split order 0, 1, ..., whichever block got here; each
    // split's partial is read whole (its loads in flight together)
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
    for (int s = 0; s < p.split; ++s) {
      const float4* src = reinterpret_cast<const float4*>(
          p.ws + (static_cast<size_t>(s) * tiles + tile) * (BN * BT)) + ctid;
      float4 v[C::kAcc / 4];
#pragma unroll
      for (int i = 0; i < C::kAcc / 4; ++i) v[i] = __ldcg(src + i * kConsumers);
#pragma unroll
      for (int i = 0; i < C::kAcc / 4; ++i) {
        acc[4 * i] += v[i].x;
        acc[4 * i + 1] += v[i].y;
        acc[4 * i + 2] += v[i].z;
        acc[4 * i + 3] += v[i].w;
      }
    }
    if (ctid == 0) p.tickets[tile] = 0;
  }

  // epilogue: the ring is done with, so stage the bf16 tile (BT tokens x
  // 64 columns) in it, then write 16-byte rows
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) {
    const int tok = 8 * (i >> 2) + 2 * t + (i & 1);
    const int half = (i >> 1) & 1;
    st[tok * C::kStageRow + wq * 16 + g + 8 * half] = __float2bfloat16_rn(acc[i] * (half ? s1 : s0));
  }
  named_barrier(1, kConsumers);
  for (int idx = ctid; idx < BT * 8; idx += kConsumers) {
    const int tok = idx >> 3, c8 = (idx & 7) * 8;
    const int gm = m0 + tok, gn = n0 + c8;
    if (gm < p.m && gn < p.n)
      *reinterpret_cast<uint4*>(p.out + static_cast<size_t>(gm) * p.n + gn) =
          *reinterpret_cast<const uint4*>(st + tok * C::kStageRow + c8);
  }
}

template <int BT>
int launch(const CUtensorMap& map_w, const CUtensorMap& map_x, const Params& p,
           cudaStream_t stream) {
  using C = Cfg<BT>;
  const int smem = C::smem_bytes(p.stages);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8_matmul_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BT - 1) / BT, p.split);
  w8_matmul_kernel<BT><<<grid, kThreads, smem, stream>>>(map_w, map_x, p);
  return static_cast<int>(cudaGetLastError());
}

// --- float32 x ------------------------------------------------------------------

constexpr int kF32Tile = 64;   // tokens and weight rows a block
constexpr int kF32K = 32;      // K a shared-memory tile
constexpr int kF32Ld = kF32K + 1;

__global__ void __launch_bounds__(256) w8_matmul_f32_kernel(const float* __restrict__ x,
                                                            const int8_t* __restrict__ w_q,
                                                            const float* __restrict__ scale,
                                                            float* __restrict__ out, int m,
                                                            int n, int k) {
  __shared__ float xs[kF32Tile * kF32Ld];
  __shared__ float ws[kF32Tile * kF32Ld];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kF32Tile, m0 = blockIdx.y * kF32Tile;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kF32K) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kF32Tile * kF32K; idx += 256) {
      const int r = idx / kF32K, kk = idx % kF32K, kc = k0 + kk;
      const int row = m0 + r, col = n0 + r;
      xs[r * kF32Ld + kk] =
          row < m && kc < k
              ? __bfloat162float(__float2bfloat16_rn(x[static_cast<size_t>(row) * k + kc]))
              : 0.f;
      ws[r * kF32Ld + kk] =
          col < n && kc < k ? static_cast<float>(w_q[static_cast<size_t>(col) * k + kc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kF32K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = xs[(ty + 16 * r) * kF32Ld + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ws[(tx + 16 * c) * kF32Ld + kk];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty + 16 * r;
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + tx + 16 * c;
      if (col < n) out[static_cast<size_t>(row) * n + col] = acc[r][c] * scale[col];
    }
  }
}

}  // namespace

extern "C" {

// out (M, N) bf16 = (x (M, K) bf16 @ w_q (N, K) int8 ^T) * scale (N,) f32,
// with the tile (bt tokens, 64 weight rows), split and ring depth of
// kernels/w8_matmul.py::plan. ws and tickets: a per-device workspace of
// split * tiles * 64 * bt floats and a zeroed counter per tile (unused
// when split == 1). Needs K % 16 == 0, N % 8 == 0 and 16-byte aligned
// pointers (the wrapper checks). Launches on `stream`, does not
// synchronise; returns 0 or an error code for w8_matmul_error_string.
int w8_matmul(const void* x, const void* w_q, const void* scale, void* out, int m, int n, int k,
              int bt, int split, int stages, void* ws, void* tickets, void* stream) {
  CUtensorMap map_w, map_x;
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t w_box[2] = {kBK, BN};
  int rc = hopper_host::encode(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w_q, w_dims, w_strides,
                               w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t x_box[2] = {64, static_cast<cuuint32_t>(bt)};
  rc = hopper_host::encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, x_strides,
                           x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  Params p;
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int*>(tickets);
  p.m = m;
  p.n = n;
  p.k_tiles = (k + kBK - 1) / kBK;
  p.split = split;
  p.stages = stages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a stage goes back to the producer only after the next one's first
  // group is issued: more than one K tile a split needs two stages
  if (split < 1 || split > p.k_tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (stages < ((p.k_tiles + split - 1) / split > 1 ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bt == 64) return launch<64>(map_w, map_x, p, s);
  if (bt == 80) return launch<80>(map_w, map_x, p, s);
  if (bt == 128) return launch<128>(map_w, map_x, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory a block of the bt-token kernel asks for at `stages`.
int w8_matmul_smem_bytes(int bt, int stages) {
  return 1024 + stages * (BN * kBK + 2 * bt * 128) + 16 * stages + 16;
}

// out (M, N) f32 = (bf16(x) (M, K) f32 @ w_q (N, K) int8 ^T) * scale (N,)
// f32, any M, N, K >= 1. Launches on `stream`, does not synchronise; returns
// 0 or an error code for w8_matmul_error_string.
int w8_matmul_f32(const void* x, const void* w_q, const void* scale, void* out, int m, int n,
                  int k, void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kF32Tile - 1) / kF32Tile, (m + kF32Tile - 1) / kF32Tile);
  w8_matmul_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(scale), static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// Static shared memory of a block of the f32 kernel.
int w8_matmul_f32_smem_bytes() { return 2 * kF32Tile * kF32Ld * 4; }

const char* w8_matmul_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
