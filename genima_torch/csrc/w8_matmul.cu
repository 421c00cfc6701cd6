// Weight-only int8 matmul for Hopper (sm_90a): out = (x @ w_q^T) * scale.
//
// Replaces genima_tpu/kernels/w8_matmul.py::_w8_matmul_2d / _kernel (and
// w8_matmul_interpret, the same kernel body): x (M, K) bf16 or f32, w_q
// (N, K) int8 (the nn.Linear layout, one row per output column), scale (N,)
// f32, out (M, N) in x's dtype. The TPU body casts x and w to bf16 and sums
// in f32; a bf16 x int8 product is exact in f32, so the bf16 tensor cores
// compute that sum exactly up to the order of the additions. The weights
// stay int8 in device and shared memory and are widened to bf16 in
// registers on their way into the tensor cores: no dequantised copy is ever
// written. The f32 scale is applied once, in the epilogue.
//
// What bounds it on the H100: 2*M*K*N operations on K*N + e*M*K + e*M*N
// bytes (e = 2 for bf16 x, 4 for f32). On the serving path M is 64, 77,
// 256, 1024 or 4096 tokens; at M <= 256 the weight bytes bound it, and a
// call moves 0.3-13 MB, which is a few microseconds at 3.35 TB/s: the
// kernel has to fill all 132 SMs and keep enough weight bytes in flight on
// each, or latency sets its time.
//
// Design (one block per (64 weight rows, token tile, K split); a consumer
// warpgroup and a producer warp, two blocks an SM where shared memory
// allows):
//   * swap-AB: the block computes out^T = W x^T. The 64 weight rows are
//     wgmma's A operand, so each int8 weight is loaded from shared memory
//     and widened by exactly one thread, in registers; the token tile (64,
//     80 or 128 tokens) is wgmma's N, read as B straight from shared
//     memory. At M = 4096 the same orientation runs with 128-token tiles
//     (the usual one would widen the weight into shared memory first);
//   * a ring of `stages` K tiles, 128 wide, filled by TMA behind mbarriers:
//     the producer warp issues the W box (64 x 128 int8) and the x boxes
//     (two of BT x 64 bf16, or four of BT x 32 f32), all 128-byte swizzled,
//     and waits only on "empty" barriers; the consumers wait on "full"
//     barriers. Out-of-range rows and columns arrive as zeros, so ragged M,
//     N and K need no masks in the main loop. A stage is two wgmma groups of
//     four k16 steps with their own A registers, so the warps widen one
//     group's weights while the tensor cores run the other's (wait_group 1);
//   * f32 x: TMA copies without converting, so the consumers round the
//     stage's f32 x to bf16 (round to nearest even, the TPU body's cast) in
//     place, into the two bf16 boxes the bf16 kernel reads, then fence the
//     async proxy and meet at a named barrier before the stage's first
//     wgmma. This overlaps the previous stage's second group, and there is
//     no cast pass over x in device memory and no second launch. The f32
//     stage is twice the bf16 one's x bytes, so f32 x takes 64- or
//     80-token tiles, two blocks an SM (128-token ones fit one an SM and
//     measured up to 2x slower);
//   * widening: a 32-bit word of four int8 values becomes four exact bf16
//     by byte permutes into the f32 magic number 2^23 + 128 + v, one
//     subtraction, and taking the high halves (|v| <= 127 is exact in bf16);
//   * split-K: `plan` in kernels/w8_matmul.py picks the token tile, a split
//     of the K tiles and the ring depth. Small-M calls split K until about
//     half a wave of blocks runs (bf16, measured: beyond that the partials
//     cost more than the extra blocks gain; f32 splits up to 8 ways). With a
//     split, each block writes its f32 partial tile to a workspace in its
//     own register order, takes a ticket from a per-tile counter, and the
//     block that takes the last ticket reads the partials back and sums
//     them in split order 0, 1, ..., so the result does not depend on which
//     block finishes last: two calls give the same bits. That block resets
//     the counter for the next call. No float atomics, no second launch;
//   * epilogue: * scale in f32, then one rounding to bf16 (bf16 x) or none
//     (f32 x), staged through shared memory so the (M, N) output is written
//     in 16-byte rows, masked to M and N.
// Every shape with K % 16 == 0 and N % 8 == 0 runs (TMA needs 16-byte row
// strides).

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 128;  // K per ring stage (the W box's 128-byte rows)

struct Params {
  const float* scale;
  void* out;     // (M, N) in x's dtype
  float* ws;     // split > 1: [split][tiles][BN * BT] f32 partials
  int* tickets;  // split > 1: [tiles], zero between calls
  int m, n, k_tiles, split, stages;
};

// A block: one consumer warpgroup (64 weight rows) and one producer warp.
constexpr int BN = 64;
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;

// BT tokens a tile; F32: x arrives as f32 (four boxes of 32 values a
// stage) instead of bf16 (two boxes of 64)
template <int BT, bool F32>
struct Cfg {
  static constexpr int kWBytes = BN * kBK;
  static constexpr int kXBox = BT * 128;  // BT rows of 128 bytes
  static constexpr int kXBoxes = F32 ? 4 : 2;
  static constexpr int kXBoxK = kBK / kXBoxes;  // K a box
  static constexpr int kStage = kWBytes + kXBoxes * kXBox;
  static constexpr int kAcc = BT / 2;
  // elements per staged output row: 64 and 16 bytes of padding
  static constexpr int kStageRow = F32 ? 68 : 72;
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

// Round a stage's f32 x (four boxes of BT rows x 32 values) to bf16 in
// place, into the two boxes of BT rows x 64 values that the bf16 kernel
// reads (boxes 0 and 1), round to nearest even as __float2bfloat16_rn. An
// item is 8 consecutive K of one token row: two 16-byte f32 chunks in, one
// 16-byte bf16 chunk out, each at its 128-byte swizzled place (chunk c of
// row r sits at c ^ (r % 8)). A warp pass takes two row pairs (r, r ^ 5)
// of one 8-row group and 4 chunks of each row, so the 8 lanes of a
// quarter-warp read 8 distinct 16-byte places of a row span and write 8
// distinct places: no bank conflicts. Boxes 0 and 1 are overwritten only
// after every consumer has read them (the first named barrier); the second
// makes the bf16 tile whole, and visible to wgmma, before any warp issues.
template <int BT>
__device__ __forceinline__ void round_x_to_bf16(uint8_t* xs, int wq, int lane) {
  constexpr int kPasses = BT / 16;  // BT / 2 row pairs, 8 a pass of the warpgroup
  const int q = lane & 3, rs = (lane >> 2) & 1, jj = (lane >> 3) & 1, pp = lane >> 4;
  uint32_t v[kPasses][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int pair = 8 * i + 2 * wq + pp;
      const int u = pair & 3;
      const int row = 8 * (pair >> 2) + (rs ? u ^ 5 : u);
      // bf16 chunk 4 jj + q of half h: f32 box 2h + jj, its chunks 2q, 2q + 1
      const uint8_t* src = xs + (2 * h + jj) * (BT * 128) + row * 128;
      const float4 lo = *reinterpret_cast<const float4*>(src + (((2 * q) ^ (row & 7)) << 4));
      const float4 hi = *reinterpret_cast<const float4*>(src + (((2 * q + 1) ^ (row & 7)) << 4));
      const __nv_bfloat162 b[4] = {__floats2bfloat162_rn(lo.x, lo.y), __floats2bfloat162_rn(lo.z, lo.w),
                                   __floats2bfloat162_rn(hi.x, hi.y), __floats2bfloat162_rn(hi.z, hi.w)};
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][e] = *reinterpret_cast<const uint32_t*>(&b[e]);
    }
    if (h == 0) named_barrier(1, kConsumers);  // boxes 0 and 1 read by every consumer
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int pair = 8 * i + 2 * wq + pp;
      const int u = pair & 3;
      const int row = 8 * (pair >> 2) + (rs ? u ^ 5 : u);
      *reinterpret_cast<uint4*>(xs + h * (BT * 128) + row * 128 + (((4 * jj + q) ^ (row & 7)) << 4)) =
          make_uint4(v[i][0], v[i][1], v[i][2], v[i][3]);
    }
  }
  fence_proxy_async();
  named_barrier(1, kConsumers);
}

template <int BT, bool F32>
__global__ void __launch_bounds__(kThreads, 2)
w8_matmul_kernel(const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_x, const Params p) {
  using C = Cfg<BT, F32>;
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
#pragma unroll
        for (int j = 0; j < C::kXBoxes; ++j)
          tma_load_2d(st + C::kWBytes + j * C::kXBox, &map_x, &full[stage],
                      kt * kBK + j * C::kXBoxK, m0);
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
    uint8_t* ws = smem + stage * C::kStage;
    uint8_t* xs = ws + C::kWBytes;
    if constexpr (F32) round_x_to_bf16<BT>(xs, wq, lane);
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

  // epilogue: the ring is done with, so stage the tile (BT tokens x 64
  // columns) in it, then write 16-byte rows
  using Out = typename std::conditional<F32, float, __nv_bfloat16>::type;
  constexpr int kVec = 16 / sizeof(Out);  // outputs a 16-byte store
  Out* st = reinterpret_cast<Out*>(smem);
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) {
    const int tok = 8 * (i >> 2) + 2 * t + (i & 1);
    const int half = (i >> 1) & 1;
    const float v = acc[i] * (half ? s1 : s0);
    if constexpr (F32)
      st[tok * C::kStageRow + wq * 16 + g + 8 * half] = v;
    else
      st[tok * C::kStageRow + wq * 16 + g + 8 * half] = __float2bfloat16_rn(v);
  }
  named_barrier(1, kConsumers);
  Out* out = static_cast<Out*>(p.out);
  for (int idx = ctid; idx < BT * (BN / kVec); idx += kConsumers) {
    const int tok = idx / (BN / kVec), cv = (idx % (BN / kVec)) * kVec;
    const int gm = m0 + tok, gn = n0 + cv;
    if (gm < p.m && gn < p.n)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(gm) * p.n + gn) =
          *reinterpret_cast<const uint4*>(st + tok * C::kStageRow + cv);
  }
}

template <int BT, bool F32>
int launch(const CUtensorMap& map_w, const CUtensorMap& map_x, const Params& p,
           cudaStream_t stream) {
  const int smem = Cfg<BT, F32>::smem_bytes(p.stages);
  static int configured = 0;  // the largest dynamic shared memory set so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8_matmul_kernel<BT, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BT - 1) / BT, p.split);
  w8_matmul_kernel<BT, F32><<<grid, kThreads, smem, stream>>>(map_w, map_x, p);
  return static_cast<int>(cudaGetLastError());
}

// Both entry points: x is bf16, or f32 with F32.
template <bool F32>
int run(const void* x, const void* w_q, const void* scale, void* out, int m, int n, int k, int bt,
        int split, int stages, void* ws, void* tickets, void* stream) {
  constexpr int kElem = F32 ? 4 : 2;
  CUtensorMap map_w, map_x;
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t w_box[2] = {kBK, BN};
  int rc = hopper_host::encode(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w_q, w_dims, w_strides,
                               w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(k) * kElem};
  const cuuint32_t x_box[2] = {128 / kElem, static_cast<cuuint32_t>(bt)};
  rc = hopper_host::encode(&map_x,
                           F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           2, x, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  Params p;
  p.scale = static_cast<const float*>(scale);
  p.out = out;
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
  if (bt == 64) return launch<64, F32>(map_w, map_x, p, s);
  if (bt == 80) return launch<80, F32>(map_w, map_x, p, s);
  if constexpr (!F32) {  // f32 x at 128 tokens took one block an SM and measured 2x slower
    if (bt == 128) return launch<128, F32>(map_w, map_x, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
  return run<false>(x, w_q, scale, out, m, n, k, bt, split, stages, ws, tickets, stream);
}

// The same on f32 x into f32 out: out = (bf16(x) @ w_q^T) * scale, x
// rounded to bf16 inside the kernel (plan(..., f32=True)).
int w8_matmul_f32(const void* x, const void* w_q, const void* scale, void* out, int m, int n,
                  int k, int bt, int split, int stages, void* ws, void* tickets, void* stream) {
  return run<true>(x, w_q, scale, out, m, n, k, bt, split, stages, ws, tickets, stream);
}

// Shared memory a block of the bt-token kernel asks for at `stages`.
int w8_matmul_smem_bytes(int bt, int stages) {
  return 1024 + stages * (BN * kBK + 2 * bt * 128) + 16 * stages + 16;
}

// The same for the f32-x kernel (four x boxes a stage).
int w8_matmul_f32_smem_bytes(int bt, int stages) {
  return 1024 + stages * (BN * kBK + 4 * bt * 128) + 16 * stages + 16;
}

const char* w8_matmul_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
