// Fused GroupNorm-affine + SiLU + 3x3 conv (+ 1x1 skip, + residual) for
// Hopper (sm_90a), NHWC bf16:
//
//   y = conv3x3(silu(x * scale + shift)) + b [+ x @ wskip] [+ residual]
//
// Replaces genima_tpu/kernels/fused_conv.py::_forward / _band_kernel. scale
// and shift are the per-(batch, channel) folded GroupNorm (fold_group_norm,
// plain PyTorch as it is plain XLA in JAX); without them the conv reads x
// as it is. x (B, H, W, C), w (9, C, Opad) (HWIO with the output channels
// padded to a multiple of 8), b (O,) f32, wskip (C, Opad), residual and y
// (B, H, W, O). f32 accumulation, one bf16 rounding of y.
//
// What bounds it on the H100: 2*B*H*W*O*(9C [+ C]) operations on the x, y
// [and residual] bytes. At the SD decoder's widths (C, O >= 128) the tensor
// cores bound it, so the kernel has to keep them busy: loads, the
// activation and the MMAs must overlap, and the MMAs must be wgmma, which
// mma.sync cannot match on this card. conv_out (O = 3) is bound by reading
// its 128-channel input.
//
// Design: an implicit GEMM. A tile is 64 output columns by `rows` image
// rows (one consumer warpgroup each) by BN output channels: 128 x 2 rows,
// or 16 x 4 rows for conv_out. Its input channels are walked in chunks of
// 64. The grid is persistent: one block per SM takes every gridDim-th tile,
// so the next tile's band and weights load while the current tile's
// epilogue runs. Warp-specialised:
//   * one producer warp keeps two rings full with TMA behind mbarriers: the
//     halo band of a chunk, (rows + 2) x (64 + 2) pixels x 64 channels (two
//     stages), and the chunk's per-tap weight tiles, 64 x BN (four stages;
//     the skip's tile first when there is one, then taps 0..8). TMA
//     zero-fills pixels outside the image, which is the conv's padding, and
//     channels past C; the band is 128-byte swizzled, so the shifted
//     ldmatrix windows below are free of bank conflicts;
//   * the consumer warpgroups wait on "full" barriers only. Per chunk: the
//     1x1 skip's K-slice on the raw band's centre; then the GroupNorm affine
//     and SiLU applied to the band in place, once per element, split
//     between all consumer threads, leaving out-of-image pixels and
//     channels past C at 0 (silu(shift) is not 0, and the conv pads the
//     activated image with zeros); then the nine taps. A tap's A operand is
//     the band shifted by (di, dj), which a shared-memory descriptor cannot
//     express, so each warp loads it with ldmatrix (one row address per
//     lane) into registers, and wgmma m64nBNk16 takes A from registers and
//     the weight tile (MN-major, 128-byte swizzled; 32 for BN = 16) from
//     shared memory. Two sets of A registers alternate, so a warp loads the
//     next tap's window while the tensor cores run the current one (wgmma
//     wait_group 1). Each weight stage is handed back when its group
//     completes, the band when the chunk is done: one barrier wait per
//     stage, and block-wide barriers only around the activation;
//   * epilogue: + bias [+ residual] in f32, one rounding, masked to the
//     image and to the O real channels.
// Why BN = 128 and not 256 (which would activate each band once per 256
// output channels instead of 128): measured slower at every decoder shape.
// ptxas gives a 288-thread block at most 168 registers, and the 128
// accumulators of an m64n256 tile then spill; the SiLU a band repeats per
// column block is a small part of the time. conv_out takes four rows:
// with 16 channels a tap's MMA is short, and four warpgroups hide the
// per-tap latency that two do not.
//
// Not ported from the TPU kernel: its routing to XLA for C % 128 != 0 or
// O < 128 (a lane-alignment rule of the TPU's DMA and VMEM), its split of
// the output channels when a band overflows VMEM, and its row-band height
// search.
//
// Float32 (fused_conv3x3_f32_kernel): the TPU kernel takes x's dtype, so on
// f32 x, w, residual and y it computes the same function in f32 (activation
// and sums in f32, each product to f32's accuracy). One TF32 pass on the
// tensor cores reads ~1e-3, so every product is split: a = a_big + a_small
// with a_big = tf32(a) and a_small = tf32(a - a_big), and a * b is summed as
// a_small * b_big + a_big * b_small + a_big * b_big (3xTF32, ~1e-6; the
// dropped a_small * b_small is 2^-22 of a * b). Bound: 2*B*H*W*O*(9C [+ C])
// operations at a third of the TF32 rate, 495 / 3 = 165 TFLOP/s, which is
// 2.5x FFMA's 67. The same structure as the bf16 kernel, with these
// changes:
//   * tf32 wgmma takes B only K-major, so the wrapper hands the kernel the
//     weights as (9, O, C) (and the skip as (O, C)); a weight box is BN
//     output channels x 32 input channels, 128-byte swizzled rows, whose
//     descriptor steps 32 bytes a k8 step. The producer is a warpgroup: one
//     warp issues the TMA loads, the other three round each landed weight
//     stage to tf32 in place and write the remainder's tf32 beside it (the
//     "small" tile), fence the async proxy and arrive on the stage's "ready"
//     barrier, which the consumers wait on instead of "full". No split
//     weight copy is made in device memory, so the L2 reads of weights stay
//     those of one f32 tile a tap, and the consumers meet at no barrier per
//     tap. With two consumer warpgroups, setmaxnreg moves registers from the
//     producer warpgroup (40) to the consumers (232);
//   * the band is 32 input channels of f32 a chunk (128 bytes a pixel, the
//     same 128-byte swizzle), so the shifted windows come in with the same
//     ldmatrix: on 32-bit data an 8x8 b16 matrix is 8 pixels x 4 channels,
//     and matrices (pixels 0-7 | 8-15) x (channels 0-3 | 4-7) are
//     m16n8k8.tf32's A fragment. Each warp splits its A registers into big
//     and small in registers (two cvt.rna and a subtraction an element),
//     and a tap is two wgmma groups of 2 k8 steps x 3 wgmma;
//   * the GroupNorm affine and SiLU run once per band element and output
//     block in f32 (expf), in place, as in the bf16 kernel; 128 output
//     channels a tile at the decoder's widths, 16 x 4 rows for conv_out;
//   * the tensor cores' f32 sums cut the low bits of each addend (the error
//     grows with K, to ~1.5e-5 of max |y| at K = 9 x 512 in one
//     accumulator), so each 32-channel chunk sums into a fresh wgmma
//     accumulator, added into an f32 register total at the chunk's end;
//   * epilogue: + bias [+ residual] in f32, f32 out.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTW = 64;                     // output columns per tile
constexpr int kBK = 64;                     // input channels per chunk
constexpr int kBandW = kTW + 2;
constexpr int kBandStages = 2;
constexpr int kWStages = 4;

// T: the residual's and y's type, bf16 or f32
template <typename T>
struct Params {
  const float* b;      // (o,)
  const float* scale;  // (B, C) or null
  const float* shift;
  const T* res;        // (B, H, W, o) or null
  T* y;                // (B, H, W, o)
  int h, w_img, c, o, n_chunks, has_skip;
  int tiles_w, tiles_h, o_blocks, n_tiles;  // tile t: o block fastest, then x, y, batch
};

// BN output channels by NWG image rows (one consumer warpgroup each)
template <int BN, int NWG>
struct Cfg {
  static constexpr int kTH = NWG;                    // output rows per tile
  static constexpr int kBandH = kTH + 2;
  static constexpr int kBandBytes = kBandH * kBandW * kBK * 2;  // 128 bytes a pixel
  static constexpr int kBandStride = (kBandBytes + 1023) / 1024 * 1024;  // swizzle atoms
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kBoxN = BN >= 64 ? 64 : 16;   // output channels per TMA box
  static constexpr int kSwizzle = kBoxN * 2;         // bytes of a box row
  static constexpr int kBoxBytes = kBK * kSwizzle;
  static constexpr int kWTap = kBK * BN * 2;         // one tap's weight tile
  static int smem_bytes() {
    return 1024 + kBandStages * kBandStride + kWStages * kWTap + 8 * 2 * (kBandStages + kWStages);
  }
};

// silu(v * sc + sh) on 8 bf16 channels in place, in f32
__device__ __forceinline__ void activate8(uint4* v, const float* sc, const float* sh) {
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(sc));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(sc) + 1);
  const float4 h0 = __ldg(reinterpret_cast<const float4*>(sh));
  const float4 h1 = __ldg(reinterpret_cast<const float4*>(sh) + 1);
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float o[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  uint4 raw = *v;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(pairs[j]);
    float a = fmaf(f.x, s[2 * j], o[2 * j]);
    float b = fmaf(f.y, s[2 * j + 1], o[2 * j + 1]);
    a = __fdividef(a, 1.f + __expf(-a));
    b = __fdividef(b, 1.f + __expf(-b));
    pairs[j] = __floats2bfloat162_rn(a, b);
  }
  *v = raw;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int BN, int NWG>
__global__ void __launch_bounds__(Cfg<BN, NWG>::kThreads, 1)
fused_conv3x3_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_skip,
                     const Params<__nv_bfloat16> p) {
  using C = Cfg<BN, NWG>;
  constexpr int kTH = C::kTH, kBandH = C::kBandH, kConsumers = C::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* band_ring = smem;
  uint8_t* w_ring = smem + kBandStages * C::kBandStride;
  uint64_t* band_full = reinterpret_cast<uint64_t*>(w_ring + kWStages * C::kWTap);
  uint64_t* band_empty = band_full + kBandStages;
  uint64_t* w_full = band_empty + kBandStages;
  uint64_t* w_empty = w_full + kWStages;

  // persistent: block b takes tiles b, b + gridDim.x, ...; the rings run
  // on across tiles, so the next tile's band and weights load while the
  // consumers finish the current one
  int y0, x0, n0, bi;
  auto coord = [&](int tile) {
    n0 = (tile % p.o_blocks) * BN;
    tile /= p.o_blocks;
    x0 = (tile % p.tiles_w) * kTW;
    tile /= p.tiles_w;
    y0 = (tile % p.tiles_h) * kTH;
    bi = tile / p.tiles_h;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBandStages; ++s) {
      mbar_init(&band_full[s], 1);
      mbar_init(&band_empty[s], NWG);
    }
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == 4 * NWG) {  // producer warp
    if (lane == 0) {
      prefetch_tensormap(&map_x);
      prefetch_tensormap(&map_w);
      int ws = 0;
      uint32_t wph = 0;
      auto load_w = [&](const CUtensorMap* map, int c0, int tap) {
        mbar_wait(&w_empty[ws], wph ^ 1);
        uint8_t* dst = w_ring + ws * C::kWTap;
        mbar_expect_tx(&w_full[ws], C::kWTap);
#pragma unroll
        for (int j = 0; j < BN / C::kBoxN; ++j)
          tma_load_3d(dst + j * C::kBoxBytes, map, &w_full[ws], n0 + j * C::kBoxN, c0, tap);
        if (++ws == kWStages) {
          ws = 0;
          wph ^= 1;
        }
      };
      int bands = 0;  // bands loaded so far: ring stage and phase
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        coord(tile);
        for (int i = 0; i < p.n_chunks; ++i, ++bands) {
          const int bs = bands % kBandStages;
          const uint32_t bph = (bands / kBandStages) & 1;
          const int c0 = i * kBK;
          mbar_wait(&band_empty[bs], bph ^ 1);
          mbar_expect_tx(&band_full[bs], C::kBandBytes);
          tma_load_4d(band_ring + bs * C::kBandStride, &map_x, &band_full[bs], c0, x0 - 1, y0 - 1,
                      bi);
          if (p.has_skip) load_w(&map_skip, c0, 0);
          for (int tap = 0; tap < 9; ++tap) load_w(&map_w, c0, tap);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg computes output row y0 + wg, pixels x0 .. x0 + 63
  const int ctid = threadIdx.x;
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[BN / 2];

  // this lane's ldmatrix row: pixel wq * 16 + (lane & 15) of the warpgroup's
  // row, 16-byte chunk (lane >> 4) of each k16 step
  const int a_pix = wq * 16 + (lane & 15);
  const int a_half = lane >> 4;

  // One K-slice of 64 channels: the band shifted by (di, dj) times the
  // weight tile at the head of the weight ring, as one wgmma group. Groups
  // alternate between two sets of A registers: after issuing one, the warp
  // waits only for the group before it (wait_group 1), then that group's
  // A registers are free (fence_a keeps the compiler from reusing them
  // earlier) and its weight stage goes back to the producer, while the
  // tensor cores run the new group.
  int ws = 0;
  uint32_t wph = 0;
  int pending = -1;  // weight stage of the group still running
  uint32_t a0[4][4], a1[4][4];
  auto fence_a = [](uint32_t (&a)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
  };
  auto release_w = [&](int st) {
    if (wq == 0 && lane == 0) mbar_arrive(&w_empty[st]);
  };
  auto group = [&](const uint8_t* band, int di, int dj, uint32_t (&a)[4][4],
                   uint32_t (&other)[4][4]) {
    mbar_wait(&w_full[ws], wph);
    const int q = (wg + di) * kBandW + a_pix + dj;
    const uint32_t row = smem_u32(band) + q * 128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[kk], row + (((2 * kk + a_half) ^ (q & 7)) << 4));
    const uint8_t* wt = w_ring + ws * C::kWTap;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc =
          make_desc(wt + kk * 16 * C::kSwizzle, C::kSwizzle, C::kBoxBytes, 8 * C::kSwizzle);
      wgmma_rs<BN, 1>(acc, a[kk], desc);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_a(other);
    if (pending >= 0) release_w(pending);
    pending = ws;
    if (++ws == kWStages) {
      ws = 0;
      wph ^= 1;
    }
  };

  int bands = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    coord(tile);
    const float* scale = p.scale ? p.scale + static_cast<size_t>(bi) * p.c : nullptr;
    const float* shift = p.shift ? p.shift + static_cast<size_t>(bi) * p.c : nullptr;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_operands(acc);

    for (int i = 0; i < p.n_chunks; ++i, ++bands) {
      const int bs = bands % kBandStages;
      const uint32_t bph = (bands / kBandStages) & 1;
      const int c0 = i * kBK;
      uint8_t* band = band_ring + bs * C::kBandStride;
      mbar_wait(&band_full[bs], bph);
      if (p.has_skip) group(band, 1, 1, a1, a0);  // the 1x1 shortcut on the raw band
      if (scale) {
        named_barrier(1, kConsumers);  // nobody still reads the raw band
        for (int idx = ctid; idx < kBandH * kBandW * 8; idx += kConsumers) {
          const int q = idx >> 3;
          const int j = (idx & 7) ^ (q & 7);  // logical 8-channel group
          const int yy = y0 - 1 + q / kBandW, xx = x0 - 1 + q % kBandW;
          const int cc = c0 + 8 * j;
          if (yy < 0 || yy >= p.h || xx < 0 || xx >= p.w_img || cc >= p.c) continue;
          activate8(reinterpret_cast<uint4*>(band + idx * 16), scale + cc, shift + cc);
        }
        fence_proxy_async();  // before TMA overwrites these bytes
        named_barrier(1, kConsumers);
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        if (tap & 1)
          group(band, tap / 3, tap % 3, a1, a0);
        else
          group(band, tap / 3, tap % 3, a0, a1);
      }
      // the chunk's last group done: its weights and the band go back
      wgmma_wait<0>();
      fence_a(a0);
      fence_operands(acc);
      release_w(pending);
      pending = -1;
      if (wq == 0 && lane == 0) mbar_arrive(&band_empty[bs]);
    }

    // epilogue: + bias [+ residual], one rounding to bf16, masked to the image
    // and to the O real output channels
    const int yy = y0 + wg;
    const bool pairs = (p.o & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int xx = x0 + wq * 16 + g + 8 * half;
      if (yy >= p.h || xx >= p.w_img) continue;
      const size_t pix = ((static_cast<size_t>(bi) * p.h + yy) * p.w_img + xx) * p.o;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        if (pairs) {
          if (col >= p.o) continue;
          v0 += p.b[col];
          v1 += p.b[col + 1];
          if (p.res) {
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.res + pix + col));
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(p.y + pix + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          const float vs[2] = {v0, v1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= p.o) continue;
            float v = vs[e] + p.b[col + e];
            if (p.res) v += __bfloat162float(p.res[pix + col + e]);
            p.y[pix + col + e] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

template <int BN, int NWG>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& ms,
           const Params<__nv_bfloat16>& p,
           int blocks, cudaStream_t stream) {
  const int smem = Cfg<BN, NWG>::smem_bytes();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_conv3x3_kernel<BN, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  fused_conv3x3_kernel<BN, NWG><<<blocks, Cfg<BN, NWG>::kThreads, smem, stream>>>(mx, mw, ms, p);
  return static_cast<int>(cudaGetLastError());
}

// A (opad, C, depth) weight map, box (box_n, 64, 1), swizzled box_n * 2 bytes.
int weight_map(CUtensorMap* map, const void* w, int c, int opad, int depth, int box_n) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(opad), static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(opad) * 2,
                                 static_cast<cuuint64_t>(c) * opad * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_n), kBK, 1};
  return hopper_host::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, dims, strides, box,
                             box_n == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B);
}

// --- float32: 3xTF32 on the tensor cores -------------------------------------

constexpr int kBK32 = 32;  // f32 input channels per chunk: 128 bytes a pixel

// BN output channels by NWG image rows (one consumer warpgroup each)
template <int BN, int NWG>
struct F32Cfg {
  static constexpr int kTH = NWG;
  static constexpr int kBandH = kTH + 2;
  static constexpr int kBandBytes = kBandH * kBandW * kBK32 * 4;
  static constexpr int kBandStride = (kBandBytes + 1023) / 1024 * 1024;  // swizzle atoms
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
  static constexpr int kSplitters = 96;              // its warps 1-3
  static constexpr int kWTile = BN * kBK32 * 4;  // one tap: BN output x 32 input channels
  static constexpr int kWStage = 2 * kWTile;     // its tf32 values, then their remainders'
  static int smem_bytes() {
    return 1024 + kBandStages * kBandStride + kWStages * kWStage +
           8 * (2 * kBandStages + 3 * kWStages);
  }
};

// silu(v * sc + sh) on 4 f32 channels in place
__device__ __forceinline__ void activate4(float4* v, const float* sc, const float* sh) {
  const float4 s = __ldg(reinterpret_cast<const float4*>(sc));
  const float4 o = __ldg(reinterpret_cast<const float4*>(sh));
  const auto f = [](float a, float m, float c) {
    const float u = fmaf(a, m, c);
    return u * (1.f / (1.f + expf(-u)));
  };
  float4 x = *v;
  x = make_float4(f(x.x, s.x, o.x), f(x.y, s.y, o.y), f(x.z, s.z, o.z), f(x.w, s.w, o.w));
  *v = x;
}

template <int BN, int NWG>
__global__ void __launch_bounds__(F32Cfg<BN, NWG>::kThreads, 1)
fused_conv3x3_f32_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_skip,
                         const Params<float> p) {
  using C = F32Cfg<BN, NWG>;
  constexpr int kTH = C::kTH, kBandH = C::kBandH, kConsumers = C::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* band_ring = smem;
  uint8_t* w_ring = smem + kBandStages * C::kBandStride;
  uint64_t* band_full = reinterpret_cast<uint64_t*>(w_ring + kWStages * C::kWStage);
  uint64_t* band_empty = band_full + kBandStages;
  uint64_t* w_full = band_empty + kBandStages;
  uint64_t* w_empty = w_full + kWStages;
  uint64_t* w_ready = w_empty + kWStages;  // split: the consumers may read it

  int y0, x0, n0, bi;
  auto coord = [&](int tile) {
    n0 = (tile % p.o_blocks) * BN;
    tile /= p.o_blocks;
    x0 = (tile % p.tiles_w) * kTW;
    tile /= p.tiles_w;
    y0 = (tile % p.tiles_h) * kTH;
    bi = tile / p.tiles_h;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBandStages; ++s) {
      mbar_init(&band_full[s], 1);
      mbar_init(&band_empty[s], NWG);
    }
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], NWG);
      mbar_init(&w_ready[s], C::kSplitters);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= 4 * NWG) {  // the producer warpgroup
    if constexpr (NWG == 2) setmaxnreg_dec<40>();
    if (warp > 4 * NWG) {
      // splitters: every weight stage in ring order, as the loads fill it
      const int sid = threadIdx.x - kConsumers - 32;
      int ws = 0;
      uint32_t wph = 0;
      const int per_tile = p.n_chunks * (9 + p.has_skip);
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        for (int i = 0; i < per_tile; ++i) {
          mbar_wait(&w_full[ws], wph);
          float4* big = reinterpret_cast<float4*>(w_ring + ws * C::kWStage);
          float4* small = reinterpret_cast<float4*>(w_ring + ws * C::kWStage + C::kWTile);
          for (int idx = sid; idx < C::kWTile / 16; idx += C::kSplitters) {
            const float4 v = big[idx];
            const float4 hi =
                make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
            big[idx] = hi;
            small[idx] = make_float4(tf32_rna(v.x - hi.x), tf32_rna(v.y - hi.y),
                                     tf32_rna(v.z - hi.z), tf32_rna(v.w - hi.w));
          }
          fence_proxy_async();  // before wgmma reads them
          mbar_arrive(&w_ready[ws]);
          if (++ws == kWStages) {
            ws = 0;
            wph ^= 1;
          }
        }
      }
    } else if (lane == 0) {
      prefetch_tensormap(&map_x);
      prefetch_tensormap(&map_w);
      int ws = 0;
      uint32_t wph = 0;
      auto load_w = [&](const CUtensorMap* map, int c0, int tap) {
        mbar_wait(&w_empty[ws], wph ^ 1);
        mbar_expect_tx(&w_full[ws], C::kWTile);
        tma_load_3d(w_ring + ws * C::kWStage, map, &w_full[ws], c0, n0, tap);
        if (++ws == kWStages) {
          ws = 0;
          wph ^= 1;
        }
      };
      int bands = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        coord(tile);
        for (int i = 0; i < p.n_chunks; ++i, ++bands) {
          const int bs = bands % kBandStages;
          const uint32_t bph = (bands / kBandStages) & 1;
          const int c0 = i * kBK32;
          mbar_wait(&band_empty[bs], bph ^ 1);
          mbar_expect_tx(&band_full[bs], C::kBandBytes);
          tma_load_4d(band_ring + bs * C::kBandStride, &map_x, &band_full[bs], c0, x0 - 1, y0 - 1,
                      bi);
          if (p.has_skip) load_w(&map_skip, c0, 0);
          for (int tap = 0; tap < 9; ++tap) load_w(&map_w, c0, tap);
        }
      }
    }
    return;
  }

  if constexpr (NWG == 2) setmaxnreg_inc<232>();
  const int ctid = threadIdx.x;
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the tensor cores' f32 sums cut the low bits of each addend, so an error
  // grows with the number of wgmmas summed into one accumulator: each
  // 32-channel chunk starts a fresh one, added into `total` in f32 at its end
  float acc[BN / 2], total[BN / 2];
  const int a_pix = wq * 16 + (lane & 15);
  const int a_half = lane >> 4;

  // One K-slice of 32 channels (a tap, or the skip) once its weight stage
  // is split: two wgmma groups of two k8 steps, each with its own A
  // registers: the band shifted by (di, dj), split in registers ([0] tf32,
  // [1] the remainder's tf32), and small x big, big x small, big x big per
  // k8 step. As in the w8 kernel, a group waits only for the one before it
  // (wait_group 1), whose A registers are then free, and a weight stage goes
  // back to the producer once its second group has completed. Two k8 steps
  // a group keep the A registers at 32: with four, ptxas serialised the
  // wgmmas for want of registers.
  int ws = 0;
  uint32_t wph = 0;
  int pending = -1;  // the weight stage whose second group may still run
  uint32_t a0[2][2][4], a1[2][2][4];
  auto fence_a = [](uint32_t (&a)[2][2][4]) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[s][kk][r])::"memory");
  };
  auto release_w = [&](int st) {
    if (wq == 0 && lane == 0) mbar_arrive(&w_empty[st]);
  };
  auto half_group = [&](uint32_t row, int q, const uint8_t* wt, int half, uint32_t (&a)[2][2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = 2 * half + j;
      ldmatrix_x4(a[0][j], row + (((2 * kk + a_half) ^ (q & 7)) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __uint_as_float(a[0][j][e]);
        const float hi = tf32_rna(v);
        a[0][j][e] = __float_as_uint(hi);
        a[1][j][e] = __float_as_uint(tf32_rna(v - hi));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = 2 * half + j;
      const uint64_t d_big = make_desc(wt + kk * 32, 128, 16, 1024);
      const uint64_t d_small = make_desc(wt + C::kWTile + kk * 32, 128, 16, 1024);
      wgmma_tf32_rs<BN>(acc, a[1][j], d_big);
      wgmma_tf32_rs<BN>(acc, a[0][j], d_small);
      wgmma_tf32_rs<BN>(acc, a[0][j], d_big);
    }
    wgmma_commit();
  };
  auto group = [&](const uint8_t* band, int di, int dj) {
    mbar_wait(&w_ready[ws], wph);
    const uint8_t* wt = w_ring + ws * C::kWStage;
    const int q = (wg + di) * kBandW + a_pix + dj;
    const uint32_t row = smem_u32(band) + q * 128;
    half_group(row, q, wt, 0, a0);
    wgmma_wait<1>();
    fence_a(a1);
    if (pending >= 0) release_w(pending);
    half_group(row, q, wt, 1, a1);
    wgmma_wait<1>();
    fence_a(a0);
    pending = ws;
    if (++ws == kWStages) {
      ws = 0;
      wph ^= 1;
    }
  };

  int bands = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    coord(tile);
    const float* scale = p.scale ? p.scale + static_cast<size_t>(bi) * p.c : nullptr;
    const float* shift = p.shift ? p.shift + static_cast<size_t>(bi) * p.c : nullptr;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] = 0.f;

    for (int i = 0; i < p.n_chunks; ++i, ++bands) {
      const int bs = bands % kBandStages;
      const uint32_t bph = (bands / kBandStages) & 1;
      const int c0 = i * kBK32;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
      fence_operands(acc);
      uint8_t* band = band_ring + bs * C::kBandStride;
      mbar_wait(&band_full[bs], bph);
      if (p.has_skip) group(band, 1, 1);  // the 1x1 shortcut on the raw band
      if (scale) {
        named_barrier(1, kConsumers);  // nobody still reads the raw band
        for (int idx = ctid; idx < kBandH * kBandW * 8; idx += kConsumers) {
          const int q = idx >> 3;
          const int j = (idx & 7) ^ (q & 7);  // logical 4-channel group
          const int yy = y0 - 1 + q / kBandW, xx = x0 - 1 + q % kBandW;
          const int cc = c0 + 4 * j;
          if (yy < 0 || yy >= p.h || xx < 0 || xx >= p.w_img || cc >= p.c) continue;
          activate4(reinterpret_cast<float4*>(band + idx * 16), scale + cc, shift + cc);
        }
        fence_proxy_async();  // before TMA overwrites these bytes
        named_barrier(1, kConsumers);
      }
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) group(band, tap / 3, tap % 3);
      wgmma_wait<0>();
      fence_a(a1);
      fence_operands(acc);
      release_w(pending);
      pending = -1;
      if (wq == 0 && lane == 0) mbar_arrive(&band_empty[bs]);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) total[e] += acc[e];
    }

    // epilogue: + bias [+ residual] in f32, masked to the image and to O
    const int yy = y0 + wg;
    const bool pairs = (p.o & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int xx = x0 + wq * 16 + g + 8 * half;
      if (yy >= p.h || xx >= p.w_img) continue;
      const size_t pix = ((static_cast<size_t>(bi) * p.h + yy) * p.w_img + xx) * p.o;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        float v0 = total[4 * j + 2 * half], v1 = total[4 * j + 2 * half + 1];
        if (pairs) {
          if (col >= p.o) continue;
          v0 += p.b[col];
          v1 += p.b[col + 1];
          if (p.res) {
            const float2 r = *reinterpret_cast<const float2*>(p.res + pix + col);
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<float2*>(p.y + pix + col) = make_float2(v0, v1);
        } else {
          const float vs[2] = {v0, v1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= p.o) continue;
            float v = vs[e] + p.b[col + e];
            if (p.res) v += p.res[pix + col + e];
            p.y[pix + col + e] = v;
          }
        }
      }
    }
  }
}

template <int BN, int NWG>
int launch_f32(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& ms,
               const Params<float>& p, int blocks, cudaStream_t stream) {
  const int smem = F32Cfg<BN, NWG>::smem_bytes();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_conv3x3_f32_kernel<BN, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  fused_conv3x3_f32_kernel<BN, NWG>
      <<<blocks, F32Cfg<BN, NWG>::kThreads, smem, stream>>>(mx, mw, ms, p);
  return static_cast<int>(cudaGetLastError());
}

// A K-major (depth, O, C) f32 weight map, box (32 input channels, bn output
// channels, 1), 128-byte swizzled; output channels past O arrive as zeros.
int weight_map_f32(CUtensorMap* map, const void* w, int c, int o, int depth, int bn) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(o),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * 4,
                                 static_cast<cuuint64_t>(o) * c * 4};
  const cuuint32_t box[3] = {kBK32, static_cast<cuuint32_t>(bn), 1};
  return hopper_host::encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, w, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

extern "C" {

int fused_conv3x3_smem_bytes(int bn, int rows);

// See the header comment. scale/shift, wskip and residual may be null; the
// tile (bn output channels x rows image rows: 128 x 2 or 16 x 4) and the
// number of persistent blocks are kernels/fused_conv.py::plan's. Needs C % 8 == 0,
// opad % 8 == 0 and 16-byte aligned tensors (the wrapper pads w and
// checks). Launches on `stream`, does not synchronise; returns 0 or an
// error code for fused_conv3x3_error_string.
int fused_conv3x3(const void* x, const void* w, const void* b, const void* scale,
                  const void* shift, const void* wskip, const void* residual, void* y, int batch,
                  int h, int w_img, int c, int o, int opad, int bn, int rows, int blocks,
                  void* stream) {
  if (fused_conv3x3_smem_bytes(bn, rows) == 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int box_n = bn >= 64 ? 64 : 16;
  CUtensorMap mx, mw, ms;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w_img),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c) * 2,
                                 static_cast<cuuint64_t>(w_img) * c * 2,
                                 static_cast<cuuint64_t>(h) * w_img * c * 2};
  const cuuint32_t box[4] = {kBK, kBandW, static_cast<cuuint32_t>(rows + 2), 1};
  int rc = hopper_host::encode(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  if ((rc = weight_map(&mw, w, c, opad, 9, box_n))) return rc;
  if ((rc = weight_map(&ms, wskip ? wskip : w, c, opad, 1, box_n))) return rc;
  Params<__nv_bfloat16> p;
  p.b = static_cast<const float*>(b);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.res = static_cast<const __nv_bfloat16*>(residual);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.h = h;
  p.w_img = w_img;
  p.c = c;
  p.o = o;
  p.n_chunks = (c + kBK - 1) / kBK;
  p.has_skip = wskip != nullptr;
  p.tiles_w = (w_img + kTW - 1) / kTW;
  p.tiles_h = (h + rows - 1) / rows;
  p.o_blocks = (opad + bn - 1) / bn;
  p.n_tiles = p.tiles_w * p.tiles_h * p.o_blocks * batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128) return launch<128, 2>(mx, mw, ms, p, blocks, s);
  return launch<16, 4>(mx, mw, ms, p, blocks, s);
}

// Shared memory a block of the (bn output channels, rows image rows)
// kernel asks for; 0 for a tile there is no kernel for.
int fused_conv3x3_smem_bytes(int bn, int rows) {
  if (bn == 128 && rows == 2) return Cfg<128, 2>::smem_bytes();
  if (bn == 16 && rows == 4) return Cfg<16, 4>::smem_bytes();
  return 0;
}

int fused_conv3x3_f32_smem_bytes(int bn, int rows);

// The same on f32 x (B, H, W, C), b (O,), scale/shift (B, C), residual
// (B, H, W, O) into f32 y, with the weights K-major: w (9, O, C) and wskip
// (O, C) (the wrapper transposes HWIO). Any O; C % 8 == 0 and 16-byte
// aligned tensors (the wrapper checks). The tile and the persistent blocks
// are kernels/fused_conv.py::plan(..., f32=True)'s. Launches on `stream`,
// does not synchronise; returns 0 or an error code for
// fused_conv3x3_error_string.
int fused_conv3x3_f32(const void* x, const void* w, const void* b, const void* scale,
                      const void* shift, const void* wskip, const void* residual, void* y,
                      int batch, int h, int w_img, int c, int o, int bn, int rows, int blocks,
                      void* stream) {
  if (fused_conv3x3_f32_smem_bytes(bn, rows) == 0 || blocks < 1 || c % 8 || o < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw, ms;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w_img),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c) * 4,
                                 static_cast<cuuint64_t>(w_img) * c * 4,
                                 static_cast<cuuint64_t>(h) * w_img * c * 4};
  const cuuint32_t box[4] = {kBK32, kBandW, static_cast<cuuint32_t>(rows + 2), 1};
  int rc = hopper_host::encode(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  if ((rc = weight_map_f32(&mw, w, c, o, 9, bn))) return rc;
  if ((rc = weight_map_f32(&ms, wskip ? wskip : w, c, o, 1, bn))) return rc;
  Params<float> p;
  p.b = static_cast<const float*>(b);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.res = static_cast<const float*>(residual);
  p.y = static_cast<float*>(y);
  p.h = h;
  p.w_img = w_img;
  p.c = c;
  p.o = o;
  p.n_chunks = (c + kBK32 - 1) / kBK32;
  p.has_skip = wskip != nullptr;
  p.tiles_w = (w_img + kTW - 1) / kTW;
  p.tiles_h = (h + rows - 1) / rows;
  p.o_blocks = (o + bn - 1) / bn;
  p.n_tiles = p.tiles_w * p.tiles_h * p.o_blocks * batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128) return launch_f32<128, 2>(mx, mw, ms, p, blocks, s);
  return launch_f32<16, 4>(mx, mw, ms, p, blocks, s);
}

// Shared memory a block of the f32 (bn output channels, rows image rows)
// kernel asks for; 0 for a tile there is no kernel for.
int fused_conv3x3_f32_smem_bytes(int bn, int rows) {
  if (bn == 128 && rows == 2) return F32Cfg<128, 2>::smem_bytes();
  if (bn == 16 && rows == 4) return F32Cfg<16, 4>::smem_bytes();
  return 0;
}

const char* fused_conv3x3_error_string(int code) { return hopper_host::error_string(code); }

}  // extern "C"
