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
// Design: an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate). A block computes 128 output pixels (2 image rows x 64
// columns) by BN output channels, and walks the input channels in chunks
// of 32:
//   * the chunk's halo band, (2 + 2) rows x (64 + 2) columns x 32 channels,
//     is copied into shared memory with cp.async, out-of-image pixels
//     zero-filled;
//   * the GroupNorm affine and SiLU are applied to the band in place, once
//     per element (not once per tap), and out-of-image pixels stay 0: the
//     conv's zero padding is padding of the activated image. The normalised
//     activation never reaches device memory, which is what the TPU kernel
//     exists for;
//   * the nine taps are nine K-slices of the GEMM whose A rows are the band
//     shifted by (di, dj): ldmatrix takes one row address per lane, so a
//     shifted window costs nothing to form. Each tap's 32 x BN weight tile
//     is double-buffered with cp.async;
//   * wskip is one more K-slice per chunk, on the raw (not activated) band's
//     centre; the bias and the residual are added in the epilogue.
// BN is 128 (8 warps of 64 pixels x 32 channels) or, for conv_out's 3
// output channels, 16 (8 warps of 16 pixels x 16 channels).
//
// Not ported from the TPU kernel: its routing to XLA for C % 128 != 0 or
// O < 128 (a lane-alignment rule of the TPU's DMA and VMEM), its split of the
// output channels when a band overflows VMEM, and its row-band height search.
// A block's working set here is 40 KB of shared memory whatever the width.
//
// Bound: 2*B*H*W*O*(9C [+ C]) flops on x, y [and residual] bytes. At the SD
// decoder's widths (C, O >= 128) the tensor cores bound it; conv_out (O = 3)
// is bound by reading its 128-channel input.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 2;                 // output rows per block
constexpr int kTW = 64;                // output columns per block
constexpr int kBM = kTH * kTW;         // output pixels per block
constexpr int kBK = 32;                // input channels per chunk
constexpr int kBandW = kTW + 2;
constexpr int kBandPix = (kTH + 2) * kBandW;
constexpr int kBandStride = kBK + 8;   // bf16 per band pixel in smem (80 bytes)
constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;      // (9, C, opad)
  const float* b;              // (o,)
  const float* scale;          // (B, C) or null
  const float* shift;
  const __nv_bfloat16* wskip;  // (C, opad) or null
  const __nv_bfloat16* res;    // (B, H, W, o) or null
  __nv_bfloat16* y;            // (B, H, W, o)
  int h, w_img, c, o, opad;
};

template <int BN, int WARPS_M>
__global__ void __launch_bounds__(kThreads) fused_conv3x3_kernel(Params p) {
  constexpr int WARPS_N = (kThreads / 32) / WARPS_M;
  constexpr int WM = kBM / WARPS_M;  // pixels per warp
  constexpr int WN = BN / WARPS_N;   // output channels per warp
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  constexpr int kWStride = BN + 8;
  static_assert(NT % 2 == 0, "B fragments are loaded two n-tiles at a time");

  __shared__ __align__(16) __nv_bfloat16 s_band[kBandPix * kBandStride];
  __shared__ __align__(16) __nv_bfloat16 s_w[2][kBK * kWStride];

  const int tiles_w = (p.w_img + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_w) * kTH;
  const int x0 = (blockIdx.x % tiles_w) * kTW;
  const int n0 = blockIdx.y * BN;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t img = static_cast<size_t>(bi) * p.h * p.w_img;

  // band pixel q <-> image (y0 + q / kBandW - 1, x0 + q % kBandW - 1)
  auto band_pixel = [&](int q, int& yy, int& xx) {
    yy = y0 + q / kBandW - 1;
    xx = x0 + q % kBandW - 1;
    return yy >= 0 && yy < p.h && xx >= 0 && xx < p.w_img;
  };

  auto load_band = [&](int c0) {
    for (int idx = threadIdx.x; idx < kBandPix * (kBK / 8); idx += kThreads) {
      const int q = idx >> 2, cv = (idx & 3) * 8;
      int yy, xx;
      const bool ok = band_pixel(q, yy, xx) && c0 + cv < p.c;
      const __nv_bfloat16* src =
          ok ? p.x + (img + static_cast<size_t>(yy) * p.w_img + xx) * p.c + c0 + cv : p.x;
      cp_async_16(s_band + q * kBandStride + cv, src, ok);
    }
  };

  // silu(x * scale + shift) in place, in f32, rounded to bf16; pixels
  // outside the image (and channels past C) keep their zeros
  auto activate_band = [&](int c0) {
    for (int idx = threadIdx.x; idx < kBandPix * (kBK / 8); idx += kThreads) {
      const int q = idx >> 2, cv = (idx & 3) * 8;
      int yy, xx;
      if (!band_pixel(q, yy, xx) || c0 + cv >= p.c) continue;
      __nv_bfloat16* v = s_band + q * kBandStride + cv;
      uint4 raw = *reinterpret_cast<uint4*>(v);
      __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
      const float* sc = p.scale + static_cast<size_t>(bi) * p.c + c0 + cv;
      const float* sh = p.shift + static_cast<size_t>(bi) * p.c + c0 + cv;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(pairs[j]);
        float a = fmaf(f.x, sc[2 * j], sh[2 * j]);
        float b = fmaf(f.y, sc[2 * j + 1], sh[2 * j + 1]);
        a = __fdividef(a, 1.f + __expf(-a));
        b = __fdividef(b, 1.f + __expf(-b));
        pairs[j] = __floats2bfloat162_rn(a, b);
      }
      *reinterpret_cast<uint4*>(v) = raw;
    }
  };

  // one 32 x BN weight tile: rows are input channels c0.., columns output
  // channels n0..; `src` is (C, opad) row-major
  auto load_w = [&](int buf, const __nv_bfloat16* src, int c0) {
    for (int idx = threadIdx.x; idx < kBK * (BN / 8); idx += kThreads) {
      const int r = idx / (BN / 8), cv = (idx % (BN / 8)) * 8;
      const bool ok = c0 + r < p.c && n0 + cv < p.opad;
      const __nv_bfloat16* s =
          ok ? src + static_cast<size_t>(c0 + r) * p.opad + n0 + cv : src;
      cp_async_16(&s_w[buf][r * kWStride + cv], s, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // this lane's ldmatrix row: pixel m of the block, as band coordinates
  int a_base[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = wm * WM + mt * 16 + (lane & 15);
    a_base[mt] = ((m / kTW) * kBandW + (m % kTW)) * kBandStride + (lane >> 4) * 8;
  }
  const int mi = lane >> 3;
  const int b_base = ((mi & 1) * 8 + (lane & 7)) * kWStride + wn * WN + (mi >> 1) * 8;

  const int n_chunks = (p.c + kBK - 1) / kBK;
  const int n_iters = n_chunks * (p.wskip ? 2 : 1);
  for (int it = 0; it < n_iters; ++it) {
    const bool skip = it >= n_chunks;  // the 1x1 shortcut's K-slices
    const int c0 = (skip ? it - n_chunks : it) * kBK;
    const int n_taps = skip ? 1 : 9;
    load_band(c0);
    load_w(0, skip ? p.wskip : p.w, c0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (!skip && p.scale) {
      activate_band(c0);
      __syncthreads();
    }
    for (int tap = 0; tap < n_taps; ++tap) {
      if (tap + 1 < n_taps) load_w((tap + 1) & 1, p.w + static_cast<size_t>(tap + 1) * p.c * p.opad, c0);
      cp_async_commit();
      const int di = skip ? 1 : tap / 3, dj = skip ? 1 : tap % 3;
      const __nv_bfloat16* band = s_band + (di * kBandW + dj) * kBandStride;
      const __nv_bfloat16* ws = s_w[tap & 1];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], band + a_base[mt] + kk * 16);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, ws + kk * 16 * kWStride + b_base + nt * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[mt][nt], a[mt], b);
            mma_bf16_16816(acc[mt][nt + 1], a[mt], b + 2);
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }
  }

  // epilogue: + bias [+ residual], one rounding to bf16, masked to the image
  // and to the O real output channels
  const bool pairs = (p.o & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wm * WM + mt * 16 + g + half * 8;
      const int yy = y0 + m / kTW, xx = x0 + m % kTW;
      if (yy >= p.h || xx >= p.w_img) continue;
      const size_t pix = (img + static_cast<size_t>(yy) * p.w_img + xx) * p.o;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * WN + nt * 8 + 2 * t;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (pairs) {
          if (col >= p.o) continue;
          v0 += p.b[col];
          v1 += p.b[col + 1];
          if (p.res) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p.res + pix + col));
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(p.y + pix + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          const float vs[2] = {v0, v1};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (col + j >= p.o) continue;
            float v = vs[j] + p.b[col + j];
            if (p.res) v += __bfloat162float(p.res[pix + col + j]);
            p.y[pix + col + j] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// See the header comment. scale/shift, wskip and residual may be null.
// Needs C % 8 == 0 and opad % 8 == 0 (the wrapper pads w and checks).
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int fused_conv3x3(const void* x, const void* w, const void* b, const void* scale,
                  const void* shift, const void* wskip, const void* residual, void* y, int batch,
                  int h, int w_img, int c, int o, int opad, void* stream) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.b = static_cast<const float*>(b);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.wskip = static_cast<const __nv_bfloat16*>(wskip);
  p.res = static_cast<const __nv_bfloat16*>(residual);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.h = h;
  p.w_img = w_img;
  p.c = c;
  p.o = o;
  p.opad = opad;
  const int tiles = ((h + kTH - 1) / kTH) * ((w_img + kTW - 1) / kTW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (opad <= 16) {
    fused_conv3x3_kernel<16, 8><<<dim3(tiles, (opad + 15) / 16, batch), kThreads, 0, s>>>(p);
  } else {
    fused_conv3x3_kernel<128, 2><<<dim3(tiles, (opad + 127) / 128, batch), kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
