// Native host-side image pipeline for the diffusion data loader.
//
// A copy of the JAX package's decoder (genima_tpu/native/image_ops.cpp):
// PNG decode + resize/center-crop + normalize for training batches,
// threaded across the batch, the part torch's C++ DataLoader internals play
// in the reference. Exposed through a C ABI and loaded via ctypes
// (genima_torch/native/__init__.py, which builds it into build/); the
// Python loader falls back to PIL when the library is unavailable.
//
// Semantics match the reference's torchvision preprocessing
// (train_controlnet_genima.py:917-942): Resize(shorter side -> resolution,
// bilinear) + CenterCrop(resolution); normalize mode 0 -> [0,1]
// (conditioning image), mode 1 -> [-1,1] (target image). Output is HWC
// (NHWC batches).

#include <png.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct DecodedImage {
  std::vector<uint8_t> rgb;  // HWC, 3 channels
  int h = 0;
  int w = 0;
};

bool decode_png(const uint8_t* data, size_t size, DecodedImage* out) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, size)) return false;
  image.format = PNG_FORMAT_RGB;
  out->h = static_cast<int>(image.height);
  out->w = static_cast<int>(image.width);
  out->rgb.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out->rgb.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

// bilinear sample at (y, x) in source pixel coordinates
inline void sample_bilinear(const uint8_t* src, int sh, int sw, float y,
                            float x, float* rgb) {
  y = std::min(std::max(y, 0.0f), static_cast<float>(sh - 1));
  x = std::min(std::max(x, 0.0f), static_cast<float>(sw - 1));
  int y0 = static_cast<int>(y), x0 = static_cast<int>(x);
  int y1 = std::min(y0 + 1, sh - 1), x1 = std::min(x0 + 1, sw - 1);
  float fy = y - y0, fx = x - x0;
  for (int c = 0; c < 3; ++c) {
    float v00 = src[(y0 * sw + x0) * 3 + c];
    float v01 = src[(y0 * sw + x1) * 3 + c];
    float v10 = src[(y1 * sw + x0) * 3 + c];
    float v11 = src[(y1 * sw + x1) * 3 + c];
    rgb[c] = v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
             v10 * fy * (1 - fx) + v11 * fy * fx;
  }
}

// Resize(shorter side -> res) + CenterCrop(res) + normalize -> HWC f32
void resize_crop_normalize(const DecodedImage& img, int res, int mode,
                           float* out) {
  const float scale =
      static_cast<float>(res) / static_cast<float>(std::min(img.h, img.w));
  const float rh = img.h * scale, rw = img.w * scale;
  // center-crop offsets in resized coordinates
  const float off_y = (rh - res) / 2.0f, off_x = (rw - res) / 2.0f;
  const float inv = 1.0f / scale;
  for (int oy = 0; oy < res; ++oy) {
    // map output pixel center -> source coordinates
    const float sy = (oy + off_y + 0.5f) * inv - 0.5f;
    for (int ox = 0; ox < res; ++ox) {
      const float sx = (ox + off_x + 0.5f) * inv - 0.5f;
      float rgb[3];
      sample_bilinear(img.rgb.data(), img.h, img.w, sy, sx, rgb);
      float* dst = out + (oy * res + ox) * 3;
      if (mode == 1) {  // [-1, 1] target-image convention
        for (int c = 0; c < 3; ++c) dst[c] = rgb[c] / 127.5f - 1.0f;
      } else {  // [0, 1] conditioning convention
        for (int c = 0; c < 3; ++c) dst[c] = rgb[c] / 255.0f;
      }
    }
  }
}

// uint8 variant: same Resize + CenterCrop, NO normalization — the batch
// ships to the device as uint8 (4x less host->device traffic than f32;
// the trainer normalizes on device where bandwidth is free).
void resize_crop_u8(const DecodedImage& img, int res, uint8_t* out) {
  const float scale =
      static_cast<float>(res) / static_cast<float>(std::min(img.h, img.w));
  const float rh = img.h * scale, rw = img.w * scale;
  const float off_y = (rh - res) / 2.0f, off_x = (rw - res) / 2.0f;
  const float inv = 1.0f / scale;
  for (int oy = 0; oy < res; ++oy) {
    const float sy = (oy + off_y + 0.5f) * inv - 0.5f;
    for (int ox = 0; ox < res; ++ox) {
      const float sx = (ox + off_x + 0.5f) * inv - 0.5f;
      float rgb[3];
      sample_bilinear(img.rgb.data(), img.h, img.w, sy, sx, rgb);
      uint8_t* dst = out + (oy * res + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        dst[c] = static_cast<uint8_t>(
            std::min(std::max(rgb[c] + 0.5f, 0.0f), 255.0f));
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.
int genima_decode_png_resize(const uint8_t* data, unsigned long size, int res,
                             int mode, float* out) {
  DecodedImage img;
  if (!decode_png(data, size, &img)) return 1;
  resize_crop_normalize(img, res, mode, out);
  return 0;
}

// Batch variant: n images -> out (n, res, res, 3) f32, threaded.
// datas[i]/sizes[i] point at in-memory PNG bytes. Returns the number of
// failed decodes (0 == all good).
int genima_decode_batch(const uint8_t** datas, const unsigned long* sizes,
                        int n, int res, int mode, float* out,
                        int n_threads) {
  if (n_threads <= 0) n_threads = 1;
  std::vector<int> failures(n_threads, 0);
  const long plane = static_cast<long>(res) * res * 3;
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      if (genima_decode_png_resize(datas[i], sizes[i], res, mode,
                                   out + plane * i) != 0) {
        failures[tid]++;
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
  for (auto& t : threads) t.join();
  int total = 0;
  for (int f : failures) total += f;
  return total;
}

// uint8 variants of the two entry points above (raw [0,255] output).
int genima_decode_png_resize_u8(const uint8_t* data, unsigned long size,
                                int res, uint8_t* out) {
  DecodedImage img;
  if (!decode_png(data, size, &img)) return 1;
  resize_crop_u8(img, res, out);
  return 0;
}

int genima_decode_batch_u8(const uint8_t** datas, const unsigned long* sizes,
                           int n, int res, uint8_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = 1;
  std::vector<int> failures(n_threads, 0);
  const long plane = static_cast<long>(res) * res * 3;
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      if (genima_decode_png_resize_u8(datas[i], sizes[i], res,
                                      out + plane * i) != 0) {
        failures[tid]++;
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
  for (auto& t : threads) t.join();
  int total = 0;
  for (int f : failures) total += f;
  return total;
}

}  // extern "C"
