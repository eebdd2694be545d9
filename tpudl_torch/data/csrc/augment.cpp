// Native data-path kernel of tpudl_torch: fused crop + flip + normalize
// batch augmentation. A copy of tpudl/native/augment.cpp (the JAX
// package's), kept in the port so that it needs nothing of that package,
// plus tpudl_crop_flip_u8: the same crop and flip with uint8 out (the
// batch a step normalizes on the card), where the JAX package slices in
// numpy. ctypes releases the interpreter lock around each call, so the
// prefetcher's assembly threads (tpudl_torch/data/prefetch.py) run these
// in parallel.
//
// One pass over each uint8 HWC image produces the augmented, normalized
// f32 NHWC batch. Randomness (crop offsets, flip coins) is drawn by the
// Python caller (tpudl_torch/data/augment.py), so its numpy path and this
// kernel consume the same draws and agree to f32 rounding.
//
// Built at first use by tpudl_torch/data/native.py with `g++ -O3 -fopenmp
// -shared -fPIC` into the checkout's build/ directory; loaded via ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// images:  [n, h, w, c] uint8, C-contiguous.
// offsets: [n, 2] int32 — (top, left) of the crop window inside the
//          zero-padded (h + 2*pad, w + 2*pad) frame; caller samples them
//          in [0, h + 2*pad - crop_h] x [0, w + 2*pad - crop_w].
// flip:    [n] uint8 — 1 = mirror horizontally (after the crop).
// mean, stddev: [c] f32 in normalized-pixel units:
//          out = (px / 255 - mean) / stddev.
// out:     [n, crop_h, crop_w, c] f32, C-contiguous.
void tpudl_augment_batch(const std::uint8_t* images,
                         std::int64_t n,
                         std::int64_t h,
                         std::int64_t w,
                         std::int64_t c,
                         std::int64_t pad,
                         std::int64_t crop_h,
                         std::int64_t crop_w,
                         const std::int32_t* offsets,
                         const std::uint8_t* flip,
                         const float* mean,
                         const float* stddev,
                         float* out) {
  // px * scale + bias  ==  (px/255 - mean) / std; padding (px = 0) is
  // bias alone.
  float scale[16];
  float bias[16];
  const std::int64_t cc = c < 16 ? c : 16;
  for (std::int64_t k = 0; k < cc; ++k) {
    scale[k] = 1.0f / (255.0f * stddev[k]);
    bias[k] = -mean[k] / stddev[k];
  }

#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < n; ++i) {
    const std::uint8_t* img = images + i * h * w * c;
    float* dst = out + i * crop_h * crop_w * c;
    const std::int64_t top = static_cast<std::int64_t>(offsets[2 * i]) - pad;
    const std::int64_t left =
        static_cast<std::int64_t>(offsets[2 * i + 1]) - pad;
    const bool mirror = flip[i] != 0;
    for (std::int64_t y = 0; y < crop_h; ++y) {
      const std::int64_t sy = top + y;
      const bool row_in = (sy >= 0) && (sy < h);
      float* row = dst + y * crop_w * c;
      for (std::int64_t x = 0; x < crop_w; ++x) {
        const std::int64_t xx = mirror ? (crop_w - 1 - x) : x;
        const std::int64_t sx = left + xx;
        float* px = row + x * c;
        if (row_in && sx >= 0 && sx < w) {
          const std::uint8_t* sp = img + (sy * w + sx) * c;
          for (std::int64_t k = 0; k < cc; ++k) {
            px[k] = static_cast<float>(sp[k]) * scale[k] + bias[k];
          }
        } else {
          for (std::int64_t k = 0; k < cc; ++k) {
            px[k] = bias[k];
          }
        }
      }
    }
  }
}

// The same crop and flip with the pixels copied as they are: images
// [n, h, w, c] uint8 -> out [n, crop_h, crop_w, c] uint8, padding 0.
// Bit for bit the numpy slicing of the Python caller.
void tpudl_crop_flip_u8(const std::uint8_t* images,
                        std::int64_t n,
                        std::int64_t h,
                        std::int64_t w,
                        std::int64_t c,
                        std::int64_t pad,
                        std::int64_t crop_h,
                        std::int64_t crop_w,
                        const std::int32_t* offsets,
                        const std::uint8_t* flip,
                        std::uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < n; ++i) {
    const std::uint8_t* img = images + i * h * w * c;
    std::uint8_t* dst = out + i * crop_h * crop_w * c;
    const std::int64_t top = static_cast<std::int64_t>(offsets[2 * i]) - pad;
    const std::int64_t left =
        static_cast<std::int64_t>(offsets[2 * i + 1]) - pad;
    const bool mirror = flip[i] != 0;
    for (std::int64_t y = 0; y < crop_h; ++y) {
      const std::int64_t sy = top + y;
      std::uint8_t* row = dst + y * crop_w * c;
      if (sy < 0 || sy >= h) {
        std::memset(row, 0, static_cast<std::size_t>(crop_w * c));
        continue;
      }
      const std::uint8_t* src = img + sy * w * c;
      if (!mirror) {
        // One run of in-frame pixels between the zero margins.
        const std::int64_t x0 = left < 0 ? -left : 0;
        const std::int64_t x1 = w - left < crop_w ? w - left : crop_w;
        if (x1 <= x0) {
          std::memset(row, 0, static_cast<std::size_t>(crop_w * c));
          continue;
        }
        std::memset(row, 0, static_cast<std::size_t>(x0 * c));
        std::memcpy(row + x0 * c, src + (left + x0) * c,
                    static_cast<std::size_t>((x1 - x0) * c));
        std::memset(row + x1 * c, 0,
                    static_cast<std::size_t>((crop_w - x1) * c));
        continue;
      }
      for (std::int64_t x = 0; x < crop_w; ++x) {
        const std::int64_t sx = left + (crop_w - 1 - x);
        std::uint8_t* px = row + x * c;
        if (sx >= 0 && sx < w) {
          const std::uint8_t* sp = src + sx * c;
          for (std::int64_t k = 0; k < c; ++k) px[k] = sp[k];
        } else {
          for (std::int64_t k = 0; k < c; ++k) px[k] = 0;
        }
      }
    }
  }
}

// Eval-path variant: center crop (or identity when sizes match), no
// randomness. images [n,h,w,c] u8 -> out [n,crop_h,crop_w,c] f32.
void tpudl_normalize_batch(const std::uint8_t* images,
                           std::int64_t n,
                           std::int64_t h,
                           std::int64_t w,
                           std::int64_t c,
                           std::int64_t crop_h,
                           std::int64_t crop_w,
                           const float* mean,
                           const float* stddev,
                           float* out) {
  float scale[16];
  float bias[16];
  const std::int64_t cc = c < 16 ? c : 16;
  for (std::int64_t k = 0; k < cc; ++k) {
    scale[k] = 1.0f / (255.0f * stddev[k]);
    bias[k] = -mean[k] / stddev[k];
  }
  const std::int64_t top = (h - crop_h) / 2;
  const std::int64_t left = (w - crop_w) / 2;

#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < n; ++i) {
    const std::uint8_t* img = images + i * h * w * c;
    float* dst = out + i * crop_h * crop_w * c;
    for (std::int64_t y = 0; y < crop_h; ++y) {
      const std::uint8_t* srow = img + ((top + y) * w + left) * c;
      float* row = dst + y * crop_w * c;
      for (std::int64_t x = 0; x < crop_w * c; x += c) {
        for (std::int64_t k = 0; k < cc; ++k) {
          row[x + k] = static_cast<float>(srow[x + k]) * scale[k] + bias[k];
        }
      }
    }
  }
}

}  // extern "C"
