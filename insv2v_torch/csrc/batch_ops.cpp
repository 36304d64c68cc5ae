// Native host-side data-pipeline kernels for insv2v_torch.
//
// The reference's data path leans on OpenCV's C++ internals through
// python bindings, but the per-batch assembly loops (uint8 -> [-1,1]
// float conversion, bilinear resize, crop+resize motion augmentation,
// frame stacking) run single-threaded under the Python GIL. This library
// provides those inner loops as a C API over raw buffers, parallelized
// with std::thread so batch assembly overlaps device steps.
//
// Exposed via ctypes (insv2v_torch/data/native_loader.py); all functions
// operate on caller-allocated buffers, channels-last uint8 in / float32
// out. Build: g++ -O3 -std=c++17 -shared -fPIC -o libbatch_ops.so
// batch_ops.cpp -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline float lerp(float a, float b, float t) { return a + (b - a) * t; }

// Bilinear sample from a uint8 HWC image at (y, x), clamped: all four
// neighbours lie inside the frame, also for a sample more than one pixel
// left of or above it (a crop window past the frame's left or top edge).
inline void sample_bilinear(const uint8_t* src, int h, int w, int c,
                            float y, float x, float* out) {
  int x0 = static_cast<int>(std::floor(x));
  int y0 = static_cast<int>(std::floor(y));
  float fx = x - x0;
  float fy = y - y0;
  int x1 = std::max(std::min(x0 + 1, w - 1), 0);
  int y1 = std::max(std::min(y0 + 1, h - 1), 0);
  x0 = std::max(std::min(x0, w - 1), 0);
  y0 = std::max(std::min(y0, h - 1), 0);
  const uint8_t* p00 = src + (static_cast<int64_t>(y0) * w + x0) * c;
  const uint8_t* p01 = src + (static_cast<int64_t>(y0) * w + x1) * c;
  const uint8_t* p10 = src + (static_cast<int64_t>(y1) * w + x0) * c;
  const uint8_t* p11 = src + (static_cast<int64_t>(y1) * w + x1) * c;
  for (int ch = 0; ch < c; ++ch) {
    float top = lerp(static_cast<float>(p00[ch]), static_cast<float>(p01[ch]), fx);
    float bot = lerp(static_cast<float>(p10[ch]), static_cast<float>(p11[ch]), fx);
    out[ch] = lerp(top, bot, fy);
  }
}

void parallel_for(int n, int n_threads, const std::function<void(int, int)>& fn) {
  n_threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  int chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * chunk;
    int hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// uint8 frames (n, h, w, c) -> float32 (n, h, w, c) in [-1, 1].
void normalize_frames(const uint8_t* src, int n, int h, int w, int c,
                      float* dst, int n_threads) {
  const int64_t per = static_cast<int64_t>(h) * w * c;
  parallel_for(n, n_threads, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      const uint8_t* s = src + i * per;
      float* d = dst + i * per;
      for (int64_t j = 0; j < per; ++j) {
        d[j] = static_cast<float>(s[j]) * (1.0f / 127.5f) - 1.0f;
      }
    }
  });
}

// Bilinear resize + normalize: uint8 (n, h, w, c) -> f32 (n, oh, ow, c).
// Uses the half-pixel (align_corners=false) convention, matching
// cv2.INTER_LINEAR / torch interpolate defaults.
void resize_normalize(const uint8_t* src, int n, int h, int w, int c,
                      int oh, int ow, float* dst, int n_threads) {
  const int64_t in_per = static_cast<int64_t>(h) * w * c;
  const int64_t out_per = static_cast<int64_t>(oh) * ow * c;
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  parallel_for(n, n_threads, [&](int lo, int hi) {
    std::vector<float> px(c);
    for (int i = lo; i < hi; ++i) {
      const uint8_t* s = src + i * in_per;
      float* d = dst + i * out_per;
      for (int y = 0; y < oh; ++y) {
        float fy = (y + 0.5f) * sy - 0.5f;
        for (int x = 0; x < ow; ++x) {
          float fx = (x + 0.5f) * sx - 0.5f;
          sample_bilinear(s, h, w, c, fy, fx, px.data());
          float* o = d + (static_cast<int64_t>(y) * ow + x) * c;
          for (int ch = 0; ch < c; ++ch) {
            o[ch] = px[ch] * (1.0f / 127.5f) - 1.0f;
          }
        }
      }
    }
  });
}

// Per-frame crop (center cx[i], cy[i], size crop_h x crop_w) resized back
// to (h, w) and normalized — the translation/zoom motion-augmentation
// inner loop (dataset/videoP2P.py:72-126). uint8 (n,h,w,c) -> f32 (n,h,w,c).
void crop_resize_normalize(const uint8_t* src, int n, int h, int w, int c,
                           const float* cx, const float* cy,
                           const int* crop_h, const int* crop_w,
                           float* dst, int n_threads) {
  const int64_t per = static_cast<int64_t>(h) * w * c;
  parallel_for(n, n_threads, [&](int lo, int hi) {
    std::vector<float> px(c);
    for (int i = lo; i < hi; ++i) {
      const uint8_t* s = src + i * per;
      float* d = dst + i * per;
      const float ch_f = static_cast<float>(crop_h[i]);
      const float cw_f = static_cast<float>(crop_w[i]);
      const float y_start = cy[i] - ch_f * 0.5f;
      const float x_start = cx[i] - cw_f * 0.5f;
      const float sy = ch_f / h;
      const float sx = cw_f / w;
      for (int y = 0; y < h; ++y) {
        float fy = y_start + (y + 0.5f) * sy - 0.5f;
        for (int x = 0; x < w; ++x) {
          float fx = x_start + (x + 0.5f) * sx - 0.5f;
          sample_bilinear(s, h, w, c, fy, fx, px.data());
          float* o = d + (static_cast<int64_t>(y) * w + x) * c;
          for (int chn = 0; chn < c; ++chn) {
            o[chn] = px[chn] * (1.0f / 127.5f) - 1.0f;
          }
        }
      }
    }
  });
}

}  // extern "C"
