// Native host preprocessing: bicubic resize + center crop + CLIP normalize.
//
// The reference's host pipeline is torchvision/PIL C internals
// (processing_image.py:15-25: Resize(224, bicubic) -> CenterCrop(224) ->
// Normalize). The port's Python path (data/processing.py) uses PIL; this library is the
// same math as PIL's fixed-point resampler (two-pass separable filter,
// 8-bit intermediates, PRECISION_BITS=22 coefficients) so its uint8 resize
// output is BIT-EXACT vs PIL bicubic, then fuses crop+normalize into the
// float32 CHW write and threads over the batch. Compiled on demand by
// teochat_torch/native/__init__.py (g++ -O3, into teochat_torch/csrc/build/),
// bound via ctypes. A copy of teochat_tpu/native/preprocess.cc, held to it
// bit for bit by tests/test_torch_builder.py.
//
// Exactness contract is load-bearing: data/processing.py's PIL path is the
// host-parity reference, so the fast path must not drift from it. The crop
// window is exploited for work-skipping only (horizontal pass computes only
// cropped columns; vertical pass only cropped rows) — per-pixel results are
// unchanged because the resample is pixel-independent.

#include <algorithm>
#include <atomic>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // PIL Resample.c PRECISION_BITS

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

// Keys bicubic, a = -0.5 (PIL's BICUBIC filter, support 2.0)
inline double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// PIL precompute_coeffs: antialiased support scaling on downsample, window
// clamping, sum-normalization, then fixed-point conversion.
struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;   // [out*2]: xmin, xcount
  std::vector<int32_t> kk;   // [out*ksize]
};

Coeffs precompute_coeffs(int in_size, int out_size, int out_lo, int out_hi) {
  // coefficients for output indices [out_lo, out_hi) of a full out_size
  // resize (crop-restricted work-skipping; indices stay absolute)
  constexpr double support_base = 2.0;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = support_base * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  int n = out_hi - out_lo;

  Coeffs c;
  c.ksize = ksize;
  c.bounds.resize(static_cast<size_t>(n) * 2);
  c.kk.resize(static_cast<size_t>(n) * ksize);
  std::vector<double> w(ksize);
  double ss = 1.0 / filterscale;
  for (int xx = 0; xx < n; ++xx) {
    double center = (out_lo + xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double wsum = 0.0;
    for (int x = 0; x < xmax; ++x) {
      w[x] = bicubic_filter((x + xmin - center + 0.5) * ss);
      wsum += w[x];
    }
    for (int x = 0; x < xmax; ++x) {
      if (wsum != 0.0) w[x] /= wsum;
    }
    int32_t* k = &c.kk[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      // PIL normalize_coeffs_8bpc rounding
      k[x] = static_cast<int32_t>(
          w[x] < 0 ? -0.5 + w[x] * (1 << kPrecisionBits)
                   : 0.5 + w[x] * (1 << kPrecisionBits));
    }
    for (int x = xmax; x < ksize; ++x) k[x] = 0;
    c.bounds[xx * 2 + 0] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

// one frame: [h, w, 3] uint8 -> [3, out, out] float32 (crop + normalize fused)
void preprocess_one(const uint8_t* src, int h, int w, int out_size,
                    const float* mean, const float* stdv, float* dst) {
  // shorter side -> out_size; Python round() = ties-to-even (nearbyint)
  int new_w, new_h;
  if (w <= h) {
    new_w = out_size;
    new_h = std::max(
        static_cast<int>(std::nearbyint(static_cast<double>(h) * out_size / w)),
        out_size);
  } else {
    new_h = out_size;
    new_w = std::max(
        static_cast<int>(std::nearbyint(static_cast<double>(w) * out_size / h)),
        out_size);
  }
  int left = (new_w - out_size) / 2;
  int top = (new_h - out_size) / 2;

  // pass 1: horizontal (w -> cropped out_size columns), all h rows
  Coeffs ch = precompute_coeffs(w, new_w, left, left + out_size);
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * out_size * 3);
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = src + static_cast<size_t>(yy) * w * 3;
    uint8_t* orow = tmp.data() + static_cast<size_t>(yy) * out_size * 3;
    for (int xx = 0; xx < out_size; ++xx) {
      int xmin = ch.bounds[xx * 2 + 0];
      int xcount = ch.bounds[xx * 2 + 1];
      const int32_t* k = &ch.kk[static_cast<size_t>(xx) * ch.ksize];
      int32_t s0 = 1 << (kPrecisionBits - 1);
      int32_t s1 = s0, s2 = s0;
      const uint8_t* p = row + static_cast<size_t>(xmin) * 3;
      for (int x = 0; x < xcount; ++x) {
        s0 += p[x * 3 + 0] * k[x];
        s1 += p[x * 3 + 1] * k[x];
        s2 += p[x * 3 + 2] * k[x];
      }
      orow[xx * 3 + 0] = clip8(s0);
      orow[xx * 3 + 1] = clip8(s1);
      orow[xx * 3 + 2] = clip8(s2);
    }
  }

  // pass 2: vertical (h -> cropped out_size rows), normalize into CHW f32
  Coeffs cv = precompute_coeffs(h, new_h, top, top + out_size);
  const size_t plane = static_cast<size_t>(out_size) * out_size;
  for (int yy = 0; yy < out_size; ++yy) {
    int ymin = cv.bounds[yy * 2 + 0];
    int ycount = cv.bounds[yy * 2 + 1];
    const int32_t* k = &cv.kk[static_cast<size_t>(yy) * cv.ksize];
    for (int xx = 0; xx < out_size; ++xx) {
      int32_t s0 = 1 << (kPrecisionBits - 1);
      int32_t s1 = s0, s2 = s0;
      const uint8_t* col = tmp.data() + static_cast<size_t>(xx) * 3;
      for (int y = 0; y < ycount; ++y) {
        const uint8_t* p =
            col + static_cast<size_t>(ymin + y) * out_size * 3;
        s0 += p[0] * k[y];
        s1 += p[1] * k[y];
        s2 += p[2] * k[y];
      }
      size_t o = static_cast<size_t>(yy) * out_size + xx;
      dst[0 * plane + o] = (clip8(s0) / 255.0f - mean[0]) / stdv[0];
      dst[1 * plane + o] = (clip8(s1) / 255.0f - mean[1]) / stdv[1];
      dst[2 * plane + o] = (clip8(s2) / 255.0f - mean[2]) / stdv[2];
    }
  }
}

}  // namespace

extern "C" {

// srcs: n pointers to [hs[i], ws[i], 3] uint8 HWC frames.
// out: [n, 3, out_size, out_size] float32. Returns 0 on success.
int teochat_preprocess_batch(const uint8_t** srcs, const int32_t* hs,
                             const int32_t* ws, int32_t n, int32_t out_size,
                             const float* mean, const float* stdv, float* out,
                             int32_t n_threads) {
  if (n <= 0 || out_size <= 0) return 1;
  const size_t frame_elems = 3 * static_cast<size_t>(out_size) * out_size;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = std::min<int>(n, n_threads > 0 ? n_threads : std::max(hw, 1));
  if (nt <= 1) {
    for (int i = 0; i < n; ++i) {
      preprocess_one(srcs[i], hs[i], ws[i], out_size, mean, stdv,
                     out + i * frame_elems);
    }
    return 0;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        preprocess_one(srcs[i], hs[i], ws[i], out_size, mean, stdv,
                       out + i * frame_elems);
      }
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

// uint8 resize only (shorter-side + crop semantics NOT applied): exact-parity
// test hook vs PIL Image.resize((ow, oh), BICUBIC). dst: [oh, ow, 3].
int teochat_resize_bicubic(const uint8_t* src, int32_t h, int32_t w,
                           uint8_t* dst, int32_t oh, int32_t ow) {
  Coeffs ch = precompute_coeffs(w, ow, 0, ow);
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * ow * 3);
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = src + static_cast<size_t>(yy) * w * 3;
    uint8_t* orow = tmp.data() + static_cast<size_t>(yy) * ow * 3;
    for (int xx = 0; xx < ow; ++xx) {
      int xmin = ch.bounds[xx * 2 + 0];
      int xcount = ch.bounds[xx * 2 + 1];
      const int32_t* k = &ch.kk[static_cast<size_t>(xx) * ch.ksize];
      int32_t s[3] = {1 << (kPrecisionBits - 1), 1 << (kPrecisionBits - 1),
                      1 << (kPrecisionBits - 1)};
      const uint8_t* p = row + static_cast<size_t>(xmin) * 3;
      for (int x = 0; x < xcount; ++x) {
        for (int c = 0; c < 3; ++c) s[c] += p[x * 3 + c] * k[x];
      }
      for (int c = 0; c < 3; ++c) orow[xx * 3 + c] = clip8(s[c]);
    }
  }
  Coeffs cv = precompute_coeffs(h, oh, 0, oh);
  for (int yy = 0; yy < oh; ++yy) {
    int ymin = cv.bounds[yy * 2 + 0];
    int ycount = cv.bounds[yy * 2 + 1];
    const int32_t* k = &cv.kk[static_cast<size_t>(yy) * cv.ksize];
    uint8_t* orow = dst + static_cast<size_t>(yy) * ow * 3;
    for (int xx = 0; xx < ow; ++xx) {
      int32_t s[3] = {1 << (kPrecisionBits - 1), 1 << (kPrecisionBits - 1),
                      1 << (kPrecisionBits - 1)};
      for (int y = 0; y < ycount; ++y) {
        const uint8_t* p =
            tmp.data() + (static_cast<size_t>(ymin + y) * ow + xx) * 3;
        for (int c = 0; c < 3; ++c) s[c] += p[c] * k[y];
      }
      for (int c = 0; c < 3; ++c) orow[xx * 3 + c] = clip8(s[c]);
    }
  }
  return 0;
}

}  // extern "C"
