// Host-side image kernels (C runtime, ctypes ABI).
//
// The PyTorch port's own copy of the JAX package's native host kernels:
//   * sparse_bilateral: the depth and image filtering of the scene
//     bootstrap and of every expansion view;
//   * dibr_hole_fill2: the raster-order hole fill of a DIBR-warped view
//     (dibr_filter_mask2, utils.py:394-409), where a pixel filled early
//     counts as known for the pixels after it (order-dependent, so it is
//     sequential host code, not a vectorized device pass);
//   * dibr_hole_fill1: the reference's other hole fill (dibr_filter_mask,
//     utils.py:345-391), raster-order passes the same way;
//   * zbuffer_point_splat: the legacy per-pixel warp, first writer wins
//     in raster order (sequential for the same reason).
//
// Built with g++ -O3 -shared -fPIC at first use and loaded via ctypes by
// text2nerf_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// Sparse bilateral filtering (bilateral_filtering.py:5-35 driver +
// :138-228 discontinuity-median branch), bit-exact to the JAX package's
// CPU-backend jitted program (golden-tested): both run the reference's
// sequential float32 normalized prefix sum, whose rounding at near weight
// ties is part of the semantics.  The filter is *sparse* (medians only
// where a window touches a discontinuity), so it runs at host memory
// speed.
namespace {

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One weighted-median pass over `a` (H*W) given the binary discontinuity
// map; ring-replacement + edge padding folds into clamp(i, 1, h-2).
// `mask` (nullable) applies the reference's mask rules
// (bilateral_filtering.py:163-184): mask==0 centers are skipped and the
// coef window is multiplied by the ZERO-padded raw mask (the mask is
// neither ring-replaced nor edge-padded).
void discontinuity_median_pass(const float* a, const float* disc,
                               const float* mask, int h, int w, int win,
                               float* out) {
  const int m = win / 2;
  const int K = win * win;
  std::vector<float> vals(K);
  std::vector<float> coefs(K);
  std::vector<int> ord(K);
  for (int i = 0; i < h; ++i) {
    for (int j = 0; j < w; ++j) {
      const float center = a[clampi(i, 1, h - 2) * w + clampi(j, 1, w - 2)];
      if (mask && mask[i * w + j] == 0.f) {
        out[i * w + j] = center;
        continue;
      }
      bool touched = false, has_coef = false;
      for (int di = -m; di <= m && !(touched && has_coef); ++di) {
        const int ci = clampi(i + di, 1, h - 2) * w;
        const int mi = i + di;
        for (int dj = -m; dj <= m; ++dj) {
          const float d = disc[ci + clampi(j + dj, 1, w - 2)];
          const int mj = j + dj;
          const float mw =
              !mask ? 1.f
                    : (mi < 0 || mi >= h || mj < 0 || mj >= w
                           ? 0.f
                           : mask[mi * w + mj]);
          touched |= d > 0.f;
          has_coef |= (1.f - d) * mw > 0.f;
        }
      }
      if (!touched || !has_coef) {
        out[i * w + j] = center;
        continue;
      }
      int k = 0;
      float csum = 0.f;
      for (int di = -m; di <= m; ++di) {
        const int ci = clampi(i + di, 1, h - 2) * w;
        const int mi = i + di;
        for (int dj = -m; dj <= m; ++dj, ++k) {
          const int src = ci + clampi(j + dj, 1, w - 2);
          const int mj = j + dj;
          const float mw =
              !mask ? 1.f
                    : (mi < 0 || mi >= h || mj < 0 || mj >= w
                           ? 0.f
                           : mask[mi * w + mj]);
          vals[k] = a[src];
          coefs[k] = (1.f - disc[src]) * mw;
          csum += coefs[k];
        }
      }
      // stable insertion sort of indices by value (jnp.argsort is stable)
      for (int kk = 0; kk < K; ++kk) {
        int p = kk;
        const float v = vals[kk];
        while (p > 0 && vals[ord[p - 1]] > v) {
          ord[p] = ord[p - 1];
          --p;
        }
        ord[p] = kk;
      }
      // idx = #(cumsum(coef_sorted / csum) <= 0.5), clamped to K-1 — the
      // reference's digitize rule with its sequential float32 accumulation
      // (near weight ties the rounding decides the index, so the float
      // order is part of the semantics)
      float cum = 0.f;
      int idx = 0;
      for (int kk = 0; kk < K; ++kk) {
        cum += coefs[ord[kk]] / csum;
        if (cum <= 0.5f) ++idx;
      }
      if (idx > K - 1) idx = K - 1;
      out[i * w + j] = vals[ord[idx]];
    }
  }
}

}  // namespace

// Iterative sparse bilateral filter: `num_filters` passes of window sizes
// `filter_size[k]`, discontinuities recomputed from the *filtered* depth
// each pass (disparity-edge maps, bilateral_filtering.py:72-122), image
// channels filtered with the same map.  depth_io (H*W) and image_io
// (H*W*C) are updated in place; depth0 is the ORIGINAL depth (zero-depth
// pixels force disc=1); mask (H*W) may be null.
void sparse_bilateral(float* depth_io, float* image_io, const float* depth0,
                      const float* mask, int h, int w, int c,
                      const int32_t* filter_size, int num_filters,
                      float threshold) {
  const size_t n = (size_t)h * w;
  std::vector<float> disp(n), disc(n), buf(n), chan(n);
  for (int it = 0; it < num_filters; ++it) {
    const int win = filter_size[it];
    // disparity discontinuity -> binary disc map (borders zero, then the
    // depth0==0 / mask==0 overrides applied over the FULL map)
    for (size_t p = 0; p < n; ++p) disp[p] = 1.f / depth_io[p];
    std::memset(disc.data(), 0, n * sizeof(float));
    for (int i = 1; i < h - 1; ++i)
      for (int j = 1; j < w - 1; ++j) {
        const size_t p = (size_t)i * w + j;
        float du = disp[p] - disp[p - w];
        float db = disp[p] - disp[p + w];
        float dl = disp[p] - disp[p - 1];
        float dr = disp[p] - disp[p + 1];
        if (mask) {
          du *= mask[p] * mask[p - w];
          db *= mask[p] * mask[p + w];
          dl *= mask[p] * mask[p - 1];
          dr *= mask[p] * mask[p + 1];
        }
        if (std::fabs(du) > threshold || std::fabs(db) > threshold ||
            std::fabs(dl) > threshold || std::fabs(dr) > threshold)
          disc[p] = 1.f;
      }
    for (size_t p = 0; p < n; ++p) {
      if (depth0[p] == 0.f) disc[p] = 1.f;
      if (mask && mask[p] == 0.f) disc[p] = 0.f;
    }
    discontinuity_median_pass(depth_io, disc.data(), mask, h, w, win,
                              buf.data());
    std::memcpy(depth_io, buf.data(), n * sizeof(float));
    for (int cc = 0; cc < c; ++cc) {
      for (size_t p = 0; p < n; ++p) chan[p] = image_io[p * c + cc];
      discontinuity_median_pass(chan.data(), disc.data(), mask, h, w, win,
                                buf.data());
      for (size_t p = 0; p < n; ++p) image_io[p * c + cc] = buf[p];
    }
  }
}

// ---------------------------------------------------------------------------
// dibr_filter_mask2 (utils.py:394-409): one raster-order pass of weighted
// hole filling.
namespace {

// 5x5 neighborhood weights (utils.py:347,396)
const float W5[25] = {
    1.f, 1.f, 1.5f, 1.f, 1.f,
    1.f, 1.5f, 3.f, 1.5f, 1.f,
    1.5f, 3.f, 0.f, 3.f, 1.5f,
    1.f, 1.5f, 3.f, 1.5f, 1.f,
    1.f, 1.f, 1.5f, 1.f, 1.f,
};
// 3x3 weights of the second pass and of the removal pass (utils.py:356)
const float W3[9] = {1.f, 3.f, 1.f, 3.f, 0.f, 3.f, 1.f, 3.f, 1.f};

inline float weighted_known_fraction_5x5(const float* mask, int w, int i, int j) {
  float sum = 0.f, total = 0.f;
  for (int di = -2; di <= 2; ++di)
    for (int dj = -2; dj <= 2; ++dj) {
      float wgt = W5[(di + 2) * 5 + (dj + 2)];
      total += wgt;
      sum += wgt * mask[(i + di) * w + (j + dj)];
    }
  return sum / total;
}

inline float weighted_known_fraction_3x3(const float* mask, int w, int i, int j) {
  float sum = 0.f, total = 0.f;
  for (int di = -1; di <= 1; ++di)
    for (int dj = -1; dj <= 1; ++dj) {
      float wgt = W3[(di + 1) * 3 + (dj + 1)];
      total += wgt;
      sum += wgt * mask[(i + di) * w + (j + dj)];
    }
  return sum / total;
}

// mask-weighted 3x3 mean fill of image (and optional depth) at (i, j)
inline void fill_pixel(float* image, float* depth, const float* mask, int w,
                       int c, int i, int j) {
  float msum = 0.f;
  for (int di = -1; di <= 1; ++di)
    for (int dj = -1; dj <= 1; ++dj) msum += mask[(i + di) * w + (j + dj)];
  if (msum <= 0.f) return;
  for (int cc = 0; cc < c; ++cc) {
    float acc = 0.f;
    for (int di = -1; di <= 1; ++di)
      for (int dj = -1; dj <= 1; ++dj)
        acc += image[((i + di) * w + (j + dj)) * c + cc] *
               mask[(i + di) * w + (j + dj)];
    image[(i * w + j) * c + cc] = acc / msum;
  }
  if (depth) {
    float acc = 0.f;
    for (int di = -1; di <= 1; ++di)
      for (int dj = -1; dj <= 1; ++dj)
        acc += depth[(i + di) * w + (j + dj)] * mask[(i + di) * w + (j + dj)];
    depth[i * w + j] = acc / msum;
  }
}

}  // namespace

// Mutates image (H*W*C), mask (H*W) and depth (H*W, may be null) in place:
// each empty pixel two or more from the border whose weighted known
// fraction exceeds `threshold` takes the mask-weighted 3x3 mean and
// becomes known.
void dibr_hole_fill2(float* image, float* mask, float* depth, int h, int w,
                     int c, float threshold) {
  for (int i = 2; i < h - 2; ++i)
    for (int j = 2; j < w - 2; ++j) {
      if (mask[i * w + j] != 0.f) continue;
      if (weighted_known_fraction_5x5(mask, w, i, j) > threshold) {
        fill_pixel(image, depth, mask, w, c, i, j);
        mask[i * w + j] = 1.f;
      }
    }
}

// dibr_filter_mask (utils.py:345-391): a 5x5 pass (threshold 0.6), a 3x3
// pass (threshold 0.5), border extension, then isolated known pixels
// (3x3 known fraction < 0.45) are reset to `fill_value` and unknown.
void dibr_hole_fill1(float* image, float* mask, int h, int w, int c,
                     float fill_value) {
  for (int i = 2; i < h - 2; ++i)
    for (int j = 2; j < w - 2; ++j)
      if (mask[i * w + j] == 0.f && weighted_known_fraction_5x5(mask, w, i, j) > 0.6f) {
        fill_pixel(image, nullptr, mask, w, c, i, j);
        mask[i * w + j] = 1.f;
      }
  for (int i = 1; i < h - 1; ++i)
    for (int j = 1; j < w - 1; ++j)
      if (mask[i * w + j] == 0.f && weighted_known_fraction_3x3(mask, w, i, j) > 0.5f) {
        fill_pixel(image, nullptr, mask, w, c, i, j);
        mask[i * w + j] = 1.f;
      }
  // border extension (utils.py:364-383): top and bottom rows, then the
  // left and right columns, each from its inner neighbour
  for (int j = 0; j < w; ++j) {
    if (mask[j] == 0.f && mask[w + j] > 0.f) {
      for (int cc = 0; cc < c; ++cc) image[j * c + cc] = image[(w + j) * c + cc];
      mask[j] = 1.f;
    }
    int i = h - 1;
    if (mask[i * w + j] == 0.f && mask[(i - 1) * w + j] > 0.f) {
      for (int cc = 0; cc < c; ++cc)
        image[(i * w + j) * c + cc] = image[((i - 1) * w + j) * c + cc];
      mask[i * w + j] = 1.f;
    }
  }
  for (int i = 0; i < h; ++i) {
    if (mask[i * w] == 0.f && mask[i * w + 1] > 0.f) {
      for (int cc = 0; cc < c; ++cc) image[(i * w) * c + cc] = image[(i * w + 1) * c + cc];
      mask[i * w] = 1.f;
    }
    int j = w - 1;
    if (mask[i * w + j] == 0.f && mask[i * w + j - 1] > 0.f) {
      for (int cc = 0; cc < c; ++cc)
        image[(i * w + j) * c + cc] = image[(i * w + j - 1) * c + cc];
      mask[i * w + j] = 1.f;
    }
  }
  // isolated-pixel removal (utils.py:384-389)
  for (int i = 1; i < h - 1; ++i)
    for (int j = 1; j < w - 1; ++j)
      if (mask[i * w + j] == 1.f && weighted_known_fraction_3x3(mask, w, i, j) < 0.45f) {
        for (int cc = 0; cc < c; ++cc) image[(i * w + j) * c + cc] = fill_value;
        mask[i * w + j] = 0.f;
      }
}

// Sequential z-buffer point splat (the legacy per-pixel warp,
// utils.py:199-213 / scene_util.py:75-89): the first writer wins each
// target pixel, sources scanned in raster order.  xs / ys are the rounded
// target coordinates, zs the target-space depths; points may be null.
void zbuffer_point_splat(const int16_t* xs, const int16_t* ys, const float* zs,
                         const float* src, float* out, float* points,
                         uint8_t* mask, int h, int w, int c) {
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < w; ++j) {
      int x = xs[i * w + j], y = ys[i * w + j];
      float z = zs[i * w + j];
      if (x < 0 || x >= w || y < 0 || y >= h || z <= 0.f) continue;
      if (mask[y * w + x]) continue;
      for (int cc = 0; cc < c; ++cc) out[(y * w + x) * c + cc] = src[(i * w + j) * c + cc];
      if (points) points[y * w + x] = z;
      mask[y * w + x] = 1;
    }
}

}  // extern "C"
