// Sample geometry shared by kernel A (factor_features.cu) and kernel A'
// (factor_features_bwd.cu): the fused tables' dimensions, the fp32
// corner and lerp-weight arithmetic of text2nerf_tpu/ops/fused_gather.py
// _coords (:40-44), and the walk kernels' per-axis geometry with its
// packed form for warp shuffles.  Both kernels recompute a sample's plane
// and line values with these, so the backward sees the forward's values.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// MAT_MODE = ((0,1),(0,2),(1,2)), VEC_MODE = (2,1,0) (tensorf.py:43-44);
// compile-time after the axis loop unrolls, so x[] stays in registers
__device__ __forceinline__ constexpr int mat0(int i) { return i == 2 ? 1 : 0; }
__device__ __forceinline__ constexpr int mat1(int i) { return i == 0 ? 1 : 2; }
__device__ __forceinline__ constexpr int vec(int i) { return 2 - i; }

struct Dims {
  int h[3], w[3], l[3], c[3], nd[3], app_off[3];
  int dens_lanes;  // walk kernel: the most density lanes (nd / 2) of an axis
};

struct Tables {
  const float* plane[3];
  const float* line[3];
};

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

// _coords (fused_gather.py:40-44): same fp32 operation order
__device__ __forceinline__ void coords(float u, int size, int& i0, float& t) {
  const float f = (u + 1.0f) * 0.5f * static_cast<float>(size - 1);
  i0 = min(max(static_cast<int>(floorf(f)), 0), size - 1);
  t = fminf(fmaxf(f - static_cast<float>(i0), 0.0f), 1.0f);
}

template <bool BF16>
__device__ __forceinline__ float lerp(float a, float b, float t) {
  // a * (1 - t) + b * t, each op rounded in the compute type
  const float wa = rnd<BF16>(__fsub_rn(1.0f, t));
  return rnd<BF16>(__fadd_rn(rnd<BF16>(__fmul_rn(a, wa)), rnd<BF16>(__fmul_rn(b, t))));
}

constexpr int kWalkC = 64;      // fused channels per axis the walk kernel takes
constexpr int kWalkRun = 32;    // samples a warp walks (the last run may be shorter)

// one axis of a sample: plane corner rows p00 + {0, dx, dyw, dyw + dx}
// (row = y*W + x; dx, dy are 0 at the clamped edge), line rows l0, l0 + dl,
// and the lerp weights
struct AxisGeo {
  int p00, dx, dyw, l0, dl;
  float tx, ty, tl;
};

template <bool BF16>
__device__ __forceinline__ void geometry(const float (&x)[3], int i, const Dims& d, AxisGeo& g) {
  const int w = d.w[i];
  int x0, y0, l0;
  coords(x[mat0(i)], w, x0, g.tx);       // plane x indexes W
  coords(x[mat1(i)], d.h[i], y0, g.ty);  // plane y indexes H
  coords(x[vec(i)], d.l[i], l0, g.tl);
  g.tx = rnd<BF16>(g.tx);
  g.ty = rnd<BF16>(g.ty);
  g.tl = rnd<BF16>(g.tl);
  g.p00 = y0 * w + x0;
  g.dx = x0 + 1 < w ? 1 : 0;
  g.dyw = y0 + 1 < d.h[i] ? w : 0;
  g.l0 = l0;
  g.dl = l0 + 1 < d.l[i] ? 1 : 0;
}

// geometry packed for a shuffle: p00 | dx << 30 | dy << 31, l0 | dl << 31
struct PackedGeo {
  uint32_t p, l;
  float tx, ty, tl;
};

__device__ __forceinline__ PackedGeo pack(const AxisGeo& g) {
  return {static_cast<uint32_t>(g.p00) | (static_cast<uint32_t>(g.dx) << 30) |
              (g.dyw ? 1u << 31 : 0u),
          static_cast<uint32_t>(g.l0) | (static_cast<uint32_t>(g.dl) << 31), g.tx, g.ty, g.tl};
}

// the geometry lane `src` holds
__device__ __forceinline__ AxisGeo shuffle_geo(const PackedGeo& pg, int src, int w) {
  const uint32_t p = __shfl_sync(0xffffffffu, pg.p, src);
  const uint32_t l = __shfl_sync(0xffffffffu, pg.l, src);
  AxisGeo g;
  g.p00 = static_cast<int>(p & 0x3FFFFFFFu);
  g.dx = (p >> 30) & 1;
  g.dyw = (p >> 31) ? w : 0;
  g.l0 = static_cast<int>(l & 0x7FFFFFFFu);
  g.dl = l >> 31;
  g.tx = __shfl_sync(0xffffffffu, pg.tx, src);
  g.ty = __shfl_sync(0xffffffffu, pg.ty, src);
  g.tl = __shfl_sync(0xffffffffu, pg.tl, src);
  return g;
}

__device__ __forceinline__ float2 load_row(const float* table, int row, int ch, bool on) {
  if (!on) return make_float2(0.0f, 0.0f);
  return __ldg(reinterpret_cast<const float2*>(table + static_cast<int64_t>(row) * kWalkC + ch));
}

// one axis of a sample: its 4 plane corner rows and 2 line rows
__device__ __forceinline__ void load_rows(const float* plane, const float* line,
                                          const AxisGeo& g, int ch, bool on, float2 (&pv)[4],
                                          float2 (&lv)[2]) {
  pv[0] = load_row(plane, g.p00, ch, on);
  pv[1] = load_row(plane, g.p00 + g.dx, ch, on);
  pv[2] = load_row(plane, g.p00 + g.dyw, ch, on);
  pv[3] = load_row(plane, g.p00 + g.dyw + g.dx, ch, on);
  lv[0] = load_row(line, g.l0, ch, on);
  lv[1] = load_row(line, g.l0 + g.dl, ch, on);
}

}  // namespace
