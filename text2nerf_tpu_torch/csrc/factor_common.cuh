// Sample geometry shared by kernel A (factor_features.cu) and kernel A'
// (factor_features_bwd.cu): the fused tables' dimensions, the fp32
// corner and lerp-weight arithmetic of text2nerf_tpu/ops/fused_gather.py
// _coords (:40-44), and the walk kernels' per-axis geometry with its
// packed form for warp shuffles.  Both kernels recompute a sample's plane
// and line values with these, so the backward sees the forward's values.
// The bf16 mode's part (after the fp32 walk helpers): bf16 tables, the
// lerp weights packed for shuffles, and packed bf16x2 arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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

template <typename T>
struct TablesOf {
  const T* plane[3];
  const T* line[3];
};
using Tables = TablesOf<float>;
using TablesBf16 = TablesOf<__nv_bfloat16>;  // the bf16 mode's copy of the tables

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

// ---- the bf16 mode: packed bf16x2 arithmetic -----------------------------
//
// A 32-bit word holds two bf16 channels (the lower channel in the low
// half).  Each op rounds once to bf16 (.rn: never contracted into an fma).
// On bf16 inputs that is the bits of rnd<true> of the fp32 op, which the
// plain version computes: a product of two bf16 values is exact in fp32,
// and fp32 carries 24 >= 2 * 8 + 2 significand bits, so rounding a sum or
// a difference first to fp32 and then to bf16 gives the correctly rounded
// bf16 result.

__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a * (1 - t) + b * t on two channels: w = (1 - t) and t broadcast to
// both halves
__device__ __forceinline__ uint32_t lerp2(uint32_t a, uint32_t b, uint32_t w, uint32_t t) {
  return badd2(bmul2(a, w), bmul2(b, t));
}

__device__ __forceinline__ uint32_t bcast_lo(uint32_t v) { return __byte_perm(v, 0, 0x1010); }
__device__ __forceinline__ uint32_t bcast_hi(uint32_t v) { return __byte_perm(v, 0, 0x3232); }
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// a lerp weight t (fp32 from coords) as the word ((1 - t) lo, t hi), each
// rounded to bf16 as the plain version rounds them: t to bf16, then
// 1 - t in fp32 and to bf16
__device__ __forceinline__ uint32_t weight_pair(float t) {
  const uint32_t tb = bf16_bits(t);
  return bf16_bits(__fsub_rn(1.0f, __uint_as_float(tb << 16))) | (tb << 16);
}

// one axis of a sample in the bf16 walk: AxisGeo's rows, and the three
// weight pairs broadcast (w*: 1 - t, t*: t in both halves)
struct AxisGeo16 {
  int p00, dx, dyw, l0, dl;
  uint32_t wx, tx, wy, ty, wl, tl;
};

struct PackedGeo16 {
  uint32_t p, l, x, y, z;  // z: the line's weight pair
};

__device__ __forceinline__ PackedGeo16 geometry16(const float (&x)[3], int i, const Dims& d) {
  AxisGeo g;
  geometry<false>(x, i, d, g);
  const PackedGeo pg = pack(g);
  return {pg.p, pg.l, weight_pair(g.tx), weight_pair(g.ty), weight_pair(g.tl)};
}

// the geometry lane `src` holds
__device__ __forceinline__ AxisGeo16 shuffle_geo16(const PackedGeo16& pg, int src, int w) {
  const uint32_t p = __shfl_sync(0xffffffffu, pg.p, src);
  const uint32_t l = __shfl_sync(0xffffffffu, pg.l, src);
  const uint32_t x = __shfl_sync(0xffffffffu, pg.x, src);
  const uint32_t y = __shfl_sync(0xffffffffu, pg.y, src);
  const uint32_t z = __shfl_sync(0xffffffffu, pg.z, src);
  AxisGeo16 g;
  g.p00 = static_cast<int>(p & 0x3FFFFFFFu);
  g.dx = (p >> 30) & 1;
  g.dyw = (p >> 31) ? w : 0;
  g.l0 = static_cast<int>(l & 0x7FFFFFFFu);
  g.dl = l >> 31;
  g.wx = bcast_lo(x);
  g.tx = bcast_hi(x);
  g.wy = bcast_lo(y);
  g.ty = bcast_hi(y);
  g.wl = bcast_lo(z);
  g.tl = bcast_hi(z);
  return g;
}

// this lane's two channels (2 * lane, 2 * lane + 1) of a 64-channel bf16 row
__device__ __forceinline__ uint32_t load_row16(const __nv_bfloat16* table, int row, int lane,
                                               bool on) {
  if (!on) return 0u;
  return __ldg(reinterpret_cast<const unsigned int*>(table + static_cast<int64_t>(row) * kWalkC) +
               lane);
}

__device__ __forceinline__ void load_rows16(const __nv_bfloat16* plane,
                                            const __nv_bfloat16* line, const AxisGeo16& g,
                                            int lane, bool on, uint32_t (&pv)[4],
                                            uint32_t (&lv)[2]) {
  pv[0] = load_row16(plane, g.p00, lane, on);
  pv[1] = load_row16(plane, g.p00 + g.dx, lane, on);
  pv[2] = load_row16(plane, g.p00 + g.dyw, lane, on);
  pv[3] = load_row16(plane, g.p00 + g.dyw + g.dx, lane, on);
  lv[0] = load_row16(line, g.l0, lane, on);
  lv[1] = load_row16(line, g.l0 + g.dl, lane, on);
}

// the plane value pf and line value lf of two channels
__device__ __forceinline__ void values16(const uint32_t (&pv)[4], const uint32_t (&lv)[2],
                                         const AxisGeo16& g, uint32_t& pf, uint32_t& lf) {
  const uint32_t top = lerp2(pv[0], pv[1], g.wx, g.tx);
  const uint32_t bot = lerp2(pv[2], pv[3], g.wx, g.tx);
  pf = lerp2(top, bot, g.wy, g.ty);
  lf = lerp2(lv[0], lv[1], g.wl, g.tl);
}

// a table value of the generic kernels, as fp32
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

}  // namespace
