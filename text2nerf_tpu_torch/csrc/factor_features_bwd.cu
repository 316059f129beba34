// Kernel A': the backward of kernel A (factor_features.cu), a scatter-add
// of the feature gradients into the fused factor tables.
//
// Replaces XLA's autodiff of text2nerf_tpu/models/tensorf.py
// compute_fused_features_packed (:538) and its density-only (:335) and
// app-only (:575) forms: the transpose of the corner-packed gathers of
// text2nerf_tpu/ops/fused_gather.py (:47-83), which the JAX package's
// train step spends most of its time in (text2nerf_tpu/engine/
// train_step.py:140-142).
//
// Per sample n and axis i, with g[c] = d_sigma[n] on the density channels
// (c < nd_i) and d_app_raw[n, app_off_i + c - nd_i] on the app channels:
// the plane value pf and line value lf are recomputed exactly as the
// forward computes them; dpf = g*lf goes to the four bilinear corners with
// weights (1-tx)(1-ty), tx(1-ty), (1-tx)ty, tx*ty and dlf = g*pf to the two
// line rows with weights (1-t), t, in the order of reverse-mode autodiff of
// the lerps (d_top = dpf*(1-ty), then d_top*(1-tx), ...).  The upper index
// is edge-clamped as in the forward, so at the border both weights land in
// one row, as the gradient of the JAX package's edge padding lands.  The
// output tables are fp32 in the fused layout, zeroed by the launcher
// (unless the caller accumulates) and then added to with atomics.
//
// What bounds it on an H100: bytes.  A sample reads 12 B of coordinates,
// 4 B of d_sigma and 576 B of d_app_raw (144 fp32 at full width) and the
// table rows it touches; the outputs are the tables (69 MB at full width)
// written once.  About 28 flops per channel, axis and sample.  What limits
// it in practice is the atomics: 6 rows x 64 channels per axis and sample
// (1152 fp32 adds a sample at full width), served by the L2.
//
// Design (a first, simple kernel).  Walk kernel (every axis 64 channels,
// even density counts, 8-byte aligned tables and gradients, the main
// path's tables): one warp walks a run of 32 consecutive samples, axis by
// axis, as kernel A's walk does: lane j computes sample j's geometry once
// and the warp reads it with shuffles; each lane owns 2 channels, so a
// row's update is one coalesced 256 B row of float2 reductions
// (red.global.add.v2.f32 on sm_90).  One atomic per (row, channel pair)
// per sample: merging consecutive samples' updates to a shared row before
// the atomic is left to a later redesign.  Generic kernel (other widths):
// one warp per sample, lanes stride the channels, scalar atomics.
// fp32 only (the bf16 backward is not ported).  The atomics add in an
// order that changes from run to run, so the result is held against the
// plain version (factor_features_backward_plain) to a tolerance.

#include "factor_common.cuh"

namespace {

struct GradTables {
  float* plane[3];
  float* line[3];
};

__device__ __forceinline__ void add2(float* addr, float a, float b) {
#if __CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(reinterpret_cast<float2*>(addr), make_float2(a, b));
#else
  atomicAdd(addr, a);
  atomicAdd(addr + 1, b);
#endif
}

// one channel: the gradients of the four plane corners and the two line
// rows, every op separately rounded (no FMA contraction)
__device__ __forceinline__ void channel_grads(float p00, float p01, float p10, float p11,
                                              float q0, float q1, float g, const AxisGeo& geo,
                                              float (&dp)[4], float (&dl)[2]) {
  const float top = lerp<false>(p00, p01, geo.tx);
  const float bot = lerp<false>(p10, p11, geo.tx);
  const float pf = lerp<false>(top, bot, geo.ty);
  const float lf = lerp<false>(q0, q1, geo.tl);
  const float dpf = __fmul_rn(g, lf);
  const float dlf = __fmul_rn(g, pf);
  const float d_top = __fmul_rn(dpf, __fsub_rn(1.0f, geo.ty));
  const float d_bot = __fmul_rn(dpf, geo.ty);
  const float wx = __fsub_rn(1.0f, geo.tx);
  dp[0] = __fmul_rn(d_top, wx);
  dp[1] = __fmul_rn(d_top, geo.tx);
  dp[2] = __fmul_rn(d_bot, wx);
  dp[3] = __fmul_rn(d_bot, geo.tx);
  dl[0] = __fmul_rn(dlf, __fsub_rn(1.0f, geo.tl));
  dl[1] = __fmul_rn(dlf, geo.tl);
}

// One warp walks a run of up to 32 consecutive samples, axis by axis; lane
// j holds sample j's geometry and d_sigma, handed out by shuffles.  Lanes
// whose channels the mode does not touch stay idle.
template <bool SIGMA, bool APP>
__global__ void __launch_bounds__(256)
factor_features_bwd_walk_kernel(const float* __restrict__ xn, int n, Tables tab, Dims d,
                                int app_stride, const float* __restrict__ d_sigma,
                                const float* __restrict__ d_app, GradTables out) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t base = warp * kWalkRun;
  if (base >= n) return;
  const int cnt = static_cast<int>(base + kWalkRun <= n ? kWalkRun : n - base);
  const int ch = 2 * lane;  // this lane's channels: ch, ch + 1 of every axis

  float x[3] = {0.0f, 0.0f, 0.0f};
  float gs = 0.0f;
  if (lane < cnt) {
    x[0] = xn[3 * (base + lane)];
    x[1] = xn[3 * (base + lane) + 1];
    x[2] = xn[3 * (base + lane) + 2];
    if (SIGMA) gs = d_sigma[base + lane];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int w = d.w[i], nd = d.nd[i];
    const bool dens = ch < nd;  // nd is even: both channels are density or both app
    const bool on = dens ? SIGMA : APP;
    PackedGeo mine;
    {
      AxisGeo g;
      geometry<false>(x, i, d, g);
      mine = pack(g);
    }
    float* dplane = out.plane[i];
    float* dline = out.line[i];
    for (int j = 0; j < cnt; ++j) {
      const AxisGeo geo = shuffle_geo(mine, j, w);
      const float gsig = SIGMA ? __shfl_sync(0xffffffffu, gs, j) : 0.0f;
      if (!on) continue;
      float2 gv;
      if (dens) {
        gv = make_float2(gsig, gsig);
      } else {
        gv = __ldg(reinterpret_cast<const float2*>(d_app + (base + j) * app_stride +
                                                   d.app_off[i] + (ch - nd)));
      }
      float2 pv[4], lv[2];
      load_rows(tab.plane[i], tab.line[i], geo, ch, true, pv, lv);
      float dp0[4], dl0[2], dp1[4], dl1[2];
      channel_grads(pv[0].x, pv[1].x, pv[2].x, pv[3].x, lv[0].x, lv[1].x, gv.x, geo, dp0, dl0);
      channel_grads(pv[0].y, pv[1].y, pv[2].y, pv[3].y, lv[0].y, lv[1].y, gv.y, geo, dp1, dl1);
      const int64_t p = geo.p00;
      add2(dplane + p * kWalkC + ch, dp0[0], dp1[0]);
      add2(dplane + (p + geo.dx) * kWalkC + ch, dp0[1], dp1[1]);
      add2(dplane + (p + geo.dyw) * kWalkC + ch, dp0[2], dp1[2]);
      add2(dplane + (p + geo.dyw + geo.dx) * kWalkC + ch, dp0[3], dp1[3]);
      add2(dline + static_cast<int64_t>(geo.l0) * kWalkC + ch, dl0[0], dl1[0]);
      add2(dline + static_cast<int64_t>(geo.l0 + geo.dl) * kWalkC + ch, dl0[1], dl1[1]);
    }
  }
}

// Generic kernel: one warp per sample, lanes stride the channels.
template <bool SIGMA, bool APP>
__global__ void factor_features_bwd_kernel(const float* __restrict__ xn, int n, Tables tab,
                                           Dims d, int app_stride,
                                           const float* __restrict__ d_sigma,
                                           const float* __restrict__ d_app, GradTables out) {
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= n) return;
  const float x[3] = {xn[3 * s], xn[3 * s + 1], xn[3 * s + 2]};
  const float gsig = SIGMA ? d_sigma[s] : 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int c = d.c[i], nd = d.nd[i];
    AxisGeo geo;
    geometry<false>(x, i, d, geo);
    const int64_t r[4] = {geo.p00, geo.p00 + geo.dx, geo.p00 + geo.dyw,
                          geo.p00 + geo.dyw + geo.dx};
    const int64_t q[2] = {geo.l0, geo.l0 + geo.dl};
    const float* plane = tab.plane[i];
    const float* line = tab.line[i];
    const int c_lo = SIGMA ? 0 : nd;
    const int c_hi = APP ? c : nd;
    for (int ch = c_lo + lane; ch < c_hi; ch += 32) {
      const float g = ch < nd ? gsig : __ldg(d_app + s * app_stride + d.app_off[i] + (ch - nd));
      float dp[4], dl[2];
      channel_grads(__ldg(plane + r[0] * c + ch), __ldg(plane + r[1] * c + ch),
                    __ldg(plane + r[2] * c + ch), __ldg(plane + r[3] * c + ch),
                    __ldg(line + q[0] * c + ch), __ldg(line + q[1] * c + ch), g, geo, dp, dl);
#pragma unroll
      for (int k = 0; k < 4; ++k) atomicAdd(out.plane[i] + r[k] * c + ch, dp[k]);
      atomicAdd(out.line[i] + q[0] * c + ch, dl[0]);
      atomicAdd(out.line[i] + q[1] * c + ch, dl[1]);
    }
  }
}

template <bool SIGMA, bool APP>
void launch(const float* xn, int n, bool walk, const Tables& tab, const Dims& d, int app_stride,
            const float* d_sigma, const float* d_app, const GradTables& out,
            cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 warps
  const int64_t warps = walk ? (static_cast<int64_t>(n) + kWalkRun - 1) / kWalkRun : n;
  const unsigned blocks = static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  if (walk) {
    factor_features_bwd_walk_kernel<SIGMA, APP><<<blocks, kThreads, 0, stream>>>(
        xn, n, tab, d, app_stride, d_sigma, d_app, out);
  } else {
    factor_features_bwd_kernel<SIGMA, APP><<<blocks, kThreads, 0, stream>>>(
        xn, n, tab, d, app_stride, d_sigma, d_app, out);
  }
}

bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

}  // namespace

// dims: 18 ints, h[3] w[3] l[3] c[3] nd[3] app_off[3] (kernel A's layout).
// d_sigma and/or d_app may be null; at least one is not.  zero != 0 zeroes
// the six gradient tables first (on the same stream); zero == 0 adds into
// them.  The walk kernel runs when every axis has 64 channels, an even
// density count and a plane of fewer than 2^30 rows, and the tables,
// gradient tables and d_app are 8-byte aligned with an even app_stride
// (else the generic kernel, one sample per warp).  Returns the first CUDA
// error of the memsets and the launch.
extern "C" int t2n_factor_features_bwd(const float* xn, int n,
                                       const float* plane0, const float* plane1,
                                       const float* plane2, const float* line0,
                                       const float* line1, const float* line2, const int* dims,
                                       int app_stride, const float* d_sigma, const float* d_app,
                                       float* dplane0, float* dplane1, float* dplane2,
                                       float* dline0, float* dline1, float* dline2, int zero,
                                       void* stream) {
  Dims d;
  for (int i = 0; i < 3; ++i) {
    d.h[i] = dims[i];
    d.w[i] = dims[3 + i];
    d.l[i] = dims[6 + i];
    d.c[i] = dims[9 + i];
    d.nd[i] = dims[12 + i];
    d.app_off[i] = dims[15 + i];
  }
  d.dens_lanes = 0;  // kernel A's shared-memory sizing; unused here
  const Tables tab = {{plane0, plane1, plane2}, {line0, line1, line2}};
  const GradTables out = {{dplane0, dplane1, dplane2}, {dline0, dline1, dline2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (zero) {
    for (int i = 0; i < 3 && err == 0; ++i) {
      const size_t pbytes = sizeof(float) * d.h[i] * d.w[i] * d.c[i];
      const size_t lbytes = sizeof(float) * d.l[i] * d.c[i];
      err = static_cast<int>(cudaMemsetAsync(out.plane[i], 0, pbytes, st));
      if (err == 0) err = static_cast<int>(cudaMemsetAsync(out.line[i], 0, lbytes, st));
    }
    if (err != 0) return err;
  }
  const bool sig = d_sigma != nullptr, app = d_app != nullptr;
  bool walk = (!app || (aligned8(d_app) && app_stride % 2 == 0));
  for (int i = 0; i < 3; ++i) {
    walk = walk && d.c[i] == kWalkC && d.nd[i] % 2 == 0 &&
           static_cast<int64_t>(d.h[i]) * d.w[i] < (1 << 30) && aligned8(tab.plane[i]) &&
           aligned8(tab.line[i]) && aligned8(out.plane[i]) && aligned8(out.line[i]);
  }
  if (sig && app) {
    launch<true, true>(xn, n, walk, tab, d, app_stride, d_sigma, d_app, out, st);
  } else if (sig) {
    launch<true, false>(xn, n, walk, tab, d, app_stride, d_sigma, d_app, out, st);
  } else {
    launch<false, true>(xn, n, walk, tab, d, app_stride, d_sigma, d_app, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}
