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
// What bounds it on an H100: bytes in principle (the ~0.2 ms of reading
// 1M samples' gradients and writing 69 MB of tables), the L2's atomics in
// practice.  A first kernel that added each sample's 6 rows x 64 channels
// per axis straight into the tables (one float2 reduction per row and
// lane pair, 0.604 G per 1M samples) took ~5 ms, and took it whatever the
// samples' order: the line tables have only L = 300 rows, so a third of
// those reductions pile thousands deep onto each line row.
//
// Design.  Shared route (every axis 64 channels, even density counts,
// 8-byte aligned tables and gradients, the main path's tables): a
// persistent grid of as many blocks as fit on the card, each warp walking
// one contiguous span of samples in runs of 32 (lane j computes sample j's
// geometry once, the warp reads it by shuffle, so every branch is
// warp-uniform; each lane owns 2 channels), axis by axis.
//  - Line rows: each block adds into its own copy of the axis's line
//    gradient (L x 64 fp32, so the longest line must fit in one block's
//    shared memory) with shared atomics and reduces it into the table
//    once per axis, four channels per float4 reduction.  Reducing line
//    rows straight into the table instead took ~3.5 ms more per 1M
//    samples (PERF.md): they pile onto 3 x 300 rows.
//  - Plane rows: one float2 reduction per corner row and lane pair.
//    Merging a ray's repeated rows in registers before the reduction
//    issued 2.9x fewer of them, was faster on neighbouring rays and slower
//    on a train step's own gradients (PERF.md): the walk is held by its
//    loads' latency more than by the L2, so instead the next sample's
//    geometry, gradient and rows are loaded before the current one's
//    arithmetic.
//  - A sample whose gradient is zero on every channel of the axis (a
//    compacted step's padding and past-the-surface members, half of a
//    train step's samples) is skipped after a warp vote: adding +0
//    changes no entry of a finite table.
// Generic route (other widths, or a line too long for shared memory): one
// warp per sample, lanes stride the channels, scalar atomics.  fp32 only
// (the bf16 backward is not ported).
// The atomics add in an order that changes from run to run, so the result
// is held against the plain version (factor_features_backward_plain) to a
// tolerance.

#include <algorithm>
#include <map>
#include <mutex>

#include "factor_common.cuh"

namespace {

struct GradTables {
  float* plane[3];
  float* line[3];
};

// the routes, as the launcher reports them (info[0])
constexpr int kRouteShared = 1;   // walk, line gradients in shared memory
constexpr int kRouteGeneric = 2;  // one warp per sample
// 16 warps a block, two blocks an SM (64 registers a thread; the line
// gradient, 76.8 KB at L = 300, twice in shared memory)
constexpr int kWalkThreads = 512;
constexpr int kWalkWarps = kWalkThreads / 32;

__device__ __forceinline__ void add2(float* addr, float a, float b) {
#if __CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(reinterpret_cast<float2*>(addr), make_float2(a, b));
#else
  atomicAdd(addr, a);
  atomicAdd(addr + 1, b);
#endif
}

__device__ __forceinline__ void add4(float* addr, float4 v) {
#if __CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(reinterpret_cast<float4*>(addr), v);
#else
  add2(addr, v.x, v.y);
  add2(addr + 2, v.z, v.w);
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

// Shared route.  Warp g of the grid walks runs [g*R/G, (g+1)*R/G) of the R
// runs of 32 samples (G warps in all), so a block's samples are
// contiguous.  Dynamic shared memory holds one axis's line gradient,
// [L][2][32] (lane-major within each half of a row, so a warp's shared
// atomics hit 32 banks): entry (row, c) at row*64 + (c&1)*32 + c/2.
// Lanes whose channels the mode does not touch stay idle.
template <bool SIGMA, bool APP>
__global__ void __launch_bounds__(kWalkThreads, 2)
factor_features_bwd_walk_kernel(const float* __restrict__ xn, int n, Tables tab, Dims d,
                                int app_stride, const float* __restrict__ d_sigma,
                                const float* __restrict__ d_app, GradTables out) {
  extern __shared__ float4 smem4[];
  float* sline = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int ch = 2 * lane;  // this lane's channels: ch, ch + 1 of every axis
  const int64_t runs = (static_cast<int64_t>(n) + kWalkRun - 1) / kWalkRun;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWalkWarps;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kWalkWarps + (threadIdx.x >> 5);
  const int64_t run_lo = g * runs / warps, run_hi = (g + 1) * runs / warps;
  const int lmax = max(d.l[0], max(d.l[1], d.l[2]));
  for (int k = threadIdx.x; k < lmax * (kWalkC / 4); k += kWalkThreads) {
    smem4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int w = d.w[i], nd = d.nd[i];
    const bool dens = ch < nd;  // nd is even: both channels are density or both app
    const bool on = dens ? SIGMA : APP;
    float* dplane = out.plane[i];
    float* dline = out.line[i];
    // a line row's two channels of this lane, into the block's copy
    const auto line_add = [&](int row, float a, float b) {
      atomicAdd(sline + row * kWalkC + lane, a);
      atomicAdd(sline + row * kWalkC + 32 + lane, b);
    };

    for (int64_t run = run_lo; run < run_hi; ++run) {
      const int64_t base = run * kWalkRun;
      const int cnt = static_cast<int>(base + kWalkRun <= n ? kWalkRun : n - base);
      float x[3] = {0.0f, 0.0f, 0.0f};
      float gs = 0.0f;
      if (lane < cnt) {
        x[0] = xn[3 * (base + lane)];
        x[1] = xn[3 * (base + lane) + 1];
        x[2] = xn[3 * (base + lane) + 2];
        if (SIGMA) gs = d_sigma[base + lane];
      }
      PackedGeo mine;
      {
        AxisGeo gg;
        geometry<false>(x, i, d, gg);
        mine = pack(gg);
      }
      // sample j's geometry, gradient and table rows; the next sample's are
      // loaded before this one's arithmetic (latency, not bandwidth, holds
      // a warp back)
      const auto fetch = [&](int j, AxisGeo& geo, float2& gv, float2 (&pv)[4],
                             float2 (&lv)[2]) {
        geo = shuffle_geo(mine, j, w);
        const float gsig = SIGMA ? __shfl_sync(0xffffffffu, gs, j) : 0.0f;
        gv = make_float2(0.0f, 0.0f);
        if (on) {
          gv = dens ? make_float2(gsig, gsig)
                    : __ldg(reinterpret_cast<const float2*>(d_app + (base + j) * app_stride +
                                                            d.app_off[i] + (ch - nd)));
        }
        load_rows(tab.plane[i], tab.line[i], geo, ch, on, pv, lv);
      };
      AxisGeo next_geo;
      float2 next_gv, next_pv[4], next_lv[2];
      fetch(0, next_geo, next_gv, next_pv, next_lv);
      for (int j = 0; j < cnt; ++j) {
        const AxisGeo geo = next_geo;
        const float2 gv = next_gv;
        const float2 pv[4] = {next_pv[0], next_pv[1], next_pv[2], next_pv[3]};
        const float2 lv[2] = {next_lv[0], next_lv[1]};
        if (j + 1 < cnt) fetch(j + 1, next_geo, next_gv, next_pv, next_lv);
        if (!__any_sync(0xffffffffu, gv.x != 0.0f || gv.y != 0.0f)) continue;
        float dp0[4], dl0[2], dp1[4], dl1[2];
        channel_grads(pv[0].x, pv[1].x, pv[2].x, pv[3].x, lv[0].x, lv[1].x, gv.x, geo, dp0, dl0);
        channel_grads(pv[0].y, pv[1].y, pv[2].y, pv[3].y, lv[0].y, lv[1].y, gv.y, geo, dp1, dl1);
        if (on) {
          const int64_t p = geo.p00;
          add2(dplane + p * kWalkC + ch, dp0[0], dp1[0]);
          add2(dplane + (p + geo.dx) * kWalkC + ch, dp0[1], dp1[1]);
          add2(dplane + (p + geo.dyw) * kWalkC + ch, dp0[2], dp1[2]);
          add2(dplane + (p + geo.dyw + geo.dx) * kWalkC + ch, dp0[3], dp1[3]);
          line_add(geo.l0, dl0[0], dl1[0]);
          line_add(geo.l0 + geo.dl, dl0[1], dl1[1]);
        }
      }
    }

    // the block's line gradient of this axis into the table, four
    // channels per reduction; untouched entries stay +0 and are skipped;
    // each entry is zeroed for the next axis as it is read
    __syncthreads();
    const bool vec4 = reinterpret_cast<uintptr_t>(dline) % 16 == 0;
    for (int k = threadIdx.x; k < d.l[i] * (kWalkC / 4); k += kWalkThreads) {
      const int row = k / (kWalkC / 4), q = k % (kWalkC / 4);
      float2* lo = reinterpret_cast<float2*>(sline + row * kWalkC + 2 * q);
      float2* hi = reinterpret_cast<float2*>(sline + row * kWalkC + 32 + 2 * q);
      const float2 a = *lo, b = *hi;  // channels (4q, 4q + 2), (4q + 1, 4q + 3)
      *lo = make_float2(0.0f, 0.0f);
      *hi = make_float2(0.0f, 0.0f);
      if (a.x == 0.0f && a.y == 0.0f && b.x == 0.0f && b.y == 0.0f) continue;
      float* dst = dline + static_cast<int64_t>(row) * kWalkC + 4 * q;
      if (vec4) {
        add4(dst, make_float4(a.x, b.x, a.y, b.y));
      } else {
        add2(dst, a.x, b.x);
        add2(dst + 2, a.y, b.y);
      }
    }
    __syncthreads();
  }
}

// Generic route: one warp per sample, lanes stride the channels.
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

// The shared route's grid on the current device for smem bytes of line
// gradient: the SMs, and the blocks that fit on one (0: the line does not
// fit in shared memory).  The device attributes and the kernel's shared
// memory limit are set up once per device and mode, the occupancy once per
// size, so a launch after the first only looks them up.
template <bool SIGMA, bool APP>
cudaError_t walk_grid(size_t smem, int* sms, int* per_sm) {
  struct Device {
    int sms = 0, smem_max = 0;
    std::map<size_t, int> per_sm;
  };
  static std::mutex mu;
  static std::map<int, Device> devices;
  const auto kernel = factor_features_bwd_walk_kernel<SIGMA, APP>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  auto it = devices.find(dev);
  if (it == devices.end()) {
    Device info;
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&info.smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 info.smem_max);
    }
    if (err != cudaSuccess) return err;
    it = devices.emplace(dev, info).first;
  }
  Device& info = it->second;
  *sms = info.sms;
  *per_sm = 0;
  if (smem > static_cast<size_t>(info.smem_max)) return cudaSuccess;
  auto fit = info.per_sm.find(smem);
  if (fit == info.per_sm.end()) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kWalkThreads, smem);
    if (err != cudaSuccess) return err;
    fit = info.per_sm.emplace(smem, blocks).first;
  }
  *per_sm = fit->second;
  return cudaSuccess;
}

template <bool SIGMA, bool APP>
cudaError_t launch(const float* xn, int n, bool walk, const Tables& tab, const Dims& d,
                   int app_stride, const float* d_sigma, const float* d_app,
                   const GradTables& out, cudaStream_t stream, int* info) {
  int sms = 0, per_sm = 0;
  const size_t smem = sizeof(float) * kWalkC * std::max(d.l[0], std::max(d.l[1], d.l[2]));
  if (walk) {
    const cudaError_t err = walk_grid<SIGMA, APP>(smem, &sms, &per_sm);
    if (err != cudaSuccess) return err;
  }
  if (per_sm < 1) {
    constexpr int kThreads = 256;  // 8 warps, one sample each
    const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(n) * 32 + kThreads - 1) /
                                                  kThreads);
    factor_features_bwd_kernel<SIGMA, APP><<<blocks, kThreads, 0, stream>>>(
        xn, n, tab, d, app_stride, d_sigma, d_app, out);
    info[0] = kRouteGeneric;
    info[1] = static_cast<int>(blocks);
    info[2] = kThreads;
    return cudaGetLastError();
  }
  const int64_t runs = (static_cast<int64_t>(n) + kWalkRun - 1) / kWalkRun;
  const int64_t wanted = (runs + kWalkWarps - 1) / kWalkWarps;
  const int blocks = static_cast<int>(std::min<int64_t>(static_cast<int64_t>(sms) * per_sm,
                                                        wanted));
  factor_features_bwd_walk_kernel<SIGMA, APP><<<blocks, kWalkThreads, smem, stream>>>(
      xn, n, tab, d, app_stride, d_sigma, d_app, out);
  info[0] = kRouteShared;
  info[1] = blocks;
  info[2] = kWalkThreads;
  return cudaGetLastError();
}

bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

}  // namespace

// dims: 18 ints, h[3] w[3] l[3] c[3] nd[3] app_off[3] (kernel A's layout).
// d_sigma and/or d_app may be null; at least one is not.  zero != 0 zeroes
// the six gradient tables first (on the same stream); zero == 0 adds into
// them.  The shared route runs when every axis has 64 channels, an even
// density count and a plane of fewer than 2^30 rows, the tables, gradient
// tables and d_app are 8-byte aligned with an even app_stride, and the
// longest line's gradient (L x 64 fp32) fits in a block's shared memory;
// otherwise the generic route.  info (3 ints) receives the route (1
// shared, 2 generic), the grid's blocks and the threads per block.  Returns the
// first CUDA error of the memsets and the launch.
extern "C" int t2n_factor_features_bwd(const float* xn, int n,
                                       const float* plane0, const float* plane1,
                                       const float* plane2, const float* line0,
                                       const float* line1, const float* line2, const int* dims,
                                       int app_stride, const float* d_sigma, const float* d_app,
                                       float* dplane0, float* dplane1, float* dplane2,
                                       float* dline0, float* dline1, float* dline2, int zero,
                                       int* info, void* stream) {
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
    return static_cast<int>(
        launch<true, true>(xn, n, walk, tab, d, app_stride, d_sigma, d_app, out, st, info));
  }
  if (sig) {
    return static_cast<int>(
        launch<true, false>(xn, n, walk, tab, d, app_stride, d_sigma, d_app, out, st, info));
  }
  return static_cast<int>(
      launch<false, true>(xn, n, walk, tab, d, app_stride, d_sigma, d_app, out, st, info));
}
