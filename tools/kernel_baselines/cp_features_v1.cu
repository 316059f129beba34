// The first design of kernels C and C' (text2nerf_tpu_torch/csrc/
// cp_features.cu before its walk redesign), kept as the yardstick that
// tools/kernel_variants.py times the current design against (chip_smoke.py
// phase 3: "v1:csrc/cp_features.cu=tools/kernel_baselines/cp_features_v1.cu").
// It builds in place of csrc/cp_features.cu, with the same C interface.
// Nothing of the package loads it.
//
// Kernel C and kernel C': TensoRF CP factor features and their scatter-add
// backward.
//
// Kernel C replaces the XLA-lowered gather of text2nerf_tpu/models/
// tensorf.py compute_fused_features_packed's cp branch (:548-557) and its
// density-only (:344-350) and app-only (:580-586) forms, with the line
// sampling of text2nerf_tpu/ops/fused_gather.py sample_packed_line
// (:76-83).  Kernel C' replaces XLA's autodiff of them, the scatter-add
// into the lines.
//
// Inputs: the fused (density || app) lines of the three axes, [L_i, C]
// with C = nd + na on every axis (line i spans world axis VEC_MODE[i]).
// Per sample n and channel c: v_i = the linear sample of line i at
// x[VEC_MODE[i]], prod = (v_0 * v_1) * v_2; sigma_feat[n] = sum of prod
// over the density channels, app_raw[n, :] = prod over the app channels
// (the basis product runs outside, as a plain matrix product).
//
// Backward, per sample, channel and axis, in the order of reverse-mode
// autodiff of the product: d01 = g*v_2, dv_2 = g*(v_0*v_1), dv_0 = d01*v_1,
// dv_1 = d01*v_0, then dv_i*(1-t_i) and dv_i*t_i into the two rows of
// line i (an edge-clamped upper row lands both in one row).  g is d_sigma
// on the density channels and d_app_raw on the app channels.
//
// What bounds them on an H100.  The lines are tiny (at CP 96/288 and a
// 500-entry axis, 768 KB each) and live in L2, so the forward's bound is
// its output: (1 + na) fp32 per sample written, 12 B read (1.16 GB per 1M
// samples at na 288, 0.35 ms at 3.35 TB/s).  The backward reads the same
// gradients and writes three small tables; what limits it is the
// contention of its additions: a million samples land on a few hundred
// rows per axis.
//
// Design.  Kernel C: one warp per sample, lanes stride the channels, so
// every row load and the app store are coalesced; the density sum is a
// per-lane fp64 partial reduced by warp shuffles (exact for fp32 terms
// within 2^29 of each other in magnitude, so free of the order), rounded
// once.  Kernel C', shared route: the grid is (channel slices of 32) x
// (sample ranges); a block adds its slice of all three lines' gradients
// into shared memory ([sum L_i][32] fp32, one channel per lane, so a
// warp's shared atomics hit 32 banks) and reduces them into the tables
// once, skipping untouched entries; a sample whose gradient is zero on a
// lane's channel adds nothing.  At 300^3 the slice takes 115 KB, so an SM
// holds one block: it has 32 warps, each walking its samples with about
// ten dependent loads apiece, and the warps hide each other's latency
// (8-warp blocks took 1.8x as long, PERF.md).  Generic route (the three
// lines too long for one block's shared memory): one warp per sample,
// global atomics.
// Index math is fp32; BF16 rounds the gathered values, the lerp weights,
// g and every product to bfloat16 where JAX's bf16 gather and its
// autodiff round them; the backward accumulates in fp32 (JAX's XLA
// scatter-adds in bf16).  Every multiply and add is a separately rounded
// __fmul_rn / __fadd_rn, as the plain version's op-by-op evaluation.

#include <algorithm>
#include <map>
#include <mutex>

#include "factor_common.cuh"

namespace {

struct CPDims {
  int l[3];
  int c, nd;
};

struct CPLines {
  const float* line[3];
};

struct CPGrads {
  float* line[3];
};

constexpr int kSlice = 32;          // channels a backward block owns (one per lane)
constexpr int kBwdThreads = 1024;   // shared route: 32 warps, one block an SM
constexpr int kGenericThreads = 256;  // generic route: 8 warps, one sample each
constexpr int kRouteShared = 1;     // shared-memory accumulation
constexpr int kRouteGeneric = 2;    // global atomics

struct LineGeo {
  int l0[3], l1[3];
  float t[3];
};

template <bool BF16>
__device__ __forceinline__ void line_geometry(const float* xn, int64_t s, const CPDims& d,
                                              LineGeo& g) {
  const float x[3] = {xn[3 * s], xn[3 * s + 1], xn[3 * s + 2]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    coords(x[vec(i)], d.l[i], g.l0[i], g.t[i]);
    g.t[i] = rnd<BF16>(g.t[i]);
    g.l1[i] = min(g.l0[i] + 1, d.l[i] - 1);
  }
}

// the three axes' line samples of channel ch
template <bool BF16>
__device__ __forceinline__ void line_values(const CPLines& tab, const CPDims& d,
                                            const LineGeo& g, int ch, float (&v)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* row = tab.line[i];
    v[i] = lerp<BF16>(rnd<BF16>(__ldg(row + static_cast<int64_t>(g.l0[i]) * d.c + ch)),
                      rnd<BF16>(__ldg(row + static_cast<int64_t>(g.l1[i]) * d.c + ch)), g.t[i]);
  }
}

template <bool BF16, bool SIGMA, bool APP>
__global__ void cp_features_kernel(const float* __restrict__ xn, int n, CPLines tab, CPDims d,
                                   float* __restrict__ sigma_out, float* __restrict__ app_out) {
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= n) return;
  LineGeo g;
  line_geometry<BF16>(xn, s, d, g);
  const int na = d.c - d.nd;
  const int c_lo = SIGMA ? 0 : d.nd;
  const int c_hi = APP ? d.c : d.nd;
  double part = 0.0;
  for (int ch = c_lo + lane; ch < c_hi; ch += 32) {
    float v[3];
    line_values<BF16>(tab, d, g, ch, v);
    const float prod = rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(v[0], v[1])), v[2]));
    if (ch < d.nd) {
      part += prod;
    } else if (APP) {
      app_out[s * na + (ch - d.nd)] = prod;
    }
  }
  if (SIGMA) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) sigma_out[s] = rnd<BF16>(static_cast<float>(part));
  }
}

// one channel of one sample: the six row gradients (axis i: rows l0, l1)
template <bool BF16>
__device__ __forceinline__ void cp_channel_grads(const float (&v)[3], float g, const LineGeo& geo,
                                                 float (&dl)[3][2]) {
  g = rnd<BF16>(g);
  const float p01 = rnd<BF16>(__fmul_rn(v[0], v[1]));
  const float d01 = rnd<BF16>(__fmul_rn(g, v[2]));
  const float dv[3] = {rnd<BF16>(__fmul_rn(d01, v[1])), rnd<BF16>(__fmul_rn(d01, v[0])),
                       rnd<BF16>(__fmul_rn(g, p01))};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dl[i][0] = rnd<BF16>(__fmul_rn(dv[i], rnd<BF16>(__fsub_rn(1.0f, geo.t[i]))));
    dl[i][1] = rnd<BF16>(__fmul_rn(dv[i], geo.t[i]));
  }
}

template <bool SIGMA, bool APP>
__device__ __forceinline__ float channel_grad(const float* d_sigma, const float* d_app,
                                              int64_t s, int ch, const CPDims& d) {
  if (ch < d.nd) return SIGMA ? d_sigma[s] : 0.0f;
  return APP ? __ldg(d_app + s * (d.c - d.nd) + (ch - d.nd)) : 0.0f;
}

// Shared route.  Block b owns channel slice b % slices and the sample range
// [p*n/P, (p+1)*n/P) with p = b / slices and P = gridDim.x / slices; its
// warps stride the range.  Shared memory: [L_0 + L_1 + L_2][32] fp32.
template <bool BF16, bool SIGMA, bool APP>
__global__ void __launch_bounds__(kBwdThreads)
cp_features_bwd_shared_kernel(const float* __restrict__ xn, int n, CPLines tab, CPDims d,
                              const float* __restrict__ d_sigma,
                              const float* __restrict__ d_app, CPGrads out, int slices) {
  extern __shared__ float sacc[];
  const int rows = d.l[0] + d.l[1] + d.l[2];
  const int off[3] = {0, d.l[0], d.l[0] + d.l[1]};
  const int slice = blockIdx.x % slices;
  const int64_t part = blockIdx.x / slices, parts = gridDim.x / slices;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = slice * kSlice + lane;
  const bool on = ch < d.c && (ch < d.nd ? SIGMA : APP);
  for (int k = threadIdx.x; k < rows * kSlice; k += kBwdThreads) sacc[k] = 0.0f;
  __syncthreads();

  const int64_t lo = part * n / parts, hi = (part + 1) * n / parts;
  if (on) {
    for (int64_t s = lo + warp; s < hi; s += kBwdThreads / 32) {
      const float g = channel_grad<SIGMA, APP>(d_sigma, d_app, s, ch, d);
      if (g == 0.0f) continue;  // adds +0 to every row it touches
      LineGeo geo;
      line_geometry<BF16>(xn, s, d, geo);
      float v[3], dl[3][2];
      line_values<BF16>(tab, d, geo, ch, v);
      cp_channel_grads<BF16>(v, g, geo, dl);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        atomicAdd(sacc + (off[i] + geo.l0[i]) * kSlice + lane, dl[i][0]);
        atomicAdd(sacc + (off[i] + geo.l1[i]) * kSlice + lane, dl[i][1]);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < rows * kSlice; k += kBwdThreads) {
    const float val = sacc[k];
    const int c = slice * kSlice + (k % kSlice);
    if (val == 0.0f || c >= d.c) continue;
    int row = k / kSlice;
    int i = 0;
    if (row >= off[2]) {
      i = 2;
    } else if (row >= off[1]) {
      i = 1;
    }
    row -= off[i];
    atomicAdd(out.line[i] + static_cast<int64_t>(row) * d.c + c, val);
  }
}

// Generic route: one warp per sample, lanes stride the channels.
template <bool BF16, bool SIGMA, bool APP>
__global__ void cp_features_bwd_kernel(const float* __restrict__ xn, int n, CPLines tab,
                                       CPDims d, const float* __restrict__ d_sigma,
                                       const float* __restrict__ d_app, CPGrads out) {
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= n) return;
  LineGeo geo;
  line_geometry<BF16>(xn, s, d, geo);
  const int c_lo = SIGMA ? 0 : d.nd;
  const int c_hi = APP ? d.c : d.nd;
  for (int ch = c_lo + lane; ch < c_hi; ch += 32) {
    const float g = channel_grad<SIGMA, APP>(d_sigma, d_app, s, ch, d);
    if (g == 0.0f) continue;
    float v[3], dl[3][2];
    line_values<BF16>(tab, d, geo, ch, v);
    cp_channel_grads<BF16>(v, g, geo, dl);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      atomicAdd(out.line[i] + static_cast<int64_t>(geo.l0[i]) * d.c + ch, dl[i][0]);
      atomicAdd(out.line[i] + static_cast<int64_t>(geo.l1[i]) * d.c + ch, dl[i][1]);
    }
  }
}

// The shared route's blocks per SM on the current device for smem bytes,
// and its SM count (0 blocks: the lines do not fit).  Set up once per
// device and mode, the occupancy once per size.
template <bool BF16, bool SIGMA, bool APP>
cudaError_t shared_grid(size_t smem, int* sms, int* per_sm) {
  struct Device {
    int sms = 0, smem_max = 0;
    std::map<size_t, int> per_sm;
  };
  static std::mutex mu;
  static std::map<int, Device> devices;
  const auto kernel = cp_features_bwd_shared_kernel<BF16, SIGMA, APP>;
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBwdThreads, smem);
    if (err != cudaSuccess) return err;
    fit = info.per_sm.emplace(smem, blocks).first;
  }
  *per_sm = fit->second;
  return cudaSuccess;
}

template <bool BF16, bool SIGMA, bool APP>
void launch_fwd(const float* xn, int n, const CPLines& tab, const CPDims& d, float* sigma_out,
                float* app_out, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 warps, one sample each
  const unsigned blocks =
      static_cast<unsigned>((static_cast<int64_t>(n) * 32 + kThreads - 1) / kThreads);
  cp_features_kernel<BF16, SIGMA, APP><<<blocks, kThreads, 0, stream>>>(xn, n, tab, d,
                                                                         sigma_out, app_out);
}

template <bool BF16, bool SIGMA, bool APP>
cudaError_t launch_bwd(const float* xn, int n, const CPLines& tab, const CPDims& d,
                       const float* d_sigma, const float* d_app, const CPGrads& out,
                       cudaStream_t stream, int* info) {
  const size_t smem = sizeof(float) * kSlice * (d.l[0] + d.l[1] + d.l[2]);
  int sms = 0, per_sm = 0;
  const cudaError_t err = shared_grid<BF16, SIGMA, APP>(smem, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) {
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<int64_t>(n) * 32 + kGenericThreads - 1) / kGenericThreads);
    cp_features_bwd_kernel<BF16, SIGMA, APP><<<blocks, kGenericThreads, 0, stream>>>(
        xn, n, tab, d, d_sigma, d_app, out);
    info[0] = kRouteGeneric;
    info[1] = static_cast<int>(blocks);
    info[2] = kGenericThreads;
    return cudaGetLastError();
  }
  const int slices = (d.c + kSlice - 1) / kSlice;
  // as many blocks as fit on the card, split over the slices; a range
  // holds at least 256 samples
  const int64_t fit = std::max<int64_t>(1, static_cast<int64_t>(sms) * per_sm / slices);
  const int64_t ranges = (static_cast<int64_t>(n) + 255) / 256;
  const int64_t parts = std::max<int64_t>(1, std::min<int64_t>(fit, ranges));
  const int blocks = static_cast<int>(parts * slices);
  cp_features_bwd_shared_kernel<BF16, SIGMA, APP><<<blocks, kBwdThreads, smem, stream>>>(
      xn, n, tab, d, d_sigma, d_app, out, slices);
  info[0] = kRouteShared;
  info[1] = blocks;
  info[2] = kBwdThreads;
  return cudaGetLastError();
}

CPDims make_dims(const int* dims) {
  CPDims d;
  for (int i = 0; i < 3; ++i) d.l[i] = dims[i];
  d.c = dims[3];
  d.nd = dims[4];
  return d;
}

}  // namespace

// dims: 5 ints, l[3] c nd.  sigma_out and/or app_out (N x (c - nd)) may be
// null; at least one is not.  Returns cudaGetLastError().
extern "C" int t2n_cp_features(const float* xn, int n, const float* line0, const float* line1,
                               const float* line2, const int* dims, int bf16, float* sigma_out,
                               float* app_out, void* stream) {
  const CPDims d = make_dims(dims);
  const CPLines tab = {{line0, line1, line2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sig = sigma_out != nullptr, app = app_out != nullptr;
  const auto go = [&](auto kernel_launch) { kernel_launch(xn, n, tab, d, sigma_out, app_out, st); };
  if (bf16) {
    if (sig && app) go(launch_fwd<true, true, true>);
    else if (sig) go(launch_fwd<true, true, false>);
    else go(launch_fwd<true, false, true>);
  } else {
    if (sig && app) go(launch_fwd<false, true, true>);
    else if (sig) go(launch_fwd<false, true, false>);
    else go(launch_fwd<false, false, true>);
  }
  return static_cast<int>(cudaGetLastError());
}

// dims as t2n_cp_features.  d_sigma and/or d_app may be null; at least one
// is not.  zero != 0 zeroes the three gradient lines first (on the same
// stream); zero == 0 adds into them.  info (3 ints) receives the route (1
// shared, 2 generic), the blocks and the threads per block.  Returns the
// first CUDA error of the memsets and the launch.
extern "C" int t2n_cp_features_bwd(const float* xn, int n, const float* line0,
                                   const float* line1, const float* line2, const int* dims,
                                   const float* d_sigma, const float* d_app, float* dline0,
                                   float* dline1, float* dline2, int zero, int bf16, int* info,
                                   void* stream) {
  const CPDims d = make_dims(dims);
  const CPLines tab = {{line0, line1, line2}};
  const CPGrads out = {{dline0, dline1, dline2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zero) {
    for (int i = 0; i < 3; ++i) {
      const cudaError_t err =
          cudaMemsetAsync(out.line[i], 0, sizeof(float) * d.l[i] * d.c, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const bool sig = d_sigma != nullptr, app = d_app != nullptr;
  const auto go = [&](auto kernel_launch) {
    return static_cast<int>(kernel_launch(xn, n, tab, d, d_sigma, d_app, out, st, info));
  };
  if (bf16) {
    if (sig && app) return go(launch_bwd<true, true, true>);
    if (sig) return go(launch_bwd<true, true, false>);
    return go(launch_bwd<true, false, true>);
  }
  if (sig && app) return go(launch_bwd<false, true, true>);
  if (sig) return go(launch_bwd<false, true, false>);
  return go(launch_bwd<false, false, true>);
}
