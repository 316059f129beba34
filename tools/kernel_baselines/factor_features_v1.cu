// The first design of kernel A in bf16 (text2nerf_tpu_torch/csrc/
// factor_features.cu before the bf16 redesign: fp32 tables, fp32 app_raw,
// every value rounded to bf16 through fp32), kept whole with its fp32
// mode as the yardstick that tools/kernel_variants.py times the current
// design against.  It builds in place of csrc/factor_features.cu, with
// factor_features_bwd_v1.cu and the wrapper factor_features_v1.py, which speak
// its C interface (the command is in tools/kernel_variants.py's
// docstring).  Nothing of the package loads it.
//
// Kernel A: TensoRF vm_split factor features, forward only.
//
// Replaces the XLA-lowered gather of text2nerf_tpu/models/tensorf.py
// compute_fused_features_packed (:538), compute_density_feature_packed
// (:335) and compute_app_feature_packed (:575), with the sampling of
// text2nerf_tpu/ops/fused_gather.py sample_packed_plane / _line (:47-83).
//
// Per sample n and axis i: bilinear plane_i(x[m0], x[m1]) times linear
// line_i(x[v]) over the fused (density || app) channels of that axis.
// sigma_feat[n] = sum of the density products over the three axes;
// app_raw[n, :] = the app products of axes 0, 1, 2 concatenated (the
// basis product runs outside, as a plain matrix product).
//
// What bounds it on an H100: bytes.  A sample reads 12 B and writes 580 B
// (1 + 144 fp32 at full width) and touches 4 plane rows and 2 line rows
// per axis (64 fp32 channels each, 4.6 KB in all), ~14 flops per channel
// and axis.  The unique rows of a chunk's samples are few (~8.6 MB per 1M
// samples of the main path) and sit in the 50 MB L2, so the output
// dominates the bound.  What limits the kernels is instruction issue and
// latency, not bytes: rows shared by neighbouring samples hit L1, and the
// per-sample work (geometry, the density reduction, the lerps) costs more
// issue slots than the loads.  The walk kernel's design cuts that work.
//
// Design.  Walk kernel (every axis 64 channels, even density counts, the
// main path's tables): one warp walks a run of 32 consecutive samples
// (the renderer's compacted samples lie ray by ray, one voxel apart),
// axis by axis.  Lane j computes the geometry of the run's sample j once;
// the warp reads each sample's from its lane with shuffles.  Each lane
// holds 2 channels as one float2, so a row is one 256 B load, and the next
// sample's 6 rows are loaded before the current sample's arithmetic.
// Every sample loads its own rows: rows that neighbouring samples share
// hit L1, and keeping them in registers across samples measured no
// faster.  Any sample order gives the same bits.  The density sums go through
// shared memory: each sample's fp64 partial per density lane is stored,
// and at the end of the axis lane j sums sample j's.  Generic kernel
// (other widths): one warp per sample, lanes stride the channels, the
// density sum a warp shuffle reduction.  Outputs are written once,
// coalesced.  Index math is fp32 in both compute types; BF16 rounds the
// gathered values, the lerp weights and every product to bfloat16, as
// the JAX bf16 path does (fused_gather.py:61-63).
//
// Same arithmetic as the plain version (ops/fused_gather.py and
// factor_features_plain), so the two agree bit for bit: every multiply and
// add is a separately rounded __fmul_rn / __fadd_rn (no FMA contraction,
// as torch's op-by-op evaluation), and each axis' density sum is
// accumulated in fp64 (exact for fp32 terms within 2^29 of each other in
// magnitude, so free of the summation order), then rounded to fp32 and to
// the compute type.

#include "factor_common.cuh"

namespace {

template <bool BF16, bool SIGMA, bool APP>
__global__ void factor_features_kernel(const float* __restrict__ xn, int n,
                                       Tables tab, Dims d, int app_stride,
                                       float* __restrict__ sigma_out,
                                       float* __restrict__ app_out) {
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= n) return;
  const float x[3] = {xn[3 * s], xn[3 * s + 1], xn[3 * s + 2]};
  float sigma = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int w = d.w[i], c = d.c[i], nd = d.nd[i];
    int x0, y0, l0;
    float tx, ty, tl;
    coords(x[mat0(i)], w, x0, tx);       // plane x indexes W
    coords(x[mat1(i)], d.h[i], y0, ty);  // plane y indexes H
    coords(x[vec(i)], d.l[i], l0, tl);
    tx = rnd<BF16>(tx);
    ty = rnd<BF16>(ty);
    tl = rnd<BF16>(tl);
    const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, d.h[i] - 1);
    const int l1 = min(l0 + 1, d.l[i] - 1);
    const float* p00 = tab.plane[i] + (static_cast<int64_t>(y0) * w + x0) * c;
    const float* p01 = tab.plane[i] + (static_cast<int64_t>(y0) * w + x1) * c;
    const float* p10 = tab.plane[i] + (static_cast<int64_t>(y1) * w + x0) * c;
    const float* p11 = tab.plane[i] + (static_cast<int64_t>(y1) * w + x1) * c;
    const float* q0 = tab.line[i] + static_cast<int64_t>(l0) * c;
    const float* q1 = tab.line[i] + static_cast<int64_t>(l1) * c;
    const int c_lo = SIGMA ? 0 : nd;
    const int c_hi = APP ? c : nd;
    double part = 0.0;
    for (int ch = c_lo + lane; ch < c_hi; ch += 32) {
      const float top = lerp<BF16>(rnd<BF16>(__ldg(p00 + ch)), rnd<BF16>(__ldg(p01 + ch)), tx);
      const float bot = lerp<BF16>(rnd<BF16>(__ldg(p10 + ch)), rnd<BF16>(__ldg(p11 + ch)), tx);
      const float pf = lerp<BF16>(top, bot, ty);
      const float lf = lerp<BF16>(rnd<BF16>(__ldg(q0 + ch)), rnd<BF16>(__ldg(q1 + ch)), tl);
      const float prod = rnd<BF16>(__fmul_rn(pf, lf));
      if (ch < nd) {
        part += prod;
      } else if (APP) {
        app_out[s * app_stride + d.app_off[i] + (ch - nd)] = prod;
      }
    }
    if (SIGMA) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      sigma = rnd<BF16>(__fadd_rn(sigma, rnd<BF16>(static_cast<float>(part))));
    }
  }
  if (SIGMA && lane == 0) sigma_out[s] = sigma;
}

// ---- walk kernel: 64 channels per axis, one warp per run of samples ------

constexpr int kWalkBlocks = 4;  // resident 256-thread blocks per SM it is built for

template <bool BF16>
__device__ __forceinline__ float product(float p00, float p01, float p10, float p11, float q0,
                                         float q1, const AxisGeo& g) {
  const float top = lerp<BF16>(rnd<BF16>(p00), rnd<BF16>(p01), g.tx);
  const float bot = lerp<BF16>(rnd<BF16>(p10), rnd<BF16>(p11), g.tx);
  const float pf = lerp<BF16>(top, bot, g.ty);
  const float lf = lerp<BF16>(rnd<BF16>(q0), rnd<BF16>(q1), g.tl);
  return rnd<BF16>(__fmul_rn(pf, lf));
}

// One warp walks a run of up to 32 consecutive samples, axis by axis:
// lane j computes the geometry of the run's sample j once and the warp
// reads each sample's from its lane with shuffles.  Each sample's density
// partials (one fp64 per density lane) go to shared memory; at the end of
// the axis lane j sums sample j's and adds them to its density sum, which
// it writes at the end.
template <bool BF16, bool SIGMA, bool APP>
__global__ void __launch_bounds__(256, kWalkBlocks)
factor_features_walk_kernel(const float* __restrict__ xn, int n, Tables tab, Dims d,
                            int app_stride, float* __restrict__ sigma_out,
                            float* __restrict__ app_out) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t base = warp * kWalkRun;
  if (base >= n) return;
  const int cnt = static_cast<int>(base + kWalkRun <= n ? kWalkRun : n - base);
  const int ch = 2 * lane;  // this lane's channels: ch, ch + 1 of every axis
  extern __shared__ double partials[];  // [warp in block][sample][density lane]
  double* part_w = partials + (threadIdx.x >> 5) * kWalkRun * d.dens_lanes;

  float x[3] = {0.0f, 0.0f, 0.0f};
  if (lane < cnt) {
    x[0] = xn[3 * (base + lane)];
    x[1] = xn[3 * (base + lane) + 1];
    x[2] = xn[3 * (base + lane) + 2];
  }
  float sigma = 0.0f;  // sample base + lane's
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int w = d.w[i], nd = d.nd[i];
    const bool dens = ch < nd;  // nd is even: both channels are density or both app
    const bool on = dens ? SIGMA : APP;
    PackedGeo mine;
    {
      AxisGeo g;
      geometry<BF16>(x, i, d, g);
      mine = pack(g);
    }
    AxisGeo cur = shuffle_geo(mine, 0, w);
    float2 pv[4], lv[2];
    load_rows(tab.plane[i], tab.line[i], cur, ch, on, pv, lv);
    for (int j = 0; j < cnt; ++j) {
      // the next sample's rows, loaded now and used after this sample's
      // arithmetic
      AxisGeo nx = cur;
      float2 npv[4] = {pv[0], pv[1], pv[2], pv[3]};
      float2 nlv[2] = {lv[0], lv[1]};
      if (j + 1 < cnt) {
        nx = shuffle_geo(mine, j + 1, w);
        load_rows(tab.plane[i], tab.line[i], nx, ch, on, npv, nlv);
      }
      const float prod0 =
          product<BF16>(pv[0].x, pv[1].x, pv[2].x, pv[3].x, lv[0].x, lv[1].x, cur);
      const float prod1 =
          product<BF16>(pv[0].y, pv[1].y, pv[2].y, pv[3].y, lv[0].y, lv[1].y, cur);
      if (SIGMA && dens) {
        part_w[j * d.dens_lanes + lane] = static_cast<double>(prod0) + static_cast<double>(prod1);
      }
      if (APP && !dens) {
        *reinterpret_cast<float2*>(app_out + (base + j) * app_stride + d.app_off[i] +
                                   (ch - nd)) = make_float2(prod0, prod1);
      }
      cur = nx;
#pragma unroll
      for (int k = 0; k < 4; ++k) pv[k] = npv[k];
      lv[0] = nlv[0];
      lv[1] = nlv[1];
    }
    if (SIGMA) {
      // sample `lane`'s exact fp64 sum over the density lanes, rounded once
      __syncwarp();
      if (lane < cnt) {
        double sum = 0.0;
        for (int k = 0; k < nd / 2; ++k) sum += part_w[lane * d.dens_lanes + k];
        sigma = rnd<BF16>(__fadd_rn(sigma, rnd<BF16>(static_cast<float>(sum))));
      }
      __syncwarp();
    }
  }
  if (SIGMA && lane < cnt) sigma_out[base + lane] = sigma;
}

template <bool BF16, bool SIGMA, bool APP>
void launch(const float* xn, int n, bool walk, const Tables& tab, const Dims& d, int app_stride,
            float* sigma_out, float* app_out, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 warps
  const int64_t warps = walk ? (static_cast<int64_t>(n) + kWalkRun - 1) / kWalkRun : n;
  const unsigned blocks = static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  if (walk) {
    const size_t smem = SIGMA ? sizeof(double) * (kThreads / 32) * kWalkRun * d.dens_lanes : 0;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(factor_features_walk_kernel<BF16, SIGMA, APP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    }
    factor_features_walk_kernel<BF16, SIGMA, APP><<<blocks, kThreads, smem, stream>>>(
        xn, n, tab, d, app_stride, sigma_out, app_out);
  } else {
    factor_features_kernel<BF16, SIGMA, APP><<<blocks, kThreads, 0, stream>>>(
        xn, n, tab, d, app_stride, sigma_out, app_out);
  }
}

}  // namespace

// dims: 18 ints, h[3] w[3] l[3] c[3] nd[3] app_off[3].  sigma_out and/or
// app_out may be null; at least one is not.  The walk kernel runs when
// every axis has 64 channels, an even density count and a plane of fewer
// than 2^30 rows, and the tables are 8-byte aligned (else the generic
// kernel, one sample per warp).  Returns cudaGetLastError().
extern "C" int t2n_factor_features(const float* xn, int n,
                                   const float* plane0, const float* plane1, const float* plane2,
                                   const float* line0, const float* line1, const float* line2,
                                   const int* dims, int app_stride, int bf16,
                                   float* sigma_out, float* app_out, void* stream) {
  Dims d;
  for (int i = 0; i < 3; ++i) {
    d.h[i] = dims[i];
    d.w[i] = dims[3 + i];
    d.l[i] = dims[6 + i];
    d.c[i] = dims[9 + i];
    d.nd[i] = dims[12 + i];
    d.app_off[i] = dims[15 + i];
  }
  d.dens_lanes = 0;
  for (int i = 0; i < 3; ++i) {
    if (d.nd[i] / 2 > d.dens_lanes) d.dens_lanes = d.nd[i] / 2;
  }
  Tables tab;
  tab.plane[0] = plane0;
  tab.plane[1] = plane1;
  tab.plane[2] = plane2;
  tab.line[0] = line0;
  tab.line[1] = line1;
  tab.line[2] = line2;
  bool walk = true;
  for (int i = 0; i < 3; ++i) {
    walk = walk && d.c[i] == kWalkC && d.nd[i] % 2 == 0 &&
           static_cast<int64_t>(d.h[i]) * d.w[i] < (1 << 30) &&
           reinterpret_cast<uintptr_t>(tab.plane[i]) % 8 == 0 &&
           reinterpret_cast<uintptr_t>(tab.line[i]) % 8 == 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sig = sigma_out != nullptr, app = app_out != nullptr;
  const auto go = [&](auto kernel_launch) {
    kernel_launch(xn, n, walk, tab, d, app_stride, sigma_out, app_out, st);
  };
  if (bf16) {
    if (sig && app) go(launch<true, true, true>);
    else if (sig) go(launch<true, true, false>);
    else go(launch<true, false, true>);
  } else {
    if (sig && app) go(launch<false, true, true>);
    else if (sig) go(launch<false, true, false>);
    else go(launch<false, false, true>);
  }
  return static_cast<int>(cudaGetLastError());
}
