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
// in fp32 (1 + 144 fp32 at full width; 292 B in bf16, whose app channels
// are bf16) and touches 4 plane rows and 2 line rows per axis (64
// channels each, 4.6 KB in all in fp32, 2.3 KB in bf16), ~14 flops per
// channel and axis.  The unique rows of a chunk's samples are few (~8.6 MB per 1M
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
// coalesced.
//
// bf16 mode (the JAX bf16 path, fused_gather.py:61-63: values gathered
// from packed.astype(bf16), lerp weights and every product rounded to
// bfloat16, index math in fp32).  The tables are read from their bf16
// copy (made once per parameter version by the wrapper), app_raw is
// written as bf16 (each of its values is bf16 already; sigma_feat stays
// fp32), and the walk kernel computes in packed bf16x2: a lane holds its
// two channels of a row as one 32-bit word (a row is one 128 B load),
// the lerp weights come from the geometry lane as (1 - t, t) word pairs,
// and every lerp and product is a mul.rn / add.rn.bf16x2, the bits of the
// plain version's op-by-op bf16 (factor_common.cuh).  The generic kernel
// reads the bf16 tables and computes through fp32 with rnd<true>.
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

// Generic kernel: one warp per sample, lanes stride the channels.  T is
// the tables' and app_raw's element type: float (fp32 mode) or
// __nv_bfloat16 (bf16 mode, every op rounded to bf16).
template <typename T, bool SIGMA, bool APP>
__global__ void factor_features_kernel(const float* __restrict__ xn, int n,
                                       TablesOf<T> tab, Dims d, int app_stride,
                                       float* __restrict__ sigma_out,
                                       T* __restrict__ app_out) {
  constexpr bool BF16 = !std::is_same<T, float>::value;
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
    const T* p00 = tab.plane[i] + (static_cast<int64_t>(y0) * w + x0) * c;
    const T* p01 = tab.plane[i] + (static_cast<int64_t>(y0) * w + x1) * c;
    const T* p10 = tab.plane[i] + (static_cast<int64_t>(y1) * w + x0) * c;
    const T* p11 = tab.plane[i] + (static_cast<int64_t>(y1) * w + x1) * c;
    const T* q0 = tab.line[i] + static_cast<int64_t>(l0) * c;
    const T* q1 = tab.line[i] + static_cast<int64_t>(l1) * c;
    const int c_lo = SIGMA ? 0 : nd;
    const int c_hi = APP ? c : nd;
    double part = 0.0;
    for (int ch = c_lo + lane; ch < c_hi; ch += 32) {
      const float top = lerp<BF16>(ld(p00 + ch), ld(p01 + ch), tx);
      const float bot = lerp<BF16>(ld(p10 + ch), ld(p11 + ch), tx);
      const float pf = lerp<BF16>(top, bot, ty);
      const float lf = lerp<BF16>(ld(q0 + ch), ld(q1 + ch), tl);
      const float prod = rnd<BF16>(__fmul_rn(pf, lf));
      if (ch < nd) {
        part += prod;
      } else if (APP) {
        app_out[s * app_stride + d.app_off[i] + (ch - nd)] = static_cast<T>(prod);
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

// ---- walk kernels: 64 channels per axis, one warp per run of samples -----

constexpr int kWalkBlocks = 4;  // resident 256-thread blocks per SM they are built for

__device__ __forceinline__ float product(float p00, float p01, float p10, float p11, float q0,
                                         float q1, const AxisGeo& g) {
  const float top = lerp<false>(p00, p01, g.tx);
  const float bot = lerp<false>(p10, p11, g.tx);
  const float pf = lerp<false>(top, bot, g.ty);
  const float lf = lerp<false>(q0, q1, g.tl);
  return __fmul_rn(pf, lf);
}

// One warp walks a run of up to 32 consecutive samples, axis by axis:
// lane j computes the geometry of the run's sample j once and the warp
// reads each sample's from its lane with shuffles.  Each sample's density
// partials (one fp64 per density lane) go to shared memory; at the end of
// the axis lane j sums sample j's and adds them to its density sum, which
// it writes at the end.  fp32 mode.
template <bool SIGMA, bool APP>
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
      geometry<false>(x, i, d, g);
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
      const float prod0 = product(pv[0].x, pv[1].x, pv[2].x, pv[3].x, lv[0].x, lv[1].x, cur);
      const float prod1 = product(pv[0].y, pv[1].y, pv[2].y, pv[3].y, lv[0].y, lv[1].y, cur);
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
        sigma = __fadd_rn(sigma, static_cast<float>(sum));
      }
      __syncwarp();
    }
  }
  if (SIGMA && lane < cnt) sigma_out[base + lane] = sigma;
}

// The walk in bf16: the fp32 walk's structure, on the tables' bf16 copy,
// in packed bf16x2 arithmetic; app_raw written as bf16.
template <bool SIGMA, bool APP>
__global__ void __launch_bounds__(256, kWalkBlocks)
factor_features_walk_bf16_kernel(const float* __restrict__ xn, int n, TablesBf16 tab, Dims d,
                                 int app_stride, float* __restrict__ sigma_out,
                                 __nv_bfloat16* __restrict__ app_out) {
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
    const PackedGeo16 mine = geometry16(x, i, d);
    AxisGeo16 cur = shuffle_geo16(mine, 0, w);
    uint32_t pv[4], lv[2];
    load_rows16(tab.plane[i], tab.line[i], cur, lane, on, pv, lv);
    for (int j = 0; j < cnt; ++j) {
      AxisGeo16 nx = cur;
      uint32_t npv[4] = {pv[0], pv[1], pv[2], pv[3]};
      uint32_t nlv[2] = {lv[0], lv[1]};
      if (j + 1 < cnt) {
        nx = shuffle_geo16(mine, j + 1, w);
        load_rows16(tab.plane[i], tab.line[i], nx, lane, on, npv, nlv);
      }
      uint32_t pf, lf;
      values16(pv, lv, cur, pf, lf);
      const uint32_t prod = bmul2(pf, lf);
      if (SIGMA && dens) {
        part_w[j * d.dens_lanes + lane] =
            static_cast<double>(bf_lo(prod)) + static_cast<double>(bf_hi(prod));
      }
      if (APP && !dens) {
        *reinterpret_cast<uint32_t*>(app_out + (base + j) * app_stride + d.app_off[i] +
                                     (ch - nd)) = prod;
      }
      cur = nx;
#pragma unroll
      for (int k = 0; k < 4; ++k) pv[k] = npv[k];
      lv[0] = nlv[0];
      lv[1] = nlv[1];
    }
    if (SIGMA) {
      __syncwarp();
      if (lane < cnt) {
        double sum = 0.0;
        for (int k = 0; k < nd / 2; ++k) sum += part_w[lane * d.dens_lanes + k];
        sigma = rnd<true>(__fadd_rn(sigma, rnd<true>(static_cast<float>(sum))));
      }
      __syncwarp();
    }
  }
  if (SIGMA && lane < cnt) sigma_out[base + lane] = sigma;
}

template <typename T, bool SIGMA, bool APP>
void launch(const float* xn, int n, bool walk, const TablesOf<T>& tab, const Dims& d,
            int app_stride, float* sigma_out, T* app_out, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 warps
  const int64_t warps = walk ? (static_cast<int64_t>(n) + kWalkRun - 1) / kWalkRun : n;
  const unsigned blocks = static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  if (!walk) {
    factor_features_kernel<T, SIGMA, APP><<<blocks, kThreads, 0, stream>>>(
        xn, n, tab, d, app_stride, sigma_out, app_out);
    return;
  }
  const size_t smem = SIGMA ? sizeof(double) * (kThreads / 32) * kWalkRun * d.dens_lanes : 0;
  const auto kernel = [] {
    if constexpr (std::is_same<T, float>::value) {
      return factor_features_walk_kernel<SIGMA, APP>;
    } else {
      return factor_features_walk_bf16_kernel<SIGMA, APP>;
    }
  }();
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<blocks, kThreads, smem, stream>>>(xn, n, tab, d, app_stride, sigma_out, app_out);
}

template <typename T>
int dispatch(const float* xn, int n, const T* const (&planes)[3], const T* const (&lines)[3],
             const int* dims, int app_stride, float* sigma_out, T* app_out, void* stream) {
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
  TablesOf<T> tab;
  for (int i = 0; i < 3; ++i) {
    tab.plane[i] = planes[i];
    tab.line[i] = lines[i];
  }
  // a lane's two channels are one 8-byte (fp32) or 4-byte (bf16) word
  constexpr uintptr_t kAlign = 2 * sizeof(T);
  bool walk = app_out == nullptr || (reinterpret_cast<uintptr_t>(app_out) % kAlign == 0 &&
                                     app_stride % 2 == 0);
  for (int i = 0; i < 3; ++i) {
    walk = walk && d.c[i] == kWalkC && d.nd[i] % 2 == 0 &&
           static_cast<int64_t>(d.h[i]) * d.w[i] < (1 << 30) &&
           reinterpret_cast<uintptr_t>(tab.plane[i]) % kAlign == 0 &&
           reinterpret_cast<uintptr_t>(tab.line[i]) % kAlign == 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sig = sigma_out != nullptr, app = app_out != nullptr;
  if (sig && app) {
    launch<T, true, true>(xn, n, walk, tab, d, app_stride, sigma_out, app_out, st);
  } else if (sig) {
    launch<T, true, false>(xn, n, walk, tab, d, app_stride, sigma_out, app_out, st);
  } else {
    launch<T, false, true>(xn, n, walk, tab, d, app_stride, sigma_out, app_out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims: 18 ints, h[3] w[3] l[3] c[3] nd[3] app_off[3].  sigma_out and/or
// app_out may be null; at least one is not.  The walk kernel runs when
// every axis has 64 channels, an even density count and a plane of fewer
// than 2^30 rows, and the tables and app_out are aligned to a lane's two
// channels with an even app_stride (else the generic kernel, one sample
// per warp).  Returns cudaGetLastError().  fp32 mode: fp32 tables and
// outputs.
extern "C" int t2n_factor_features(const float* xn, int n,
                                   const float* plane0, const float* plane1, const float* plane2,
                                   const float* line0, const float* line1, const float* line2,
                                   const int* dims, int app_stride,
                                   float* sigma_out, float* app_out, void* stream) {
  const float* const planes[3] = {plane0, plane1, plane2};
  const float* const lines[3] = {line0, line1, line2};
  return dispatch(xn, n, planes, lines, dims, app_stride, sigma_out, app_out, stream);
}

// bf16 mode: the same with the tables' bf16 copies and a bf16 app_out
// (sigma_out stays fp32).
extern "C" int t2n_factor_features_bf16(const float* xn, int n, const __nv_bfloat16* plane0,
                                        const __nv_bfloat16* plane1,
                                        const __nv_bfloat16* plane2,
                                        const __nv_bfloat16* line0, const __nv_bfloat16* line1,
                                        const __nv_bfloat16* line2, const int* dims,
                                        int app_stride, float* sigma_out,
                                        __nv_bfloat16* app_out, void* stream) {
  const __nv_bfloat16* const planes[3] = {plane0, plane1, plane2};
  const __nv_bfloat16* const lines[3] = {line0, line1, line2};
  return dispatch(xn, n, planes, lines, dims, app_stride, sigma_out, app_out, stream);
}
