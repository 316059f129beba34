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
// What bounds them on an H100.  The lines are small (at CP 96/288 on a
// 300^3 grid, 461 KB an axis) and live in L2, so HBM sees only the
// samples, the outputs and the output gradients: the forward's byte bound
// is its output ((1 + na) fp32 per sample written, 12 B read), the
// backward's the gradients it reads.  Neither kernel gets near it.  Each
// sample reads six rows of the mode's channels through L1 (2.3 KB at 96
// channels), so the forward of ray-ordered samples is held by L1 traffic
// and instruction issue.  The backward adds a million samples into 3 x 300
// rows, and sm_90 has no fp32 add in shared memory: the SASS of
// atomicAdd(float*) there is a compare-and-swap loop (ATOMS.CAST.SPIN),
// a chain of a shared load, an add and the swap.  Past that, C' is held
// by instruction issue (about 110 warp instructions per sample and
// 32-channel slice: the shuffles, the 64-bit row addresses, the copies of
// the loaded-ahead sample) and, where it reads app gradients, by their
// HBM latency.
//
// Design.  Both kernels walk runs of 32 consecutive samples per warp (the
// renderer lays a ray's samples out one after another): lane j computes
// sample j's geometry (the rows and lerp weights of the three axes) once,
// and the warp reads each sample's by shuffle, so every branch on it is
// warp-uniform; the next item's rows are loaded before the current one's
// arithmetic.
//  - Kernel C: one run per warp; each lane holds 4 consecutive channels
//    (one float4 per row, 16-byte loads and stores) where C, nd and the
//    pointers allow, else 1; a sample takes ceil(channels / 128) chunks.
//    The density sum is a per-lane fp64 partial reduced by warp shuffles
//    at the sample's last chunk (exact for fp32 terms within 2^29 of each
//    other in magnitude, so free of the order), rounded once; lane j keeps
//    sample j's and the run's sigmas are stored together.
//  - Kernel C', shared route: a persistent grid of (channel slices of 32)
//    x (sample parts), launched only over the slices the mode touches.  A
//    block keeps its slice of all three lines' gradients in shared memory
//    ([L_0 + L_1 + L_2][32] fp32, one channel per lane, so a warp's adds
//    hit 32 banks), 115 KB at 300^3, so two 16-warp blocks share an SM
//    once the carveout gives shared memory its largest share.  Each warp
//    walks one contiguous span of runs of the block's part, so the warps
//    that run at one moment sit on different rays.  A sample whose
//    gradient is zero on the warp's whole slice is skipped after a warp
//    vote.  Each axis keeps the gradient of its last two rows in registers
//    (a window at row r: rows r and r + 1) and adds them to shared memory
//    only when a sample's rows leave the window, so a ray walking along an
//    axis adds each row once instead of once per sample (six shared
//    adds a sample measured slower in a TensorCP step).  The
//    block adds its slice into the tables once at the end, four channels
//    per reduction, skipping untouched entries.  Measured slower on the
//    H100 and not kept (PERF.md): rows kept in registers across samples,
//    64-channel slices at two channels a lane, 20- and 32-warp blocks.
//  - Generic route (the three lines too long for one block's shared
//    memory): one warp per sample, lanes stride the channels, global
//    atomics.
// Index math is fp32; BF16 rounds the gathered values, the lerp weights,
// g and every product to bfloat16 where JAX's bf16 gather and its
// autodiff round them; the backward accumulates in fp32 (JAX's XLA
// scatter-adds in bf16).  Every multiply and add of a value is a separately
// rounded __fmul_rn / __fadd_rn, as the plain version's op-by-op
// evaluation, so kernel C equals its plain version bit for bit; kernel C'
// adds in another order and is held to a tolerance.

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

constexpr int kFwdThreads = 256;    // kernel C: 8 warps, one run each
constexpr int kSlice = 32;          // channels a C' block owns (one per lane)
constexpr int kBwdThreads = 512;    // shared route: 16 warps a block
constexpr int kBwdMinBlocks = 2;    // ... two blocks an SM (64 registers a thread)
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kGenericThreads = 256;  // generic route: 8 warps, one sample each
constexpr int kRouteShared = 1;     // shared-memory accumulation
constexpr int kRouteGeneric = 2;    // global atomics

// one sample's three axes, packed for shuffles: the lower row
// (l[i] & 0x7FFFFFFF), whether the upper row is the next one (bit 31; 0 at
// the clamped edge), and the lerp weight t[i]
struct CPGeo {
  uint32_t l[3];
  float t[3];
  __device__ __forceinline__ int lo(int i) const { return static_cast<int>(l[i] & 0x7FFFFFFFu); }
  __device__ __forceinline__ int dl(int i) const { return static_cast<int>(l[i] >> 31); }
};

template <bool BF16>
__device__ __forceinline__ CPGeo cp_geometry(const float (&x)[3], const CPDims& d) {
  CPGeo g;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    int l0;
    float t;
    coords(x[vec(i)], d.l[i], l0, t);
    g.t[i] = rnd<BF16>(t);
    g.l[i] = static_cast<uint32_t>(l0) | (l0 + 1 < d.l[i] ? 0x80000000u : 0u);
  }
  return g;
}

// the geometry lane `src` holds
__device__ __forceinline__ CPGeo cp_shuffle(const CPGeo& g, int src) {
  CPGeo out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out.l[i] = __shfl_sync(0xffffffffu, g.l[i], src);
    out.t[i] = __shfl_sync(0xffffffffu, g.t[i], src);
  }
  return out;
}

// the lower rows' lerp weights 1 - t, as lerp of factor_common.cuh rounds them
template <bool BF16>
__device__ __forceinline__ void lower_weights(const CPGeo& g, float (&wa)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) wa[i] = rnd<BF16>(__fsub_rn(1.0f, g.t[i]));
}

// the linear sample of rows a, b at weights wa = 1 - t, t (lerp of
// factor_common.cuh with its 1 - t computed once for all channels)
template <bool BF16>
__device__ __forceinline__ float line_value(float a, float b, float wa, float t) {
  return rnd<BF16>(__fadd_rn(rnd<BF16>(__fmul_rn(rnd<BF16>(a), wa)),
                             rnd<BF16>(__fmul_rn(rnd<BF16>(b), t))));
}

// one channel of one sample: the six row gradients (axis i: rows l0, l0 + dl)
template <bool BF16>
__device__ __forceinline__ void cp_channel_grads(const float (&v)[3], float g, const CPGeo& geo,
                                                 const float (&wa)[3], float (&dl)[3][2]) {
  g = rnd<BF16>(g);
  const float p01 = rnd<BF16>(__fmul_rn(v[0], v[1]));
  const float d01 = rnd<BF16>(__fmul_rn(g, v[2]));
  const float dv[3] = {rnd<BF16>(__fmul_rn(d01, v[1])), rnd<BF16>(__fmul_rn(d01, v[0])),
                       rnd<BF16>(__fmul_rn(g, p01))};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dl[i][0] = rnd<BF16>(__fmul_rn(dv[i], wa[i]));
    dl[i][1] = rnd<BF16>(__fmul_rn(dv[i], geo.t[i]));
  }
}

template <int V>
__device__ __forceinline__ void load_ch(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else {
    out[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_ch(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// ---- kernel C: one warp per run of 32 samples ------------------------------

// Item (j, k) of a run is sample j's channel chunk k: this lane's channels
// c_lo + k*32*V + lane*V + [0, V).  The next item's rows (and, at a new
// sample, its geometry) are loaded before this item's arithmetic.
template <bool BF16, bool SIGMA, bool APP, int V>
__global__ void __launch_bounds__(kFwdThreads, 3)
cp_features_walk_kernel(const float* __restrict__ xn, int n, CPLines tab, CPDims d,
                        float* __restrict__ sigma_out, float* __restrict__ app_out) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kFwdThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t base = warp * kWalkRun;
  if (base >= n) return;
  const int cnt = static_cast<int>(base + kWalkRun <= n ? kWalkRun : n - base);
  const int na = d.c - d.nd;
  const int c_lo = SIGMA ? 0 : d.nd;
  const int c_hi = APP ? d.c : d.nd;
  const int chunks = (c_hi - c_lo + 32 * V - 1) / (32 * V);

  float x[3] = {0.0f, 0.0f, 0.0f};
  if (lane < cnt) {
    x[0] = xn[3 * (base + lane)];
    x[1] = xn[3 * (base + lane) + 1];
    x[2] = xn[3 * (base + lane) + 2];
  }
  const CPGeo mine = cp_geometry<BF16>(x, d);
  float sig = 0.0f;  // sample base + lane's
  const auto fetch = [&](const CPGeo& g, int k, float (&r)[6][V]) {
    const int ch = c_lo + k * 32 * V + lane * V;
    if (ch < c_hi) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float* row = tab.line[i] + static_cast<int64_t>(g.lo(i)) * d.c + ch;
        load_ch<V>(row, r[2 * i]);
        load_ch<V>(row + g.dl(i) * d.c, r[2 * i + 1]);
      }
    }
  };
  if (chunks > 0) {
    double part = 0.0;  // this lane's density channels of the current sample
    int j = 0, k = 0;
    CPGeo cur = cp_shuffle(mine, 0);
    float r[6][V];
    fetch(cur, 0, r);
    for (;;) {
      int nj = j, nk = k + 1;
      if (nk == chunks) {
        nk = 0;
        ++nj;
      }
      CPGeo nxt = cur;
      float nr[6][V];
      if (nj < cnt) {
        if (nk == 0) nxt = cp_shuffle(mine, nj);
        fetch(nxt, nk, nr);
      }
      const int ch = c_lo + k * 32 * V + lane * V;
      if (ch < c_hi) {
        float wa[3], prod[V];
        lower_weights<BF16>(cur, wa);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float val[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            val[i] = line_value<BF16>(r[2 * i][v], r[2 * i + 1][v], wa[i], cur.t[i]);
          }
          prod[v] = rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(val[0], val[1])), val[2]));
        }
        if (SIGMA && ch < d.nd) {
#pragma unroll
          for (int v = 0; v < V; ++v) part += static_cast<double>(prod[v]);
        } else if (APP) {
          store_ch<V>(app_out + (base + j) * na + (ch - d.nd), prod);
        }
      }
      if (SIGMA && nk == 0) {  // sample j's last chunk: its density sum
        double sum = part;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == j) sig = rnd<BF16>(static_cast<float>(sum));
        part = 0.0;
      }
      if (nj >= cnt) break;
      j = nj;
      k = nk;
      cur = nxt;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
#pragma unroll
        for (int v = 0; v < V; ++v) r[q][v] = nr[q][v];
      }
    }
  }
  if (SIGMA && lane < cnt) sigma_out[base + lane] = sig;
}

// ---- kernel C', shared route -------------------------------------------------

__device__ __forceinline__ void add4(float* addr, float4 v) {
#if __CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(reinterpret_cast<float4*>(addr), v);
#else
  atomicAdd(addr, v.x);
  atomicAdd(addr + 1, v.y);
  atomicAdd(addr + 2, v.z);
  atomicAdd(addr + 3, v.w);
#endif
}

// Block b owns channel slice slice_lo + b % slices and part b / slices of
// the samples; warp w of part p walks runs [g*R/G, (g+1)*R/G) of the R runs
// of 32 samples, g = p * kBwdWarps + w, G = parts * kBwdWarps.  Shared
// memory: [L_0 + L_1 + L_2][32] fp32, axis i's rows from off[i].
template <bool BF16, bool SIGMA, bool APP>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
cp_features_bwd_walk_kernel(const float* __restrict__ xn, int n, CPLines tab, CPDims d,
                            const float* __restrict__ d_sigma,
                            const float* __restrict__ d_app, CPGrads out, int slice_lo,
                            int slices, int vec4) {
  extern __shared__ float4 sacc4[];
  float* sacc = reinterpret_cast<float*>(sacc4);
  const int rows = d.l[0] + d.l[1] + d.l[2];
  const int lane = threadIdx.x & 31;
  const int slice = slice_lo + static_cast<int>(blockIdx.x % slices);
  const int64_t part = blockIdx.x / slices, parts = gridDim.x / slices;
  const int ch = slice * kSlice + lane;
  const int c_lo = SIGMA ? 0 : d.nd;
  const int c_hi = APP ? d.c : d.nd;
  const bool on = ch >= c_lo && ch < c_hi;
  const bool dens = ch < d.nd;
  const int na = d.c - d.nd;
  const int off[3] = {0, d.l[0], d.l[0] + d.l[1]};  // axis i's first row
  for (int k = threadIdx.x; k < rows * (kSlice / 4); k += kBwdThreads) {
    sacc4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  const int64_t runs = (static_cast<int64_t>(n) + kWalkRun - 1) / kWalkRun;
  const int64_t warps = parts * kBwdWarps;
  const int64_t g = part * kBwdWarps + (threadIdx.x >> 5);
  const int64_t run_lo = g * runs / warps, run_hi = (g + 1) * runs / warps;

  // axis i's window: the gradient of rows win[i] and win[i] + 1 not yet
  // added to shared memory (win -1: empty)
  int win[3] = {-1, -1, -1};
  float acc[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  const auto shared_add = [&](int i, int row, float val) {
    if (on && val != 0.0f) atomicAdd(sacc + (off[i] + row) * kSlice + lane, val);
  };

  // a run's coordinates and density gradients (lane j: sample j), loaded
  // one run ahead
  const auto load_run = [&](int64_t run, float (&x)[3], float& gs) {
    const int64_t s = run * kWalkRun + lane;
    x[0] = x[1] = x[2] = 0.0f;
    gs = 0.0f;
    if (run < run_hi && s < n) {
      x[0] = xn[3 * s];
      x[1] = xn[3 * s + 1];
      x[2] = xn[3 * s + 2];
      if (SIGMA) gs = d_sigma[s];
    }
  };
  float next_x[3], next_gs;
  load_run(run_lo, next_x, next_gs);
  for (int64_t run = run_lo; run < run_hi; ++run) {
    const int64_t base = run * kWalkRun;
    const int cnt = static_cast<int>(base + kWalkRun <= n ? kWalkRun : n - base);
    const float x[3] = {next_x[0], next_x[1], next_x[2]};
    const float gs = next_gs;
    load_run(run + 1, next_x, next_gs);
    // density alone: a run with no gradient adds nothing
    if (!APP && !__any_sync(0xffffffffu, gs != 0.0f)) continue;
    const CPGeo mine = cp_geometry<BF16>(x, d);
    // sample j's geometry, this lane's gradient and its six rows
    const auto fetch = [&](int j, CPGeo& geo, float& gv, float (&r)[6]) {
      geo = cp_shuffle(mine, j);
      const float gsj = SIGMA ? __shfl_sync(0xffffffffu, gs, j) : 0.0f;
      gv = 0.0f;
      if (on) {
        gv = dens ? gsj : __ldg(d_app + (base + j) * na + (ch - d.nd));
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float* row = tab.line[i] + static_cast<int64_t>(geo.lo(i)) * d.c + ch;
          r[2 * i] = __ldg(row);
          r[2 * i + 1] = __ldg(row + geo.dl(i) * d.c);
        }
      }
    };
    CPGeo geo;
    float gv, r[6];
    fetch(0, geo, gv, r);
    for (int j = 0; j < cnt; ++j) {
      CPGeo ngeo = geo;
      float ngv = 0.0f, nr[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) nr[q] = r[q];
      if (j + 1 < cnt) fetch(j + 1, ngeo, ngv, nr);
      // adds +0 to every row it touches
      if (__any_sync(0xffffffffu, gv != 0.0f)) {
        float wa[3], v[3], dl[3][2];
        lower_weights<BF16>(geo, wa);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          v[i] = line_value<BF16>(r[2 * i], r[2 * i + 1], wa[i], geo.t[i]);
        }
        cp_channel_grads<BF16>(v, gv, geo, wa, dl);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int l0 = geo.lo(i);
          if (l0 != win[i]) {  // warp-uniform: every lane holds the same sample
            if (l0 == win[i] + 1) {  // one row up: row win leaves
              shared_add(i, win[i], acc[i][0]);
              acc[i][0] = acc[i][1];
              acc[i][1] = 0.0f;
            } else if (l0 + 1 == win[i]) {  // one row down: row win + 1 leaves
              shared_add(i, win[i] + 1, acc[i][1]);
              acc[i][1] = acc[i][0];
              acc[i][0] = 0.0f;
            } else {
              if (win[i] >= 0) {
                shared_add(i, win[i], acc[i][0]);
                shared_add(i, win[i] + 1, acc[i][1]);
              }
              acc[i][0] = acc[i][1] = 0.0f;
            }
            win[i] = l0;
          }
          // an edge-clamped upper row is row l0 itself; acc[i][1] of a
          // window at the last row stays 0 and is never added
          acc[i][0] = __fadd_rn(acc[i][0], dl[i][0]);
          if (geo.dl(i)) {
            acc[i][1] = __fadd_rn(acc[i][1], dl[i][1]);
          } else {
            acc[i][0] = __fadd_rn(acc[i][0], dl[i][1]);
          }
        }
      }
      geo = ngeo;
      gv = ngv;
#pragma unroll
      for (int q = 0; q < 6; ++q) r[q] = nr[q];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (win[i] >= 0) {
      shared_add(i, win[i], acc[i][0]);
      if (win[i] + 1 < d.l[i]) shared_add(i, win[i] + 1, acc[i][1]);
    }
  }

  // the block's slice into the tables, four channels per reduction;
  // untouched entries stay +0 and are skipped
  __syncthreads();
  for (int k = threadIdx.x; k < rows * (kSlice / 4); k += kBwdThreads) {
    const float4 val = sacc4[k];
    if (val.x == 0.0f && val.y == 0.0f && val.z == 0.0f && val.w == 0.0f) continue;
    int row = k / (kSlice / 4);
    const int c = slice * kSlice + (k % (kSlice / 4)) * 4;
    int i = 0;
    if (row >= d.l[0] + d.l[1]) {
      i = 2;
      row -= d.l[0] + d.l[1];
    } else if (row >= d.l[0]) {
      i = 1;
      row -= d.l[0];
    }
    float* dst = out.line[i] + static_cast<int64_t>(row) * d.c + c;
    if (vec4) {
      add4(dst, val);
    } else {
      const float vals[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (vals[e] != 0.0f && c + e < d.c) atomicAdd(dst + e, vals[e]);
      }
    }
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
  const float x[3] = {xn[3 * s], xn[3 * s + 1], xn[3 * s + 2]};
  const CPGeo geo = cp_geometry<BF16>(x, d);
  float wa[3];
  lower_weights<BF16>(geo, wa);
  const int c_lo = SIGMA ? 0 : d.nd;
  const int c_hi = APP ? d.c : d.nd;
  for (int ch = c_lo + lane; ch < c_hi; ch += 32) {
    const float g = ch < d.nd ? d_sigma[s] : __ldg(d_app + s * (d.c - d.nd) + (ch - d.nd));
    if (g == 0.0f) continue;
    float v[3], dl[3][2];
    int64_t q[3][2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      q[i][0] = static_cast<int64_t>(geo.lo(i)) * d.c + ch;
      q[i][1] = q[i][0] + geo.dl(i) * d.c;
      v[i] = line_value<BF16>(__ldg(tab.line[i] + q[i][0]), __ldg(tab.line[i] + q[i][1]),
                              wa[i], geo.t[i]);
    }
    cp_channel_grads<BF16>(v, g, geo, wa, dl);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      atomicAdd(out.line[i] + q[i][0], dl[i][0]);
      atomicAdd(out.line[i] + q[i][1], dl[i][1]);
    }
  }
}

// The shared route's blocks per SM on the current device for smem bytes,
// and its SM count (0 blocks: the lines do not fit).  Set up once per
// device and mode (the largest shared memory a block may take, the
// carveout that lets two such blocks share an SM), the occupancy once per
// size.
template <bool BF16, bool SIGMA, bool APP>
cudaError_t shared_grid(size_t smem, int* sms, int* per_sm) {
  struct Device {
    int sms = 0, smem_max = 0;
    std::map<size_t, int> per_sm;
  };
  static std::mutex mu;
  static std::map<int, Device> devices;
  const auto kernel = cp_features_bwd_walk_kernel<BF16, SIGMA, APP>;
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
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool BF16, bool SIGMA, bool APP>
void launch_fwd(const float* xn, int n, const CPLines& tab, const CPDims& d, float* sigma_out,
                float* app_out, cudaStream_t stream) {
  const int64_t runs = (static_cast<int64_t>(n) + kWalkRun - 1) / kWalkRun;
  const unsigned blocks = static_cast<unsigned>((runs * 32 + kFwdThreads - 1) / kFwdThreads);
  bool v4 = d.c % 4 == 0 && d.nd % 4 == 0 && (!APP || aligned16(app_out));
  for (int i = 0; i < 3; ++i) v4 = v4 && aligned16(tab.line[i]);
  if (v4) {
    cp_features_walk_kernel<BF16, SIGMA, APP, 4><<<blocks, kFwdThreads, 0, stream>>>(
        xn, n, tab, d, sigma_out, app_out);
  } else {
    cp_features_walk_kernel<BF16, SIGMA, APP, 1><<<blocks, kFwdThreads, 0, stream>>>(
        xn, n, tab, d, sigma_out, app_out);
  }
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
  // only the slices holding the mode's channels
  const int c_lo = SIGMA ? 0 : d.nd, c_hi = APP ? d.c : d.nd;
  const int slice_lo = c_lo / kSlice;
  const int slices = (c_hi + kSlice - 1) / kSlice - slice_lo;
  info[0] = kRouteShared;
  info[1] = 0;
  info[2] = kBwdThreads;
  if (slices < 1) return cudaSuccess;
  // as many blocks as fit on the card, split over the slices; a part holds
  // at least one run a warp
  const int64_t fit = std::max<int64_t>(1, static_cast<int64_t>(sms) * per_sm / slices);
  const int64_t ranges = (static_cast<int64_t>(n) + kWalkRun * kBwdWarps - 1) /
                         (kWalkRun * kBwdWarps);
  const int64_t parts = std::max<int64_t>(1, std::min<int64_t>(fit, ranges));
  const int blocks = static_cast<int>(parts * slices);
  bool vec4 = d.c % 4 == 0;
  for (int i = 0; i < 3; ++i) vec4 = vec4 && aligned16(out.line[i]);
  cp_features_bwd_walk_kernel<BF16, SIGMA, APP><<<blocks, kBwdThreads, smem, stream>>>(
      xn, n, tab, d, d_sigma, d_app, out, slice_lo, slices, vec4 ? 1 : 0);
  info[1] = blocks;
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
// null; at least one is not.  Lanes take 4 channels (16-byte loads and
// stores) when c and nd are multiples of 4 and the lines and app_out are
// 16-byte aligned, else 1.  Returns cudaGetLastError().
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
