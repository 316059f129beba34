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
// 300^3 grid, 461 KB an axis in fp32, half that in bf16) and live in L2,
// so HBM sees only the samples, the outputs and the output gradients: the
// forward's byte bound is its output ((1 + na) values per sample written,
// fp32, or fp32 + bf16 in bf16 mode; 12 B read), the backward's the
// gradients it reads.  Neither kernel gets near it.  Each sample reads
// six rows of the mode's channels through L1 (2.3 KB at 96 fp32
// channels), so the forward of ray-ordered samples is held by L1 traffic
// and instruction issue.  The backward adds a million samples into 3 x
// 300 rows, and sm_90 has no fp32 add in shared memory: the SASS of
// atomicAdd(float*) there is a compare-and-swap loop (ATOMS.CAST.SPIN), a
// chain of a shared load, an add and the swap.  Past that, C' is held by
// instruction issue (about 110 warp instructions per sample and
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
// Index math is fp32; every multiply and add of a value is a separately
// rounded __fmul_rn / __fadd_rn, as the plain version's op-by-op
// evaluation, so kernel C equals its plain version bit for bit; kernel C'
// adds in another order and is held to a tolerance.
//
// bf16 mode (the JAX bf16 path, fused_gather.py sample_packed_line with
// dtype=bf16: values gathered from packed.astype(bf16), lerp weights and
// every product rounded to bfloat16, index math in fp32; and the bf16
// train step's autodiff of it).  Both kernels read the lines' bf16 copy
// (made once per parameter version by the wrapper), kernel C writes
// app_raw as bf16 (sigma_feat stays fp32) and kernel C' reads a bf16
// d_app_raw (d_sigma stays fp32 and is rounded here); the gradient lines
// stay fp32 and C' accumulates in fp32 (JAX's XLA scatter-adds in bf16).
// Where C and nd allow it, the walks compute in packed bf16x2: a 32-bit
// word holds two channels, and every lerp and product is a mul.rn /
// add.rn.bf16x2 of factor_common.cuh, the bits of the plain version's
// op-by-op bf16; 1 - t is computed once per sample on its geometry lane,
// in fp32, and rounded, as the plain version rounds it.
//  - Kernel C (C and nd multiples of 4): a lane takes P channel pairs of
//    a sample (P / 2 8-byte loads a row): 6 (24 B) where the mode's
//    width is a multiple of 12 above 128 (TensorCP's 384 fused channels
//    in one item, 288 app channels on 24 lanes), else 2.  Each density
//    lane stores the fp64 sum of its pairs per sample in shared memory,
//    and lane j adds sample j's partials at the run's end (exact, so free
//    of the order), rounded once.
//  - Kernel C' (C and nd even): the shared route's walk on channel
//    pairs: a warp takes one sample an iteration, a lane one pair of a
//    64-channel slice, so a lane loads a 4-byte word per row and
//    gradient, and the chain d01 = g*v2, dv2 = g*(v0*v1), dv0 = d01*v1,
//    dv1 = d01*v0, dv*(1-t), dv*t is 11 packed ops.  Its products are
//    widened to fp32 only for their adds into the register window and
//    shared memory.  A block's slice of the three gradient lines is
//    [L_0 + L_1 + L_2][64] fp32 (230 KB at 300^3), so one 1024-thread
//    block an SM (64 registers a thread, as the fp32 route's two 512-thread
//    blocks); a row keeps the pairs' low channels, then their high ones,
//    so a warp's adds hit 32 banks.  Longer lines take the one-channel
//    walk (32-channel slices), then the generic route.  Measured slower
//    (PERF.md): 32-channel slices with a half-warp a sample and two
//    samples an iteration (two 512-thread blocks an SM), 1.1-1.5x this
//    layout's time.
//  - Other widths: the fp32 walks and the generic route on the bf16
//    copy, one channel at a time through fp32 rounded to bf16.

#include <algorithm>
#include <map>
#include <mutex>
#include <type_traits>

#include "factor_common.cuh"

namespace {

struct CPDims {
  int l[3];
  int c, nd;
};

template <typename T>
struct CPLinesOf {
  const T* line[3];
};
using CPLines16 = CPLinesOf<__nv_bfloat16>;  // the bf16 mode's copy of the lines

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
constexpr int kSlice16 = 64;        // the packed bf16 C': channels a block owns (a pair a lane)
constexpr int kBwd16Threads = 1024;  // ... one block an SM (64 registers a thread)

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

template <int V, typename T>
__device__ __forceinline__ void load_ch(const T* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else {
    out[0] = ld(p);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_ch(T* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = static_cast<T>(v[0]);
  }
}

// ---- kernel C: one warp per run of 32 samples ------------------------------

// Item (j, k) of a run is sample j's channel chunk k: this lane's channels
// c_lo + k*32*V + lane*V + [0, V).  The next item's rows (and, at a new
// sample, its geometry) are loaded before this item's arithmetic.  T: the
// lines' and app_out's element type (float, or __nv_bfloat16 in bf16 mode,
// V = 1, every op rounded to bf16).
template <typename T, bool SIGMA, bool APP, int V>
__global__ void __launch_bounds__(kFwdThreads, 3)
cp_features_walk_kernel(const float* __restrict__ xn, int n, CPLinesOf<T> tab, CPDims d,
                        float* __restrict__ sigma_out, T* __restrict__ app_out) {
  constexpr bool BF16 = !std::is_same<T, float>::value;
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
        const T* row = tab.line[i] + static_cast<int64_t>(g.lo(i)) * d.c + ch;
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

// ---- the packed bf16 walks: geometry ----------------------------------------

// one sample's three axes in bf16: CPGeo's rows and, per axis, the weight
// pair ((1 - t) lo, t hi) of factor_common.cuh's weight_pair
struct CPGeo16 {
  uint32_t l[3];
  uint32_t w[3];
  __device__ __forceinline__ int lo(int i) const { return static_cast<int>(l[i] & 0x7FFFFFFFu); }
  __device__ __forceinline__ int dl(int i) const { return static_cast<int>(l[i] >> 31); }
};

__device__ __forceinline__ CPGeo16 cp_geometry16(const float (&x)[3], const CPDims& d) {
  CPGeo16 g;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    int l0;
    float t;
    coords(x[vec(i)], d.l[i], l0, t);
    g.w[i] = weight_pair(t);
    g.l[i] = static_cast<uint32_t>(l0) | (l0 + 1 < d.l[i] ? 0x80000000u : 0u);
  }
  return g;
}

__device__ __forceinline__ CPGeo16 cp_shuffle16(const CPGeo16& g, int src) {
  CPGeo16 out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out.l[i] = __shfl_sync(0xffffffffu, g.l[i], src);
    out.w[i] = __shfl_sync(0xffffffffu, g.w[i], src);
  }
  return out;
}

// ---- kernel C in bf16, packed: one warp per run of 32 samples ---------------

// The lane's P channel pairs of a row at channel ch, as P / 2 8-byte words.
template <int P>
__device__ __forceinline__ void load_pairs(const __nv_bfloat16* row, uint32_t (&out)[P]) {
  const uint2* p = reinterpret_cast<const uint2*>(row);
#pragma unroll
  for (int q = 0; q < P / 2; ++q) {
    const uint2 v = __ldg(p + q);
    out[2 * q] = v.x;
    out[2 * q + 1] = v.y;
  }
}

// Kernel C's walk with P channel pairs a lane (2P channels; C and nd
// multiples of 4, so each 8-byte word of 4 channels is density or app as
// a whole).  Item (j, k) is sample j's chunk k: this lane's channels
// c_lo + k*64P + lane*2P + [0, 2P).  Shared memory: the density lanes'
// fp64 partials, [warp][sample][density lane].
template <bool SIGMA, bool APP, int P>
__global__ void __launch_bounds__(kFwdThreads, P > 2 ? 2 : 3)
cp_features_walk_bf16_kernel(const float* __restrict__ xn, int n, CPLines16 tab, CPDims d,
                             int dens_lanes, float* __restrict__ sigma_out,
                             __nv_bfloat16* __restrict__ app_out) {
  constexpr int kLaneCh = 2 * P;
  constexpr int kChunk = 32 * kLaneCh;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kFwdThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t base = warp * kWalkRun;
  if (base >= n) return;
  const int cnt = static_cast<int>(base + kWalkRun <= n ? kWalkRun : n - base);
  const int na = d.c - d.nd;
  const int c_lo = SIGMA ? 0 : d.nd;
  const int c_hi = APP ? d.c : d.nd;
  const int chunks = (c_hi - c_lo + kChunk - 1) / kChunk;
  extern __shared__ double partials[];
  double* part_w = partials + (threadIdx.x >> 5) * kWalkRun * dens_lanes;

  float x[3] = {0.0f, 0.0f, 0.0f};
  if (lane < cnt) {
    x[0] = xn[3 * (base + lane)];
    x[1] = xn[3 * (base + lane) + 1];
    x[2] = xn[3 * (base + lane) + 2];
  }
  const CPGeo16 mine = cp_geometry16(x, d);
  const auto fetch = [&](const CPGeo16& g, int k, uint32_t (&r)[6][P]) {
    const int ch = c_lo + k * kChunk + lane * kLaneCh;
    if (ch < c_hi) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const __nv_bfloat16* row = tab.line[i] + static_cast<int64_t>(g.lo(i)) * d.c + ch;
        load_pairs<P>(row, r[2 * i]);
        load_pairs<P>(row + g.dl(i) * d.c, r[2 * i + 1]);
      }
    }
  };
  if (chunks > 0) {
    double part = 0.0;  // this lane's density channels of the current sample
    int j = 0, k = 0;
    CPGeo16 cur = cp_shuffle16(mine, 0);
    uint32_t r[6][P];
    fetch(cur, 0, r);
    for (;;) {
      int nj = j, nk = k + 1;
      if (nk == chunks) {
        nk = 0;
        ++nj;
      }
      CPGeo16 nxt = cur;
      uint32_t nr[6][P];
      if (nj < cnt) {
        if (nk == 0) nxt = cp_shuffle16(mine, nj);
        fetch(nxt, nk, nr);
      }
      const int ch = c_lo + k * kChunk + lane * kLaneCh;
      if (ch < c_hi) {
        uint32_t wa[3], t[3], prod[P];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          wa[i] = bcast_lo(cur.w[i]);
          t[i] = bcast_hi(cur.w[i]);
        }
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const uint32_t v0 = lerp2(r[0][q], r[1][q], wa[0], t[0]);
          const uint32_t v1 = lerp2(r[2][q], r[3][q], wa[1], t[1]);
          const uint32_t v2 = lerp2(r[4][q], r[5][q], wa[2], t[2]);
          prod[q] = bmul2(bmul2(v0, v1), v2);
        }
#pragma unroll
        for (int q = 0; q < P / 2; ++q) {  // 4 channels: density or app as a whole
          const int c4 = ch + 4 * q;
          if (SIGMA && c4 < d.nd) {
            part += static_cast<double>(bf_lo(prod[2 * q])) +
                    static_cast<double>(bf_hi(prod[2 * q])) +
                    static_cast<double>(bf_lo(prod[2 * q + 1])) +
                    static_cast<double>(bf_hi(prod[2 * q + 1]));
          } else if (APP && c4 >= d.nd) {
            *reinterpret_cast<uint2*>(app_out + (base + j) * na + (c4 - d.nd)) =
                make_uint2(prod[2 * q], prod[2 * q + 1]);
          }
        }
      }
      if (SIGMA && nk == 0) {  // sample j's last chunk: this lane's partial of it
        if (lane < dens_lanes) part_w[j * dens_lanes + lane] = part;
        part = 0.0;
      }
      if (nj >= cnt) break;
      j = nj;
      k = nk;
      cur = nxt;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
#pragma unroll
        for (int v = 0; v < P; ++v) r[q][v] = nr[q][v];
      }
    }
  }
  if (SIGMA) {
    __syncwarp();
    if (lane < cnt) {
      double sum = 0.0;
      for (int q = 0; q < dens_lanes; ++q) sum += part_w[lane * dens_lanes + q];
      sigma_out[base + lane] = rnd<true>(static_cast<float>(sum));
    }
  }
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

// The block's slice of the three gradient lines, [rows][slice] fp32 in
// shared memory, into the tables, four channels per reduction; untouched
// entries stay +0 and are skipped.  quad(s, q) reads channels 4q .. 4q + 3
// of the slice's row at s.
template <int Slice, int Threads, typename Quad>
__device__ __forceinline__ void reduce_slice(const float* sacc, const CPDims& d, int slice,
                                             const CPGrads& out, int vec4, Quad quad) {
  const int rows = d.l[0] + d.l[1] + d.l[2];
  for (int k = threadIdx.x; k < rows * (Slice / 4); k += Threads) {
    int row = k / (Slice / 4);
    const int q = k % (Slice / 4);
    const float4 val = quad(sacc + row * Slice, q);
    if (val.x == 0.0f && val.y == 0.0f && val.z == 0.0f && val.w == 0.0f) continue;
    const int c = slice * Slice + 4 * q;
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

// Block b owns channel slice slice_lo + b % slices and part b / slices of
// the samples; warp w of part p walks runs [g*R/G, (g+1)*R/G) of the R runs
// of 32 samples, g = p * kBwdWarps + w, G = parts * kBwdWarps.  Shared
// memory: [L_0 + L_1 + L_2][32] fp32, axis i's rows from off[i].  T: the
// lines' and d_app's element type (float, or __nv_bfloat16 in bf16 mode,
// every op rounded to bf16).
template <typename T, bool SIGMA, bool APP>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
cp_features_bwd_walk_kernel(const float* __restrict__ xn, int n, CPLinesOf<T> tab, CPDims d,
                            const float* __restrict__ d_sigma,
                            const T* __restrict__ d_app, CPGrads out, int slice_lo,
                            int slices, int vec4) {
  constexpr bool BF16 = !std::is_same<T, float>::value;
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
        gv = dens ? gsj : ld(d_app + (base + j) * na + (ch - d.nd));
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const T* row = tab.line[i] + static_cast<int64_t>(geo.lo(i)) * d.c + ch;
          r[2 * i] = ld(row);
          r[2 * i + 1] = ld(row + geo.dl(i) * d.c);
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
  __syncthreads();
  reduce_slice<kSlice, kBwdThreads>(sacc, d, slice, out, vec4, [](const float* s, int q) {
    return reinterpret_cast<const float4*>(s)[q];
  });
}

// ---- kernel C' in bf16, packed: the shared route's walk on channel pairs ----

__device__ __forceinline__ void add_pair(float2& a, float2 b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
}

// The shared route's walk in bf16 with C and nd even: a warp takes one
// sample an iteration, lane k its pair k of the 64-channel slice
// slice_lo + b % slices that block b owns.  Shared memory: [rows][64]
// fp32, a row's pairs' low channels at [0, 32), their high ones at
// [32, 64).
template <bool SIGMA, bool APP>
__global__ void __launch_bounds__(kBwd16Threads, 1)
cp_features_bwd_walk_bf16_kernel(const float* __restrict__ xn, int n, CPLines16 tab, CPDims d,
                                 const float* __restrict__ d_sigma,
                                 const __nv_bfloat16* __restrict__ d_app, CPGrads out,
                                 int slice_lo, int slices, int vec4) {
  constexpr int kWarps = kBwd16Threads / 32;
  extern __shared__ float4 sacc4[];
  float* sacc = reinterpret_cast<float*>(sacc4);
  const int rows = d.l[0] + d.l[1] + d.l[2];
  const int lane = threadIdx.x & 31;
  const int slice = slice_lo + static_cast<int>(blockIdx.x % slices);
  const int64_t part = blockIdx.x / slices, parts = gridDim.x / slices;
  const int ch = slice * kSlice16 + 2 * lane;  // this lane's pair: ch, ch + 1
  const int c_lo = SIGMA ? 0 : d.nd;
  const int c_hi = APP ? d.c : d.nd;
  const bool on = ch >= c_lo && ch < c_hi;
  const bool dens = ch < d.nd;
  const int na = d.c - d.nd;
  const int off[3] = {0, d.l[0], d.l[0] + d.l[1]};
  for (int k = threadIdx.x; k < rows * (kSlice16 / 4); k += kBwd16Threads) {
    sacc4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  const int64_t runs = (static_cast<int64_t>(n) + kWalkRun - 1) / kWalkRun;
  const int64_t warps = parts * kWarps;
  const int64_t g = part * kWarps + (threadIdx.x >> 5);
  const int64_t run_lo = g * runs / warps, run_hi = (g + 1) * runs / warps;

  int win[3] = {-1, -1, -1};
  float2 acc[3][2];
#pragma unroll
  for (int i = 0; i < 3; ++i) acc[i][0] = acc[i][1] = make_float2(0.0f, 0.0f);
  const auto shared_add = [&](int i, int row, float2 v) {
    if (!on) return;
    float* p = sacc + (off[i] + row) * kSlice16 + lane;
    if (v.x != 0.0f) atomicAdd(p, v.x);
    if (v.y != 0.0f) atomicAdd(p + 32, v.y);
  };

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
    if (!APP && !__any_sync(0xffffffffu, gs != 0.0f)) continue;
    const CPGeo16 mine = cp_geometry16(x, d);
    // sample j's geometry, this lane's gradient pair and its six rows
    const auto fetch = [&](int j, CPGeo16& geo, uint32_t& gv, uint32_t (&r)[6]) {
      geo = cp_shuffle16(mine, j);
      const float gsj = SIGMA ? __shfl_sync(0xffffffffu, gs, j) : 0.0f;
      gv = 0u;
      if (on) {
        gv = dens ? bf16_bits(gsj) * 0x10001u
                  : __ldg(reinterpret_cast<const unsigned int*>(
                        d_app + (base + j) * na + (ch - d.nd)));
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const __nv_bfloat16* row = tab.line[i] + static_cast<int64_t>(geo.lo(i)) * d.c + ch;
          r[2 * i] = __ldg(reinterpret_cast<const unsigned int*>(row));
          r[2 * i + 1] = __ldg(reinterpret_cast<const unsigned int*>(row + geo.dl(i) * d.c));
        }
      }
    };
    CPGeo16 geo;
    uint32_t gv, r[6];
    fetch(0, geo, gv, r);
    for (int j = 0; j < cnt; ++j) {
      CPGeo16 ngeo = geo;
      uint32_t ngv = 0u, nr[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) nr[q] = r[q];
      if (j + 1 < cnt) fetch(j + 1, ngeo, ngv, nr);
      // adds +-0 to every row it touches
      if (__any_sync(0xffffffffu, (gv & 0x7FFF7FFFu) != 0u)) {
        uint32_t wa[3], t[3], v[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          wa[i] = bcast_lo(geo.w[i]);
          t[i] = bcast_hi(geo.w[i]);
          v[i] = lerp2(r[2 * i], r[2 * i + 1], wa[i], t[i]);
        }
        const uint32_t p01 = bmul2(v[0], v[1]);
        const uint32_t d01 = bmul2(gv, v[2]);
        const uint32_t dv[3] = {bmul2(d01, v[1]), bmul2(d01, v[0]), bmul2(gv, p01)};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const uint32_t t0 = bmul2(dv[i], wa[i]), t1 = bmul2(dv[i], t[i]);
          const float2 dl0 = make_float2(bf_lo(t0), bf_hi(t0));
          const float2 dl1 = make_float2(bf_lo(t1), bf_hi(t1));
          const int l0 = geo.lo(i);
          if (l0 != win[i]) {  // uniform over the warp
            if (l0 == win[i] + 1) {
              shared_add(i, win[i], acc[i][0]);
              acc[i][0] = acc[i][1];
              acc[i][1] = make_float2(0.0f, 0.0f);
            } else if (l0 + 1 == win[i]) {
              shared_add(i, win[i] + 1, acc[i][1]);
              acc[i][1] = acc[i][0];
              acc[i][0] = make_float2(0.0f, 0.0f);
            } else {
              if (win[i] >= 0) {
                shared_add(i, win[i], acc[i][0]);
                shared_add(i, win[i] + 1, acc[i][1]);
              }
              acc[i][0] = acc[i][1] = make_float2(0.0f, 0.0f);
            }
            win[i] = l0;
          }
          // an edge-clamped upper row is row l0 itself
          add_pair(acc[i][0], dl0);
          if (geo.dl(i)) {
            add_pair(acc[i][1], dl1);
          } else {
            add_pair(acc[i][0], dl1);
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
  __syncthreads();
  // channels 4q .. 4q + 3 are pairs 2q, 2q + 1
  reduce_slice<kSlice16, kBwd16Threads>(sacc, d, slice, out, vec4, [](const float* s, int q) {
    const float2 lo = reinterpret_cast<const float2*>(s)[q];
    const float2 hi = reinterpret_cast<const float2*>(s + 32)[q];
    return make_float4(lo.x, hi.x, lo.y, hi.y);
  });
}

// Generic route: one warp per sample, lanes stride the channels.  T as the
// walk's.
template <typename T, bool SIGMA, bool APP>
__global__ void cp_features_bwd_kernel(const float* __restrict__ xn, int n, CPLinesOf<T> tab,
                                       CPDims d, const float* __restrict__ d_sigma,
                                       const T* __restrict__ d_app, CPGrads out) {
  constexpr bool BF16 = !std::is_same<T, float>::value;
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
    const float g = ch < d.nd ? d_sigma[s] : ld(d_app + s * (d.c - d.nd) + (ch - d.nd));
    if (g == 0.0f) continue;
    float v[3], dl[3][2];
    int64_t q[3][2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      q[i][0] = static_cast<int64_t>(geo.lo(i)) * d.c + ch;
      q[i][1] = q[i][0] + geo.dl(i) * d.c;
      v[i] = line_value<BF16>(ld(tab.line[i] + q[i][0]), ld(tab.line[i] + q[i][1]), wa[i],
                              geo.t[i]);
    }
    cp_channel_grads<BF16>(v, g, geo, wa, dl);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      atomicAdd(out.line[i] + q[i][0], dl[i][0]);
      atomicAdd(out.line[i] + q[i][1], dl[i][1]);
    }
  }
}

// A shared-route kernel's blocks per SM on the current device for smem
// bytes, and its SM count (0 blocks: the lines do not fit).  Set up once
// per device and kernel (the largest shared memory a block may take, the
// carveout that lets the most such blocks share an SM), the occupancy
// once per size.
template <auto Kernel, int Threads>
cudaError_t shared_grid(size_t smem, int* sms, int* per_sm) {
  struct Device {
    int sms = 0, smem_max = 0;
    std::map<size_t, int> per_sm;
  };
  static std::mutex mu;
  static std::map<int, Device> devices;
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
      err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 info.smem_max);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(Kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel, Threads, smem);
    if (err != cudaSuccess) return err;
    fit = info.per_sm.emplace(smem, blocks).first;
  }
  *per_sm = fit->second;
  return cudaSuccess;
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, bool SIGMA, bool APP>
cudaError_t launch_fwd(const float* xn, int n, const CPLinesOf<T>& tab, const CPDims& d,
                       float* sigma_out, T* app_out, cudaStream_t stream) {
  const int64_t runs = (static_cast<int64_t>(n) + kWalkRun - 1) / kWalkRun;
  const unsigned blocks = static_cast<unsigned>((runs * 32 + kFwdThreads - 1) / kFwdThreads);
  if constexpr (std::is_same<T, float>::value) {
    bool v4 = d.c % 4 == 0 && d.nd % 4 == 0 && (!APP || aligned(app_out, 16));
    for (int i = 0; i < 3; ++i) v4 = v4 && aligned(tab.line[i], 16);
    if (v4) {
      cp_features_walk_kernel<float, SIGMA, APP, 4><<<blocks, kFwdThreads, 0, stream>>>(
          xn, n, tab, d, sigma_out, app_out);
      return cudaGetLastError();
    }
  } else {
    bool packed = d.c % 4 == 0 && d.nd % 4 == 0 && (!APP || aligned(app_out, 8));
    for (int i = 0; i < 3; ++i) packed = packed && aligned(tab.line[i], 8);
    if (packed) {
      const int width = (APP ? d.c : d.nd) - (SIGMA ? 0 : d.nd);
      const bool six = width % 12 == 0 && width > 128;
      const int lane_ch = six ? 12 : 4;
      const int dens_lanes = SIGMA ? std::min(32, (d.nd + lane_ch - 1) / lane_ch) : 0;
      const size_t smem = sizeof(double) * (kFwdThreads / 32) * kWalkRun * dens_lanes;
      const auto go = [&](auto kernel) {
        cudaError_t err = cudaSuccess;
        if (smem > 48 * 1024) {
          err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem));
        }
        if (err != cudaSuccess) return err;
        kernel<<<blocks, kFwdThreads, smem, stream>>>(xn, n, tab, d, dens_lanes, sigma_out,
                                                      app_out);
        return cudaGetLastError();
      };
      return six ? go(cp_features_walk_bf16_kernel<SIGMA, APP, 6>)
                 : go(cp_features_walk_bf16_kernel<SIGMA, APP, 2>);
    }
  }
  cp_features_walk_kernel<T, SIGMA, APP, 1><<<blocks, kFwdThreads, 0, stream>>>(
      xn, n, tab, d, sigma_out, app_out);
  return cudaGetLastError();
}

// The shared route's persistent grid for Kernel (Threads a block, Slice
// channels a block's slice): as many blocks as fit on the card, split over
// the slices holding the mode's channels; a part holds at least one run a
// warp.  *fits is false (nothing launched) when the lines do not fit a
// block's shared memory.
template <auto Kernel, int Threads, int Slice, typename T, bool SIGMA, bool APP>
cudaError_t launch_walk(const float* xn, int n, const CPLinesOf<T>& tab, const CPDims& d,
                        const float* d_sigma, const T* d_app, const CPGrads& out,
                        cudaStream_t stream, int* info, bool* fits) {
  const size_t smem = sizeof(float) * Slice * (d.l[0] + d.l[1] + d.l[2]);
  int sms = 0, per_sm = 0;
  const cudaError_t err = shared_grid<Kernel, Threads>(smem, &sms, &per_sm);
  *fits = per_sm > 0;
  if (err != cudaSuccess || !*fits) return err;
  const int c_lo = SIGMA ? 0 : d.nd, c_hi = APP ? d.c : d.nd;
  const int slice_lo = c_lo / Slice;
  const int slices = (c_hi + Slice - 1) / Slice - slice_lo;
  info[0] = kRouteShared;
  info[1] = 0;
  info[2] = Threads;
  if (slices < 1) return cudaSuccess;
  const int64_t fit = std::max<int64_t>(1, static_cast<int64_t>(sms) * per_sm / slices);
  const int64_t ranges = (static_cast<int64_t>(n) + kWalkRun * (Threads / 32) - 1) /
                         (kWalkRun * (Threads / 32));
  const int64_t parts = std::max<int64_t>(1, std::min<int64_t>(fit, ranges));
  const int blocks = static_cast<int>(parts * slices);
  bool vec4 = d.c % 4 == 0;
  for (int i = 0; i < 3; ++i) vec4 = vec4 && aligned(out.line[i], 16);
  Kernel<<<blocks, Threads, smem, stream>>>(xn, n, tab, d, d_sigma, d_app, out, slice_lo, slices,
                                            vec4 ? 1 : 0);
  info[1] = blocks;
  return cudaGetLastError();
}

template <typename T, bool SIGMA, bool APP>
cudaError_t launch_bwd(const float* xn, int n, const CPLinesOf<T>& tab, const CPDims& d,
                       const float* d_sigma, const T* d_app, const CPGrads& out,
                       cudaStream_t stream, int* info) {
  bool fits = false;
  cudaError_t err = cudaSuccess;
  if constexpr (!std::is_same<T, float>::value) {
    bool packed = d.c % 2 == 0 && d.nd % 2 == 0 && (!APP || aligned(d_app, 4));
    for (int i = 0; i < 3; ++i) packed = packed && aligned(tab.line[i], 4);
    if (packed) {
      err = launch_walk<cp_features_bwd_walk_bf16_kernel<SIGMA, APP>, kBwd16Threads, kSlice16, T,
                        SIGMA, APP>(
          xn, n, tab, d, d_sigma, d_app, out, stream, info, &fits);
    }
  }
  if (err == cudaSuccess && !fits) {
    err = launch_walk<cp_features_bwd_walk_kernel<T, SIGMA, APP>, kBwdThreads, kSlice, T, SIGMA,
                      APP>(xn, n, tab, d, d_sigma, d_app, out, stream, info, &fits);
  }
  if (err != cudaSuccess || fits) return err;
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<int64_t>(n) * 32 + kGenericThreads - 1) / kGenericThreads);
  cp_features_bwd_kernel<T, SIGMA, APP><<<blocks, kGenericThreads, 0, stream>>>(
      xn, n, tab, d, d_sigma, d_app, out);
  info[0] = kRouteGeneric;
  info[1] = static_cast<int>(blocks);
  info[2] = kGenericThreads;
  return cudaGetLastError();
}

CPDims make_dims(const int* dims) {
  CPDims d;
  for (int i = 0; i < 3; ++i) d.l[i] = dims[i];
  d.c = dims[3];
  d.nd = dims[4];
  return d;
}

template <typename T>
int forward(const float* xn, int n, const T* line0, const T* line1, const T* line2,
            const int* dims, float* sigma_out, T* app_out, void* stream) {
  const CPDims d = make_dims(dims);
  const CPLinesOf<T> tab = {{line0, line1, line2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (sigma_out != nullptr && app_out != nullptr) {
    err = launch_fwd<T, true, true>(xn, n, tab, d, sigma_out, app_out, st);
  } else if (sigma_out != nullptr) {
    err = launch_fwd<T, true, false>(xn, n, tab, d, sigma_out, app_out, st);
  } else {
    err = launch_fwd<T, false, true>(xn, n, tab, d, sigma_out, app_out, st);
  }
  return static_cast<int>(err);
}

template <typename T>
int backward(const float* xn, int n, const T* line0, const T* line1, const T* line2,
             const int* dims, const float* d_sigma, const T* d_app, float* dline0, float* dline1,
             float* dline2, int zero, int* info, void* stream) {
  const CPDims d = make_dims(dims);
  const CPLinesOf<T> tab = {{line0, line1, line2}};
  const CPGrads out = {{dline0, dline1, dline2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zero) {
    for (int i = 0; i < 3; ++i) {
      const cudaError_t err =
          cudaMemsetAsync(out.line[i], 0, sizeof(float) * d.l[i] * d.c, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  cudaError_t err;
  if (d_sigma != nullptr && d_app != nullptr) {
    err = launch_bwd<T, true, true>(xn, n, tab, d, d_sigma, d_app, out, st, info);
  } else if (d_sigma != nullptr) {
    err = launch_bwd<T, true, false>(xn, n, tab, d, d_sigma, d_app, out, st, info);
  } else {
    err = launch_bwd<T, false, true>(xn, n, tab, d, d_sigma, d_app, out, st, info);
  }
  return static_cast<int>(err);
}

}  // namespace

// dims: 5 ints, l[3] c nd.  sigma_out and/or app_out (N x (c - nd)) may be
// null; at least one is not.  fp32 mode: lanes take 4 channels (16-byte
// loads and stores) when c and nd are multiples of 4 and the lines and
// app_out are 16-byte aligned, else 1.  Returns the launch's CUDA error.
extern "C" int t2n_cp_features(const float* xn, int n, const float* line0, const float* line1,
                               const float* line2, const int* dims, float* sigma_out,
                               float* app_out, void* stream) {
  return forward(xn, n, line0, line1, line2, dims, sigma_out, app_out, stream);
}

// bf16 mode: the same with the lines' bf16 copies and a bf16 app_out
// (sigma_out stays fp32); packed bf16x2 when c and nd are multiples of 4
// and the lines and app_out are 8-byte aligned, else one channel a lane.
extern "C" int t2n_cp_features_bf16(const float* xn, int n, const __nv_bfloat16* line0,
                                    const __nv_bfloat16* line1, const __nv_bfloat16* line2,
                                    const int* dims, float* sigma_out, __nv_bfloat16* app_out,
                                    void* stream) {
  return forward(xn, n, line0, line1, line2, dims, sigma_out, app_out, stream);
}

// dims as t2n_cp_features.  d_sigma and/or d_app may be null; at least one
// is not.  zero != 0 zeroes the three gradient lines first (on the same
// stream); zero == 0 adds into them.  info (3 ints) receives the route (1
// shared, 2 generic), the blocks and the threads per block.  Returns the
// first CUDA error of the memsets and the launch.
extern "C" int t2n_cp_features_bwd(const float* xn, int n, const float* line0,
                                   const float* line1, const float* line2, const int* dims,
                                   const float* d_sigma, const float* d_app, float* dline0,
                                   float* dline1, float* dline2, int zero, int* info,
                                   void* stream) {
  return backward(xn, n, line0, line1, line2, dims, d_sigma, d_app, dline0, dline1, dline2,
                  zero, info, stream);
}

// bf16 mode: the lines' bf16 copies and a bf16 d_app (d_sigma and the
// gradient lines stay fp32); the packed walk when c and nd are even and
// the lines and d_app are 4-byte aligned.
extern "C" int t2n_cp_features_bwd_bf16(const float* xn, int n, const __nv_bfloat16* line0,
                                        const __nv_bfloat16* line1, const __nv_bfloat16* line2,
                                        const int* dims, const float* d_sigma,
                                        const __nv_bfloat16* d_app, float* dline0,
                                        float* dline1, float* dline2, int zero, int* info,
                                        void* stream) {
  return backward(xn, n, line0, line1, line2, dims, d_sigma, d_app, dline0, dline1, dline2,
                  zero, info, stream);
}
