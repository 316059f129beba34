// Kernel B: the eval shading heads MLP_Fea_noview and MLP_Fea, forward only.
//
// Replaces the Pallas TPU kernel text2nerf_tpu/ops/pallas/shading_mlp.py
// shade_fea_noview_pallas (:55, pallas_call at :89), which computes
// models/mlp.py shade("MLP_Fea_noview") (:96-100):
//   x = [f, sin(f * 2^k), cos(f * 2^k)] for k < F     (width C * (1 + 2F))
//   rgb = sigmoid(relu(relu(x W1 + b1) W2 + b2) W3 + b3)
// in fp32, weights in (in, out) layout.  The view-dependent mode
// (shade_view_kernel) computes shade("MLP_Fea") the same way, from
//   x = [f, d, sin(f * 2^k), cos(f * 2^k), sin(d * 2^j), cos(d * 2^j)]
// for k < F, j < V (width C + 3 + 2CF + 6V), d the direction of the row's
// ray; the JAX package runs that head as XLA, so this mode replaces no
// Pallas kernel: it serves the eval renders of TensoRF's own head.
//
// What bounds it on an H100: operations.  Layers 1 and 2 are
// 2 * (351*128 + 128*128) = 123 kFLOP per row against 120 B of input and
// output (MLP_Fea at C 27, F 2, V 2: 2 * (150*128 + 128*128) = 71 kFLOP
// against 120 B, the direction read once a ray).  They run on the tensor
// cores in 3xTF32: a*b ~ a_hi*b_hi +
// a_hi*b_lo + a_lo*b_hi, each part rounded to TF32 (to nearest, as
// cvt.rna), fp32 accumulation, about 2^-21 relative error per product, so the head stays
// fp32-faithful.  Three TF32 products at 495 TFLOP/s: 0.78 ms per 1M rows.
//
// Design.  Persistent blocks, one per SM, each walking 192-row tiles: a
// producer warpgroup streams the weights, three consumer warpgroups own 64
// rows each.  Registers are allocated per 4 warps, 128 a thread at launch
// for 512 threads; the producer gives back all but 24 (setmaxnreg) so the
// consumers get 160, enough for the accumulators with the wgmmas in
// flight (with fewer, ptxas serializes them).  wgmma (m64nNk8, TF32,
// sm_90a) takes both operands K-major, so the wrapper lays the weights
// out once per set of weights as W^T in the no-swizzle core-matrix image
// wgmma reads (8 rows x 16 B per 128 B core matrix), split into hi and
// lo, in K-slices of 8 (4 KB each part).
//  - Layer 1's A operand (the PE) is made in registers: each thread
//    computes its own fragment elements from the tile's features (staged
//    in shared memory by cp.async behind the previous tile's layers 2 and
//    3), one sine-cosine pair per (channel, band) and row.  The K axis is
//    permuted so that a thread's two K slots of a slice hold one sine and
//    its cosine; W1^T's columns are permuted to match, and K is
//    zero-padded to a multiple of 8 (351 -> 352; MLP_Fea 150 -> 152).  A
//    row's values are its C features and, in the view mode, its ray's 3
//    direction components (staged beside the features, each row's from
//    its ray, row / k: the rows of a ray lie one after another, so a ray's
//    direction crosses L2 once); the pairs are the sine-cosine pairs of
//    the features, then of the direction components, then the raw values
//    two a pair.  A step takes two
//    slices: its fragments (four sine-cosine chains, interleaved) are
//    computed while the tensor cores run the step before it.  sin/cos come
//    from a branch-free reduction and polynomial within 1.5 ulp (sincosf's
//    slow-path branch keeps a warp's chains from interleaving); sincosf
//    takes arguments past 105615.  The pair table (value, 2^band) is
//    built once per block: no division or conversion per slice.
//  - Layer 1's B operand (W1^T, 360 KB hi+lo) is streamed slice by slice
//    by cp.async.bulk into an 8-stage ring of 8 KB, with full and empty
//    mbarriers; every consumer reads every stage, so the weights cross L2
//    once per 192 rows.
//  - Layer 2's B operand (W2^T, 128 KB hi+lo) stays in shared memory for
//    the block's life.  Its A operand is layer 1's accumulator (bias, ReLU,
//    split) straight from registers: a thread holds columns 2t, 2t+1 of
//    each 8-column group and the A fragment wants t, t+4, so W2^T's K
//    axis is permuted within each group of 8 (0 2 4 6 1 3 5 7) instead.
//    It runs in two halves of 64 columns, to stay within 160 registers.
//  - Layer 3 (128 -> 3) and the sigmoid run in the epilogue on the CUDA
//    cores from layer 2's accumulators: 32 columns per thread, reduced
//    over the 4 threads that share a row with shuffles; 12 B written per
//    row.
// Both modes are one body (shade_tiles), compiled once per mode: the
// noview kernel keeps its code, the view mode adds the direction's
// staging and a select per value read.
// What holds it above the bound: the consumers' own work per step (the PE,
// the splits, the barrier and wgmma bookkeeping) is not fully hidden
// behind the tensor cores.  The build uses no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace t2n;

constexpr int kFeat = 128;                          // hidden width (TensoRFConfig.feature_c)
constexpr int kConsumerWGs = 3;                     // consumer warpgroups, 64 rows each
constexpr int kTileRows = 64 * kConsumerWGs;        // rows per tile
constexpr int kThreads = 128 * (1 + kConsumerWGs);  // and a producer warpgroup
// registers a thread: 65536 / kThreads at launch (rounded down to 8); the
// producer gives back all but 24, the consumers share the rest
constexpr int kLaunchRegs = (65536 / kThreads) & ~7;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs =
    ((kThreads * kLaunchRegs - 128 * kProducerRegs) / (128 * kConsumerWGs)) & ~7;
static_assert(kConsumerRegs <= 256, "setmaxnreg takes at most 256");
constexpr int kStages = 8;                          // layer-1 weight ring
constexpr int kPartFloats = kFeat * 8;              // one K-slice of W^T, hi or lo: 4 KB
constexpr int kSliceBytes = 2 * kPartFloats * 4;    // hi and lo: 8 KB
constexpr int kSlices2 = kFeat / 8;                 // layer-2 K-slices
constexpr int kW2Bytes = kSlices2 * kSliceBytes;    // 128 KB, resident
constexpr int kParFloats = 2 * kFeat + 3 * kFeat + 4;  // b1, b2, w3, b3 (+pad)
constexpr uint32_t kLbo = 128;  // K-adjacent core matrices
constexpr uint32_t kSbo = 256;  // 8-row groups

// |x| up to which sincos_fast's reduction is exact enough (as sincosf's
// own fast path); past it a row falls back to sincosf
constexpr float kFastTrigMax = 105615.0f;

// sin and cos of x within 1.5 ulp, without a branch: x - j*pi/2 in three
// FMA steps with pi/2 split into C1 + C2 + C3 (j*C1 is exact), then
// Taylor polynomials on [-pi/4, pi/4] (to 1/9! and 1/10!: truncation
// below 3e-9) and the quadrant of j.  sincosf's slow-path branch would
// keep a warp from interleaving its rows' chains.
__device__ __forceinline__ void sincos_fast(float x, float& s, float& c) {
  // j = x * 2/pi rounded to an integer by the 1.5 * 2^23 shift, which also
  // leaves j mod 4 in the low bits
  const float shifted = fmaf(x, 0.636619772f, 12582912.0f);
  const float j = shifted - 12582912.0f;
  float r = fmaf(j, -1.57079601287841796875f, x);
  r = fmaf(j, -3.13916473e-07f, r);
  r = fmaf(j, -5.39030253e-15f, r);
  const float r2 = r * r;
  float ps = fmaf(r2, 2.7557319e-6f, -1.9841270e-4f);
  ps = fmaf(ps, r2, 8.3333333e-3f);
  ps = fmaf(ps, r2, -1.6666667e-1f);
  const float sr = fmaf(ps * r2, r, r);
  float pc = fmaf(r2, -2.7557319e-7f, 2.4801587e-5f);
  pc = fmaf(pc, r2, -1.3888889e-3f);
  pc = fmaf(pc, r2, 4.1666668e-2f);
  pc = fmaf(pc, r2, -0.5f);
  const float cr = fmaf(pc, r2, 1.0f);
  // sin(x) = (sr, cr, -sr, -cr)[j mod 4], cos(x) = (cr, -sr, -cr, sr)[j mod 4]
  const int q = __float_as_int(shifted) & 3;
  const float a = (q & 1) ? cr : sr;
  const float b = (q & 1) ? sr : cr;
  s = (q & 2) ? -a : a;
  c = ((q + 1) & 2) ? -b : b;
}

// what pair q of the layer-1 operand holds: the sine and cosine of value
// `ch` of the row times `scale` = 2^band for q < the trig pairs (feature
// ch = q / f, band q % f, for q < c*f; then direction component
// ch = c + (q - c*f) / fv, band (q - c*f) % fv, for fv bands a
// component), else raw values ch = 2(q - trig pairs) and ch + 1 (zero
// past the row's values).  Built once per block into a table: no division
// or conversion per slice.
struct PeSlot {
  int ch;
  float scale;
  bool trig;
};

__device__ __forceinline__ float2 pe_slot_entry(int q, int f, int fv, int c) {
  const int cf = c * f, ntrig = cf + 3 * fv;
  const bool trig = q < ntrig;
  int ch = 2 * (q - ntrig), band = 0;
  if (q < cf) {
    ch = q / f;
    band = q - ch * f;
  } else if (trig) {
    const int j = (q - cf) / fv;
    ch = c + j;
    band = q - cf - j * fv;
  }
  const float scale = static_cast<float>(1 << band);  // exact
  return make_float2(__int_as_float(ch | (trig ? 1 << 16 : 0)), scale);
}

__device__ __forceinline__ PeSlot pe_slot(float2 e) {
  const int bits = __float_as_int(e.x);
  return {bits & 0xFFFF, e.y, (bits >> 16) != 0};
}

// value ch of a row: its c features `fr`, then (view mode) its ray's
// direction `dr`; zero past them
template <bool kView>
__device__ __forceinline__ float row_value(const float* fr, const float* dr, int ch, int c) {
  if constexpr (kView) {
    return ch < c ? fr[ch] : (ch < c + 3 ? dr[ch - c] : 0.0f);
  } else {
    return ch < c ? fr[ch] : 0.0f;
  }
}

// the two K slots a thread holds for one row (features `fr`, direction `dr`)
template <bool kView>
__device__ __forceinline__ void pe_row(const float* fr, const float* dr, const PeSlot& sl, int c,
                                       float& first, float& second) {
  const float v0 = row_value<kView>(fr, dr, sl.ch, c);
  const float v1 = sl.trig ? 0.0f : row_value<kView>(fr, dr, sl.ch + 1, c);
  float sn, cs;
  sincos_fast(v0 * sl.scale, sn, cs);
  first = sl.trig ? sn : v0;
  second = sl.trig ? cs : v1;
}

// sincosf for an argument past sincos_fast's range
template <bool kView>
__device__ __forceinline__ void pe_row_wide(const float* fr, const float* dr, const PeSlot& sl,
                                            int c, float& first, float& second) {
  if (sl.trig) {
    const float x = row_value<kView>(fr, dr, sl.ch, c) * sl.scale;
    if (fabsf(x) > kFastTrigMax) sincosf(x, &first, &second);
  }
}

// acc += A * B in 3xTF32 for one K-slice of N = 128 (acc[64]) or 64
// (acc[32]) columns (the caller fences and commits); A's hi and lo parts
// in `a` (a[0..3] hi, a[4..7] lo), B's hi part at `b`, its lo part
// kPartFloats after
template <int M>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[M], const uint32_t (&a)[8],
                                           const float* b) {
  const uint32_t hi[4] = {a[0], a[1], a[2], a[3]};
  const uint32_t lo[4] = {a[4], a[5], a[6], a[7]};
  const uint64_t b_hi = gmma_desc(b, kLbo, kSbo);
  const uint64_t b_lo = gmma_desc(b + kPartFloats, kLbo, kSbo);
  fence_operand(acc);
  if constexpr (M == 64) {
    wgmma_m64n128k8_tf32_rs(acc, lo, b_hi);
    wgmma_m64n128k8_tf32_rs(acc, hi, b_lo);
    wgmma_m64n128k8_tf32_rs(acc, hi, b_hi);
  } else {
    wgmma_m64n64k8_tf32_rs(acc, lo, b_hi);
    wgmma_m64n64k8_tf32_rs(acc, hi, b_lo);
    wgmma_m64n64k8_tf32_rs(acc, hi, b_hi);
  }
  fence_operand(acc);
}

__device__ __forceinline__ void split4(float x0, float x1, float x2, float x3, uint32_t (&a)[8]) {
  tf32_split(x0, a[0], a[4]);
  tf32_split(x1, a[1], a[5]);
  tf32_split(x2, a[2], a[6]);
  tf32_split(x3, a[3], a[7]);
}

// layers 2 and 3 and the sigmoid of a warpgroup's 64 rows from their
// layer-1 accumulator; the thread writes rows `row` (t = 0) and `row` + 8
// (t = 1).  Layer 2 runs in two halves of 64 columns, so only 32 of its
// accumulators are live beside layer 1's 64.
__device__ __forceinline__ void head_tail(float (&acc)[64], const float* w2s, const float* sb1,
                                          const float* sb2, const float* sw3, const float* sb3,
                                          int t, int64_t row, int n, float* out) {
  float s[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  uint32_t a[2][8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float acc2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kSlices2; ++j) {
      const float bx = sb1[8 * j + 2 * t], by = sb1[8 * j + 2 * t + 1];
      // K slot t <- hidden column 8j+2t, slot t+4 <- 8j+2t+1
      split4(fmaxf(acc[4 * j] + bx, 0.0f), fmaxf(acc[4 * j + 2] + bx, 0.0f),
             fmaxf(acc[4 * j + 1] + by, 0.0f), fmaxf(acc[4 * j + 3] + by, 0.0f), a[j & 1]);
      wgmma_fence();
      // N rows 64*half.. of W2^T: 8 core-matrix groups of 256 B further
      mma_3xtf32(acc2, a[j & 1], w2s + j * (2 * kPartFloats) + half * (kPartFloats / 2));
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_operand(acc2);
    // layer 3 over this half's columns: 16 of this thread's per row
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int col = 64 * half + 8 * j + 2 * t + (v & 1);
        const float h = fmaxf(acc2[4 * j + v] + sb2[col], 0.0f);
#pragma unroll
        for (int o = 0; o < 3; ++o) s[v >> 1][o] = fmaf(h, sw3[col * 3 + o], s[v >> 1][o]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      s[r][o] += __shfl_xor_sync(0xffffffffu, s[r][o], 1);
      s[r][o] += __shfl_xor_sync(0xffffffffu, s[r][o], 2);
    }
  }
  if (t < 2 && row + 8 * t < n) {
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float z = (t == 0 ? s[0][o] : s[1][o]) + sb3[o];
      out[(row + 8 * t) * 3 + o] = 1.0f / (1.0f + expf(-z));
    }
  }
}

// The head over all tiles of the rows (the kernels' one body): features
// (n, c); in the view mode the directions of the rays (n / k, 3), and k
// rows a ray.
template <bool kView>
__device__ __forceinline__ void shade_tiles(
    const float* __restrict__ feat, const float* __restrict__ dirs, int n, int c, int k,
    int f, int fv, int kk1, const float* __restrict__ w1img,
    const float* __restrict__ w2img, const float* __restrict__ b1,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* w2s = reinterpret_cast<float*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kW2Bytes);
  float* fbuf = reinterpret_cast<float*>(smem + kW2Bytes + kStages * kSliceBytes);
  float* dbuf = fbuf + kTileRows * c;  // view mode: a tile's rows' directions
  float* par = dbuf + (kView ? kTileRows * 3 : 0);
  const float* sb1 = par;
  const float* sb2 = par + kFeat;
  const float* sw3 = par + 2 * kFeat;
  const float* sb3 = par + 5 * kFeat;
  uint64_t* full = reinterpret_cast<uint64_t*>(par + kParFloats);
  uint64_t* empty = full + kStages;
  uint64_t* w2bar = empty + kStages;
  float2* slots = reinterpret_cast<float2*>(w2bar + 1);  // [4 * kk1]

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWGs);  // one arrival per consumer warpgroup
    }
    mbar_init(w2bar, 1);
    fence_mbar_init();
  }
  for (int i = tid; i < kParFloats; i += kThreads) {
    float v = 0.0f;
    if (i < kFeat) v = b1[i];
    else if (i < 2 * kFeat) v = b2[i - kFeat];
    else if (i < 5 * kFeat) v = w3[i - 2 * kFeat];
    else if (i < 5 * kFeat + 3) v = b3[i - 5 * kFeat];
    par[i] = v;
  }
  for (int q = tid; q < 4 * kk1; q += kThreads) slots[q] = pe_slot_entry(q, f, fv, c);
  __syncthreads();

  const int64_t ntiles = (static_cast<int64_t>(n) + kTileRows - 1) / kTileRows;
  const int64_t my_tiles =
      blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t total = static_cast<uint32_t>(my_tiles * kk1);  // layer-1 slices

  if (tid < 128) {  // ---- producer warpgroup: thread 0 streams the weights
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_arrive_expect_tx(w2bar, kW2Bytes);
      for (int j = 0; j < kW2Bytes / 16384; ++j) {
        bulk_g2s(reinterpret_cast<unsigned char*>(w2s) + j * 16384,
                 reinterpret_cast<const unsigned char*>(w2img) + j * 16384, 16384, w2bar);
      }
      // slice qq of the block's sequence (kk = qq % kk1) into stage
      // qq % kStages, once both consumers are done with its previous slice
      for (uint32_t qq = 0; qq < total; ++qq) {
        const uint32_t s = qq % kStages;
        if (qq >= kStages) mbar_wait(&empty[s], (qq / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], kSliceBytes);
        bulk_g2s(reinterpret_cast<unsigned char*>(ring) + s * kSliceBytes,
                 reinterpret_cast<const unsigned char*>(w1img) +
                     static_cast<int64_t>(qq % kk1) * kSliceBytes,
                 kSliceBytes, &full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = (tid >> 7) - 1, ct = tid & 127;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + (ct >> 5) * 16 + g;  // the thread's rows: r0 and r0 + 8
  const int64_t n_elems = static_cast<int64_t>(n) * c;

  // the warpgroup's rows of a tile's features -> fbuf (view mode: their
  // rays' directions -> dbuf), zero past n
  auto prefetch = [&](int64_t tile) {
    const int64_t base = (tile * kTileRows + wg * 64) * c;
    float* dst = fbuf + wg * 64 * c;
    for (int i = ct; i < 64 * c; i += 128) {
      const int64_t e = base + i;
      const bool ok = e < n_elems;
      cp_async4(dst + i, feat + (ok ? e : 0), ok ? 4u : 0u);
    }
    if constexpr (kView) {
      const int64_t row0 = tile * kTileRows + wg * 64;
      float* ddst = dbuf + wg * 64 * 3;
      for (int i = ct; i < 64 * 3; i += 128) {
        const int r = i / 3;
        const bool ok = row0 + r < n;
        const int64_t ray = ok ? static_cast<int>(row0 + r) / k : 0;  // rows < 2^31
        cp_async4(ddst + i, dirs + ray * 3 + (i - 3 * r), ok ? 4u : 0u);
      }
    }
    cp_async_commit();
  };

  uint32_t q = 0;  // layer-1 slices this warpgroup has consumed
  // the warpgroup is done with slice qq (wgmma.wait_group has completed its
  // reads of the stage)
  auto release = [&](uint32_t qq) {
    if (ct == 0) mbar_arrive(&empty[qq % kStages]);
  };
  auto ready = [&](uint32_t qq) { return mbar_test(&full[qq % kStages], (qq / kStages) & 1); };
  auto wait_ready = [&](uint32_t qq) { mbar_wait(&full[qq % kStages], (qq / kStages) & 1); };

  int64_t tile = blockIdx.x;
  if (tile < ntiles) prefetch(tile);
  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    cp_async_wait_all();
    named_barrier(1 + wg, 128);  // the warpgroup's rows of this tile are staged
    const float* fa = fbuf + r0 * c;
    const float* fb = fa + 8 * c;
    const float* da = dbuf + r0 * 3;  // read in the view mode only
    const float* db = da + 8 * 3;

    // layer 1: acc = x W1, two K-slices a step; a step's fragments (four
    // sine-cosine chains that interleave) are computed while the tensor
    // cores run the step before it
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    auto fragment = [&](int kk, uint32_t(&fr)[8]) {
      const PeSlot sl = pe_slot(slots[4 * kk + t]);
      float x0, x1, x2, x3;  // rows r0, r0 + 8 of the first slot; then the second
      pe_row<kView>(fa, da, sl, c, x0, x2);
      pe_row<kView>(fb, db, sl, c, x1, x3);
      pe_row_wide<kView>(fa, da, sl, c, x0, x2);
      pe_row_wide<kView>(fb, db, sl, c, x1, x3);
      split4(x0, x1, x2, x3, fr);
    };
    auto step = [&](int kk, uint32_t(&fr)[2][8]) {
      const bool two = kk + 1 < kk1;
      // the stages are usually filled by now: test before the fragments,
      // wait after them only if not
      const bool have = ready(q) && (!two || ready(q + 1));
      fragment(kk, fr[0]);
      if (two) fragment(kk + 1, fr[1]);
      if (!have) {
        wait_ready(q);
        if (two) wait_ready(q + 1);
      }
      wgmma_fence();
      mma_3xtf32(acc, fr[0], ring + (q % kStages) * (2 * kPartFloats));
      if (two) mma_3xtf32(acc, fr[1], ring + ((q + 1) % kStages) * (2 * kPartFloats));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done
      if (kk > 0) {     // every step but the last has two slices
        release(q - 2);
        release(q - 1);
      }
      q += two ? 2 : 1;
    };
    uint32_t a[2][2][8];  // [register set][slice of the step]
    for (int kk = 0; kk < kk1; kk += 4) {
      step(kk, a[0]);
      if (kk + 2 < kk1) step(kk + 2, a[1]);
    }
    wgmma_wait<0>();
    fence_operand(acc);
    release(q - 1);  // the last step's slices
    if (kk1 % 2 == 0) release(q - 2);
    // every thread of the warpgroup is done with the features: stage the
    // next tile's behind layers 2 and 3
    named_barrier(1 + wg, 128);
    if (tile + gridDim.x < ntiles) prefetch(tile + gridDim.x);

    if (it == 0) mbar_wait(w2bar, 0);
    head_tail(acc, w2s, sb1, sb2, sw3, sb3, t, tile * kTileRows + r0, n, out);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
shade_kernel(const float* __restrict__ feat, int n, int c, int f, int kk1,
             const float* __restrict__ w1img, const float* __restrict__ w2img,
             const float* __restrict__ b1, const float* __restrict__ b2,
             const float* __restrict__ w3, const float* __restrict__ b3,
             float* __restrict__ out) {
  shade_tiles<false>(feat, nullptr, n, c, 1, f, 0, kk1, w1img, w2img, b1, b2, w3, b3, out);
}

__global__ void __launch_bounds__(kThreads, 1)
shade_view_kernel(const float* __restrict__ feat, const float* __restrict__ dirs, int n, int c,
                  int k, int f, int fv, int kk1,
                  const float* __restrict__ w1img, const float* __restrict__ w2img,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  float* __restrict__ out) {
  shade_tiles<true>(feat, dirs, n, c, k, f, fv, kk1, w1img, w2img, b1, b2, w3, b3, out);
}

// shared memory of a launch: W2^T, the ring, a tile's features (and
// directions), the parameters, the barriers and the pair table
size_t shade_smem(int c, int kk1, bool view) {
  return static_cast<size_t>(kW2Bytes) + kStages * kSliceBytes +
         static_cast<size_t>(kTileRows) * (c + (view ? 3 : 0)) * 4 + kParFloats * 4 +
         (2 * kStages + 1) * 8 + 4 * static_cast<size_t>(kk1) * 8;
}

// launches `kernel` on one persistent block per SM (at most one per tile)
template <typename... P, typename... A>
int launch_shade(void (*kernel)(P...), size_t smem, int n, void* stream, A... args) {
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  // the register split assumes the launch count; a block that got fewer
  // would wait in setmaxnreg.inc for registers that never come
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (attr.numRegs != kLaunchRegs) return static_cast<int>(cudaErrorInvalidConfiguration);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t ntiles = (static_cast<int64_t>(n) + kTileRows - 1) / kTileRows;
  const unsigned blocks = static_cast<unsigned>(ntiles < sms ? ntiles : sms);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat (n, c) fp32; w1img (kk1, 2, 1024) and w2img (16, 2, 1024): W1^T and
// W2^T as the wrapper lays them out (K-permuted core-matrix images, hi
// then lo per K-slice); b1 (128), b2 (128), w3 (128, 3), b3 (3); out
// (n, 3).  Returns a cudaError_t: the launch's, or cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int t2n_shade_fea_noview(const float* feat, int n, int c, int f, int kk1,
                                    const float* w1img, const float* w2img,
                                    const float* b1, const float* b2,
                                    const float* w3, const float* b3,
                                    float* out, void* stream) {
  if (n <= 0 || c <= 0 || f <= 0 || f > 30 || 4 * kk1 < c * f + (c + 1) / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_shade(shade_kernel, shade_smem(c, kk1, false), n, stream, feat, n, c, f, kk1,
                      w1img, w2img, b1, b2, w3, b3, out);
}

// The MLP_Fea head: as t2n_shade_fea_noview, with dirs (n / k, 3) the
// rays' directions, row r taking ray r / k's; f feature bands and fv
// direction bands (either may be 0).
extern "C" int t2n_shade_fea(const float* feat, const float* dirs, int n, int c, int k,
                             int f, int fv, int kk1, const float* w1img, const float* w2img,
                             const float* b1, const float* b2,
                             const float* w3, const float* b3, float* out, void* stream) {
  if (n <= 0 || c <= 0 || k <= 0 || f < 0 || f > 30 || fv < 0 || fv > 30 ||
      4 * kk1 < c * f + 3 * fv + (c + 4) / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_shade(shade_view_kernel, shade_smem(c, kk1, true), n, stream, feat, dirs,
                      n, c, k, f, fv, kk1, w1img, w2img, b1, b2, w3, b3, out);
}
