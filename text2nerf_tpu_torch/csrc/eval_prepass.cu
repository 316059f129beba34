// The eval prepass: march, occupancy, first-K live selection and the
// escalation rung of the compacted eval renderer, one launch per chunk.
//
// Replaces no TPU kernel: the JAX package lowers this prepass to XLA ops
// (text2nerf_tpu/ops/render.py _render_rays_compact (:589) with
// first_k_live (:328) and _nearest_alpha_lookup (:313)), and the port's
// plain version (text2nerf_tpu_torch/ops/render.py _select_plain) is about
// 70 PyTorch launches per chunk with a radix sort among them, each
// reading or writing (B, n_samples) tensors.  Here one warp walks one ray.
//
// Per ray (rays (B, >= 6) [o | d], fp32):
//   t_min = clamp(max_c min((hi_c - o_c) / v_c, (lo_c - o_c) / v_c), near, far),
//           v_c = d_c, or 1e-6 where d_c == 0;
//   sample i < n_samples: z_i = t_min + step * i, p_i = o + d * z_i;
//   live_i = p_i in [lo, hi] and p_i.z > z_min and mask(p_j) > 0, j = i - i % stride
//           (every stride-th sample is tested and its result serves its group);
//   mask(p) = volume[iz][iy][ix], i_c = rint(((clamp(norm_m(p)_c, -1, 1) + 1) * 0.5) * (dim_c - 1))
//           with norm_m the mask box's normalize_coord;
//   the first k live indices in order, padded with n_samples - 1 (sel 0);
//   z_k, xn_k = clamp(normalize_coord(box, p), -1, 1) at each index;
//   n_live; and rung = the searchsorted-left of n_live in the ladder,
//   clipped to its top rung.
//
// Same arithmetic as the plain version, which evaluates each of these
// expressions op by op in PyTorch's elementwise kernels: every multiply,
// add and divide is a separately rounded __fmul_rn / __fadd_rn / __fdiv_rn
// (no FMA contraction), normalize_coord's 2 / size is 2 * (1 / size) as
// torch's reciprocal-then-multiply, rintf is torch.round (half to even),
// and min / max / clamp propagate NaN as torch's do.  So every output is
// bit for bit the plain version's.
//
// What bounds it on an H100: bytes and latency, not operations (~60 flops
// a sample).  A 16384-ray chunk at 259 samples and k 32 reads the rays
// (0.4 MB) and up to one mask value per sample (4.2M values; the 200^3
// mask is 32 MB in fp32 and sits in the 50 MB L2, and neighbouring samples
// of a ray mostly read one voxel) and writes 21 B per selected slot
// (11 MB).  The warp's steps are serial only through the running live
// count; the mask reads of a step are independent loads, and the warps
// resident on an SM keep enough of them in flight.
//
// Design.  A block of 8 warps, a warp per ray; the ray streams its
// samples 32 at a time, a lane per sample.  Dead samples (outside the box,
// behind z_min) read no mask.  The step's live lanes are compacted with
// __ballot_sync and __popc prefix counts: lane l writes position count +
// popc(ballot & lanes below l) while that is under k, so idx, sel and z
// land contiguously; the step's xn triples go through 384 B of shared
// memory per warp and out as contiguous floats.  The walk runs to the end
// of the ray whatever k (n_live counts every live sample); the pad slots
// are written after it.  The ladder (at most kMaxRungs rungs) and the
// scalar settings are kernel arguments; the box, the mask's box and the
// step are read from device memory, so a chunk's prepass copies nothing
// between host and device and never waits for the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRungs = 16;
constexpr unsigned kFull = 0xffffffffu;

struct Ladder {
  int n;
  int k[kMaxRungs];
};

struct Mask {
  const float* volume;  // [z][y][x]
  int d, h, w;
  const float* box;  // (2, 3)
};

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// normalize_coord(box, p) along one axis, clamped to [-1, 1]:
// ((p - lo) * inv) - 1 with inv = 2 * (1 / (hi - lo))
__device__ __forceinline__ float norm_axis(float p, float lo, float inv) {
  return clamp_nan(__fsub_rn(__fmul_rn(__fsub_rn(p, lo), inv), 1.0f), -1.0f, 1.0f);
}

__device__ __forceinline__ float inv_size(float lo, float hi) {
  return __fmul_rn(__fdiv_rn(1.0f, __fsub_rn(hi, lo)), 2.0f);
}

// the nearest voxel of one axis: round(((x + 1) * 0.5) * (dim - 1))
__device__ __forceinline__ int64_t voxel(float x, int dim) {
  return static_cast<int64_t>(
      rintf(__fmul_rn(__fmul_rn(__fadd_rn(x, 1.0f), 0.5f), static_cast<float>(dim - 1))));
}

__device__ __forceinline__ bool occupied(const Mask& m, const float (&mlo)[3],
                                         const float (&minv)[3], float x, float y, float z) {
  const int64_t ix = voxel(norm_axis(x, mlo[0], minv[0]), m.w);
  const int64_t iy = voxel(norm_axis(y, mlo[1], minv[1]), m.h);
  const int64_t iz = voxel(norm_axis(z, mlo[2], minv[2]), m.d);
  return __ldg(m.volume + ((iz * m.h + iy) * m.w + ix)) > 0.0f;
}

// torch.searchsorted(ladder, value) (left), as its binary search runs
__device__ __forceinline__ int lower_bound(const Ladder& l, int value) {
  int start = 0, end = l.n;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(l.k[mid] >= value)) {
      start = mid + 1;
    } else {
      end = mid;
    }
  }
  return start;
}

__global__ void __launch_bounds__(kThreads)
    eval_prepass_kernel(const float* __restrict__ rays, int n_rays, int ray_stride, int n,
                        int k, const float* __restrict__ box, const float* __restrict__ step_p,
                        float near, float far, float z_min, Mask mask, int stride,
                        Ladder ladder, int* __restrict__ idx, uint8_t* __restrict__ sel,
                        float* __restrict__ z_k, float* __restrict__ xn_k,
                        long long* __restrict__ n_live, int8_t* __restrict__ rung) {
  __shared__ float stage[kWarps][96];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= n_rays) return;

  const float* ray = rays + static_cast<int64_t>(r) * ray_stride;
  float o[3], d[3], lo[3], hi[3], inv[3], mlo[3], minv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = __ldg(ray + c);
    d[c] = __ldg(ray + 3 + c);
    lo[c] = __ldg(box + c);
    hi[c] = __ldg(box + 3 + c);
    inv[c] = inv_size(lo[c], hi[c]);
    mlo[c] = __ldg(mask.box + c);
    minv[c] = inv_size(mlo[c], __ldg(mask.box + 3 + c));
  }
  const float step = __ldg(step_p);

  // the slab entry (ops/rays.py aabb_slab_entry)
  float t_min = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = d[c] == 0.0f ? 1e-6f : d[c];
    const float ra = __fdiv_rn(__fsub_rn(hi[c], o[c]), v);
    const float rb = __fdiv_rn(__fsub_rn(lo[c], o[c]), v);
    const float m = min_nan(ra, rb);
    t_min = c == 0 ? m : max_nan(t_min, m);
  }
  t_min = clamp_nan(t_min, near, far);

  const int64_t row = static_cast<int64_t>(r) * k;
  float* st = stage[warp];
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const float z = __fadd_rn(t_min, __fmul_rn(step, static_cast<float>(i)));
    float p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = __fadd_rn(o[c], __fmul_rn(d[c], z));
    bool live = i < n && p[2] > z_min;
#pragma unroll
    for (int c = 0; c < 3; ++c) live = live && p[c] >= lo[c] && p[c] <= hi[c];
    if (live) {
      if (stride == 1) {
        live = occupied(mask, mlo, minv, p[0], p[1], p[2]);
      } else {
        const float zj = __fadd_rn(t_min, __fmul_rn(step, static_cast<float>(i - i % stride)));
        live = occupied(mask, mlo, minv, __fadd_rn(o[0], __fmul_rn(d[0], zj)),
                           __fadd_rn(o[1], __fmul_rn(d[1], zj)),
                           __fadd_rn(o[2], __fmul_rn(d[2], zj)));
      }
    }
    const unsigned ballot = __ballot_sync(kFull, live);
    if (count < k) {
      const int before = __popc(ballot & ((1u << lane) - 1u));
      const int pos = count + before;
      if (live && pos < k) {
        idx[row + pos] = i;
        sel[row + pos] = 1;
        z_k[row + pos] = z;
#pragma unroll
        for (int c = 0; c < 3; ++c) st[3 * before + c] = norm_axis(p[c], lo[c], inv[c]);
      }
      __syncwarp();
      const int m = min(__popc(ballot), k - count);
      float* out = xn_k + 3 * (row + count);
      for (int t = lane; t < 3 * m; t += 32) out[t] = st[t];
      __syncwarp();
    }
    count += __popc(ballot);
  }

  if (count < k) {
    // pad slots: the last sample's index, depth and point, not selected
    const float z = __fadd_rn(t_min, __fmul_rn(step, static_cast<float>(n - 1)));
    float x[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = norm_axis(__fadd_rn(o[c], __fmul_rn(d[c], z)), lo[c], inv[c]);
    }
    for (int s = count + lane; s < k; s += 32) {
      idx[row + s] = n - 1;
      sel[row + s] = 0;
      z_k[row + s] = z;
    }
    float* out = xn_k + 3 * (row + count);
    for (int t = lane; t < 3 * (k - count); t += 32) {
      const int c = t % 3;
      out[t] = c == 0 ? x[0] : (c == 1 ? x[1] : x[2]);
    }
  }
  if (lane == 0) {
    n_live[r] = count;
    if (ladder.n > 0) {
      const int b = lower_bound(ladder, count);
      rung[r] = static_cast<int8_t>(b < ladder.n - 1 ? b : ladder.n - 1);
    }
  }
}

}  // namespace

// rays (n_rays, ray_stride >= 6) fp32; box and mask_box (2, 3) fp32, step
// (a 0-d fp32) and volume (vd, vh, vw) fp32, all in device memory; ladder:
// n_ladder host ints (0 for none: rung is not written and may be null).  Outputs, all
// (n_rays, k) but n_live and rung (n_rays): idx int32, sel bytes 0/1, z_k
// fp32, xn_k (n_rays, k, 3) fp32, n_live int64, rung int8.  Returns a
// cudaError_t: the launch's, or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int t2n_eval_prepass(const float* rays, int n_rays, int ray_stride, int n_samples,
                                int k, const float* box, const float* step, float near,
                                float far, float z_min, const float* volume, int vd, int vh,
                                int vw, const float* mask_box, int occ_stride,
                                const int* ladder, int n_ladder, int* idx, uint8_t* sel,
                                float* z_k, float* xn_k, long long* n_live, int8_t* rung,
                                void* stream) {
  if (n_rays <= 0 || ray_stride < 6 || n_samples <= 0 || k <= 0 || k > n_samples ||
      occ_stride <= 0 || n_ladder < 0 || n_ladder > kMaxRungs || vd <= 0 || vh <= 0 ||
      vw <= 0 || (n_ladder > 0 && rung == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ladder l;
  l.n = n_ladder;
  for (int j = 0; j < kMaxRungs; ++j) l.k[j] = j < n_ladder ? ladder[j] : 0;
  const Mask m{volume, vd, vh, vw, mask_box};
  const unsigned blocks = static_cast<unsigned>((n_rays + kWarps - 1) / kWarps);
  eval_prepass_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, n_rays, ray_stride, n_samples, k, box, step, near, far, z_min, m, occ_stride, l, idx,
      sel, z_k, xn_k, n_live, rung);
  return static_cast<int>(cudaGetLastError());
}
