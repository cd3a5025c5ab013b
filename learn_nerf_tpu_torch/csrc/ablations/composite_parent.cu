// A measured variant (scripts/composite_ablations.py, built on its own):
// the composite kernels as they were before csrc/composite.cu took any K,
// per-sample widths and extras, and summed the background's gradient in
// its last block.  Its entry points carry "_parent" in their names.
//
// The transmittance scan, the termination weights and the blend of the
// occupancy renderer, forward and backward, with a plain C interface for
// ctypes.
//
// composite_forward_kernel computes the JAX package's termination_weights +
// composite + composite_alpha (learn_nerf_tpu/ops/volume.py:41-93, called at
// learn_nerf_tpu/occ_render.py:217-221), which the JAX package leaves to
// XLA: for densities [N, K], one bin width dt [N] per ray, rgbs [N, K, 3],
// a background [3] and a mask [N],
//   s_t = density_t * dt,  T_t = exp(-sum_{j<t} s_j),
//   w_t = T_t * (1 - exp(-s_t)) for t < K,  w_K = T_K,
//   out = sum_t w_t rgb_t + w_K background   (the background on a masked ray),
//   alpha = 1 - w_K                          (0 on a masked ray),
// with weights [N, K+1] (rows sum to 1), out [N, 3] and alpha [N].
// composite_backward_kernel is its vector-Jacobian product for cotangents
// of all three outputs (a null pointer is a zero cotangent): with
//   G_t = dL/dw_t + dL/dout . rgb_t                  (t < K),
//   G_K = dL/dw_K + dL/dout . background - dL/dalpha (the last two on an
//         unmasked ray only),
//   dL/ds_t = G_t T_{t+1} - sum_{j>t} G_j w_j        (T_{t+1} = T_t - w_t),
// a reverse exclusive scan, then dL/ddensity_t = dL/ds_t dt, dL/ddt =
// sum_t dL/ds_t density_t, dL/drgb_t = w_t dL/dout and dL/dbackground =
// sum_n w_{n,K} dL/dout_n (dL/dout_n itself on a masked ray).
//
// What bounds it on an H100: bytes.  Each value is read once and each
// result written once (2.8 MB forward at 4096 rays x 32 samples, under a
// microsecond at 3.35 TB/s), against a dozen f32 operations and two
// exponentials per sample.  Design:
// - one warp per ray, lane t takes samples t and t + 32 (K <= 64): the
//   prefix sum and the reverse suffix sum are five shuffles each, and the
//   sums over a ray's samples five more; nothing goes through shared
//   memory but the background's gradient;
// - the backward recomputes the scan from the densities, so the forward
//   saves no transmittance, and reads weights from nowhere;
// - the background's gradient is summed over a block's 8 rays in shared
//   memory, then one atomic per channel and block into a zeroed [3].
// f32 throughout, expf at full precision (the library is built without
// fast math).
#include <cuda_runtime.h>

namespace nerf_parent {

constexpr int kCompositeThreads = 256;
constexpr int kCompositeWarps = kCompositeThreads / 32;
constexpr int kCompositeMaxSamples = 64;
constexpr unsigned int kFullWarp = 0xffffffffu;

__device__ __forceinline__ float warp_prefix_sum(float v, int lane) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const float u = __shfl_up_sync(kFullWarp, v, offset);
    if (lane >= offset) v += u;
  }
  return v;
}

__device__ __forceinline__ float warp_suffix_sum(float v, int lane) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const float u = __shfl_down_sync(kFullWarp, v, offset);
    if (lane + offset < 32) v += u;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFullWarp, v, offset);
  return v;
}

// One ray's scan in registers: lane `lane` holds samples lane + 32 s.
template <int S>
struct RayScan {
  float s[S];       // density * dt (0 past K)
  float w[S];       // termination weight
  float t_next[S];  // transmittance after the sample: T_{t+1}
  float w_last;     // background weight T_K
};

template <int S>
__device__ __forceinline__ RayScan<S> scan_ray(const float* __restrict__ density, float dt, int k,
                                               int lane) {
  RayScan<S> r;
  float carry = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int t = lane + 32 * i;
    r.s[i] = t < k ? __fmul_rn(density[t], dt) : 0.0f;
    const float inclusive = warp_prefix_sum(r.s[i], lane) + carry;
    float exclusive = __shfl_up_sync(kFullWarp, inclusive, 1);
    if (lane == 0) exclusive = carry;
    r.w[i] = expf(-exclusive) * (1.0f - expf(-r.s[i]));
    r.t_next[i] = expf(-inclusive);
    carry = __shfl_sync(kFullWarp, inclusive, 31);
  }
  r.w_last = expf(-carry);
  return r;
}

template <int S>
__global__ void __launch_bounds__(kCompositeThreads)
    composite_forward_kernel(const float* __restrict__ densities, const float* __restrict__ dt,
                             const float* __restrict__ rgbs, const float* __restrict__ background,
                             const unsigned char* __restrict__ mask, int n, int k,
                             float* __restrict__ outputs, float* __restrict__ weights,
                             float* __restrict__ alphas) {
  const int ray = blockIdx.x * kCompositeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ray >= n) return;  // a whole warp leaves together
  const RayScan<S> r = scan_ray<S>(densities + static_cast<long long>(ray) * k, dt[ray], k, lane);
  float fg[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int t = lane + 32 * i;
    if (t < k) {
      weights[static_cast<long long>(ray) * (k + 1) + t] = r.w[i];
      const float* rgb = rgbs + (static_cast<long long>(ray) * k + t) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) fg[c] += r.w[i] * rgb[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) fg[c] = warp_sum(fg[c]);
  if (lane == 0) {
    const bool hit = mask[ray] != 0;
    weights[static_cast<long long>(ray) * (k + 1) + k] = r.w_last;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      outputs[ray * 3ll + c] = hit ? fg[c] + r.w_last * background[c] : background[c];
    }
    alphas[ray] = hit ? 1.0f - r.w_last : 0.0f;
  }
}

template <int S>
__global__ void __launch_bounds__(kCompositeThreads)
    composite_backward_kernel(const float* __restrict__ densities, const float* __restrict__ dt,
                              const float* __restrict__ rgbs, const float* __restrict__ background,
                              const unsigned char* __restrict__ mask,
                              const float* __restrict__ grad_outputs,
                              const float* __restrict__ grad_weights,
                              const float* __restrict__ grad_alphas, int n, int k,
                              float* __restrict__ grad_densities, float* __restrict__ grad_dt,
                              float* __restrict__ grad_rgbs, float* __restrict__ grad_background) {
  __shared__ float block_bg[kCompositeWarps][3];
  const int warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kCompositeWarps + warp;
  const int lane = threadIdx.x & 31;
  float bg_part[3] = {0.0f, 0.0f, 0.0f};
  if (ray < n) {  // a whole warp together
    const float* density = densities + static_cast<long long>(ray) * k;
    const float ray_dt = dt[ray];
    const RayScan<S> r = scan_ray<S>(density, ray_dt, k, lane);
    const bool hit = mask[ray] != 0;
    float go[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) go[c] = grad_outputs != nullptr ? grad_outputs[ray * 3ll + c] : 0.0f;
    const float* gw = grad_weights != nullptr ? grad_weights + static_cast<long long>(ray) * (k + 1)
                                              : nullptr;
    // G_t of this lane's samples, and each sample's colour.
    float big_g[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int t = lane + 32 * i;
      big_g[i] = 0.0f;
      if (t < k) {
        if (gw != nullptr) big_g[i] = gw[t];
        if (hit) {
          const float* rgb = rgbs + (static_cast<long long>(ray) * k + t) * 3;
          big_g[i] += go[0] * rgb[0] + go[1] * rgb[1] + go[2] * rgb[2];
        }
      }
    }
    float g_last = gw != nullptr ? gw[k] : 0.0f;
    if (hit) {
      g_last += go[0] * background[0] + go[1] * background[1] + go[2] * background[2];
      if (grad_alphas != nullptr) g_last -= grad_alphas[ray];
    }
    // The reverse exclusive scan of G_j w_j, from the background column down.
    float carry = g_last * r.w_last;
    float dt_part = 0.0f;
#pragma unroll
    for (int i = S - 1; i >= 0; --i) {
      const int t = lane + 32 * i;
      const float inclusive = warp_suffix_sum(big_g[i] * r.w[i], lane);
      float after = __shfl_down_sync(kFullWarp, inclusive, 1);
      if (lane == 31) after = 0.0f;
      const float grad_s = big_g[i] * r.t_next[i] - (after + carry);
      carry += __shfl_sync(kFullWarp, inclusive, 0);
      if (t < k) {
        grad_densities[static_cast<long long>(ray) * k + t] = grad_s * ray_dt;
        dt_part += grad_s * density[t];
        float* grgb = grad_rgbs + (static_cast<long long>(ray) * k + t) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) grgb[c] = hit ? r.w[i] * go[c] : 0.0f;
      }
    }
    dt_part = warp_sum(dt_part);
    if (lane == 0) grad_dt[ray] = dt_part;
#pragma unroll
    for (int c = 0; c < 3; ++c) bg_part[c] = hit ? r.w_last * go[c] : go[c];
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) block_bg[warp][c] = bg_part[c];
  }
  __syncthreads();
  if (threadIdx.x < 3 && grad_outputs != nullptr) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kCompositeWarps; ++w) sum += block_bg[w][threadIdx.x];
    atomicAdd(grad_background + threadIdx.x, sum);
  }
}

inline int composite_blocks(int n) { return (n + kCompositeWarps - 1) / kCompositeWarps; }

}  // namespace nerf_parent

// densities [n, k], dt [n], rgbs [n, k, 3], background [3] f32 and mask [n]
// bytes (0 or 1) on the device; outputs [n, 3], weights [n, k + 1] and
// alphas [n] f32 are written.  1 <= k <= 64.  Launches on the given stream,
// does not synchronise, and returns the cudaError_t of the launch (0 on
// success).
extern "C" int nerf_composite_parent_forward(const float* densities, const float* dt, const float* rgbs,
                                      const float* background, const unsigned char* mask, int n,
                                      int k, float* outputs, float* weights, float* alphas,
                                      void* stream) {
  using namespace nerf_parent;
  if (n < 0 || k < 1 || k > kCompositeMaxSamples) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32) {
    composite_forward_kernel<1><<<composite_blocks(n), kCompositeThreads, 0, s>>>(
        densities, dt, rgbs, background, mask, n, k, outputs, weights, alphas);
  } else {
    composite_forward_kernel<2><<<composite_blocks(n), kCompositeThreads, 0, s>>>(
        densities, dt, rgbs, background, mask, n, k, outputs, weights, alphas);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs, then the cotangents grad_outputs [n, 3],
// grad_weights [n, k + 1] and grad_alphas [n] (each may be null: zero);
// grad_densities [n, k], grad_dt [n] and grad_rgbs [n, k, 3] are written,
// and grad_background [3] is added to: the caller zeroes it.
extern "C" int nerf_composite_parent_backward(const float* densities, const float* dt, const float* rgbs,
                                       const float* background, const unsigned char* mask,
                                       const float* grad_outputs, const float* grad_weights,
                                       const float* grad_alphas, int n, int k,
                                       float* grad_densities, float* grad_dt, float* grad_rgbs,
                                       float* grad_background, void* stream) {
  using namespace nerf_parent;
  if (n < 0 || k < 1 || k > kCompositeMaxSamples) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32) {
    composite_backward_kernel<1><<<composite_blocks(n), kCompositeThreads, 0, s>>>(
        densities, dt, rgbs, background, mask, grad_outputs, grad_weights, grad_alphas, n, k,
        grad_densities, grad_dt, grad_rgbs, grad_background);
  } else {
    composite_backward_kernel<2><<<composite_blocks(n), kCompositeThreads, 0, s>>>(
        densities, dt, rgbs, background, mask, grad_outputs, grad_weights, grad_alphas, n, k,
        grad_densities, grad_dt, grad_rgbs, grad_background);
  }
  return static_cast<int>(cudaGetLastError());
}
