// The composite kernels with each block's rows staged in shared memory by
// bulk copies: a measured variant of csrc/composite.cu, built on its own
// and timed by scripts/composite_ablations.py, on no path.  Same function,
// same arithmetic in the same order: the same bits.
//
// What differs from the kernels as built (for K <= 64; longer rays take the
// kernels as built):
// - a block's 8 rays are 8 consecutive rows of every input, so each input's
//   span for the block is one run of 32 K (densities, per-sample widths),
//   96 K (colours), 32 K C (extras), 32 (K + 1) (the weights' cotangent),
//   96 (the outputs' cotangent) or 32 bytes (per-ray widths, the alphas'
//   cotangent): all multiples of 16 bytes, at 16-byte aligned offsets.  One
//   thread issues one cp.async.bulk per span on one mbarrier, and every
//   warp waits once, then reads its ray from shared memory;
// - the forward writes the weights into shared memory and the block's
//   8 (K + 1) weights go back as one bulk copy: rows of K + 1 = 33 floats
//   start off 16-byte boundaries, the block's span does not;
// - a part-full last block loads and stores with plain instructions;
// - the widths' stride stays a flag read at run time (P is ignored).
#define nerf_composite_forward nerf_composite_registers_forward
#define nerf_composite_backward nerf_composite_registers_backward
#include "../composite.cu"
#undef nerf_composite_forward
#undef nerf_composite_backward
#include "../sm90.cuh"

namespace nerf {

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// One span of a block: `count` floats from `src` into `dst`, by one bulk
// copy (full blocks; thread 0 only) or by every thread (a part-full block).
__device__ __forceinline__ void stage(float* dst, const float* src, int count, bool bulk,
                                      uint64_t* bar) {
  if (bulk) {
    if (threadIdx.x == 0) bulk_load(dst, src, 4u * count, bar);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// The block's spans in shared memory, in floats; every offset is a
// multiple of 4.
struct BlockSpans {
  float *d, *delta, *rgb, *ex, *w, *go, *ga, *gex;
  __device__ BlockSpans(float* smem, int k, int c, bool per_sample) {
    d = smem;
    delta = d + kCompositeWarps * k;
    rgb = delta + (per_sample ? kCompositeWarps * k : kCompositeWarps);
    ex = rgb + kCompositeWarps * k * 3;
    w = ex + kCompositeWarps * k * c;
    go = w + kCompositeWarps * (k + 1);
    ga = go + kCompositeWarps * 3;
    gex = ga + kCompositeWarps;
  }
};

inline int bulk_smem_bytes(int k, int c, bool per_sample) {
  return 4 * (kCompositeWarps * k * (4 + c) + (per_sample ? kCompositeWarps * k : kCompositeWarps) +
              kCompositeWarps * (k + 1) + kCompositeWarps * (4 + c));
}

template <int E>
__device__ __forceinline__ Sample<E> smem_sample(const BlockSpans& sp, const CompositeInputs& in, int warp,
                                                 int t) {
  Sample<E> x;
  const bool inside = t < in.k;
  const int i = warp * in.k + t;
  x.density = inside ? sp.d[i] : 0.0f;
  x.delta = in.per_sample ? (inside ? sp.delta[i] : 0.0f) : sp.delta[warp];
#pragma unroll
  for (int c = 0; c < 3; ++c) x.rgb[c] = inside ? sp.rgb[i * 3 + c] : 0.0f;
#pragma unroll
  for (int j = 0; j < E; ++j) x.extra[j] = inside && j < in.c ? sp.ex[i * in.c + j] : 0.0f;
  return x;
}

// Stage the block's input spans; every thread returns once they landed.
__device__ __forceinline__ void stage_inputs(const BlockSpans& sp, const CompositeInputs& in, int ray0,
                                             int rays, uint64_t* bar, uint32_t extra_bytes) {
  const int k = in.k, c = in.c;
  const bool bulk = rays == kCompositeWarps;
  const long long first0 = static_cast<long long>(ray0) * k;
  const int nd = in.per_sample ? rays * k : rays;
  if (bulk && threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar, 4u * (kCompositeWarps * k * (4 + c) + nd) + extra_bytes);
  }
  stage(sp.d, in.densities + first0, rays * k, bulk, bar);
  stage(sp.delta, in.deltas + (in.per_sample ? first0 : ray0), nd, bulk, bar);
  stage(sp.rgb, in.rgbs + first0 * 3, rays * k * 3, bulk, bar);
  if (c > 0) stage(sp.ex, in.extras + first0 * c, rays * k * c, bulk, bar);
}

template <int S, int E>
__global__ void __launch_bounds__(kCompositeThreads)
    composite_bulk_forward_kernel(CompositeInputs in, float* __restrict__ outputs,
                                  float* __restrict__ weights, float* __restrict__ alphas,
                                  float* __restrict__ extras_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, k = in.k;
  const int ray0 = blockIdx.x * kCompositeWarps;
  const int rays = min(kCompositeWarps, in.n - ray0);
  const bool bulk = rays == kCompositeWarps;
  const BlockSpans sp(smem, k, in.c, in.per_sample);
  stage_inputs(sp, in, ray0, rays, &bar, 0);
  __syncthreads();  // the barrier is initialised (or the plain loads landed)
  if (bulk) mbar_wait(&bar, 0);

  if (warp < rays) {
    const int ray = ray0 + warp;
    float* w_row = sp.w + warp * (k + 1);
    const bool hit = __ldg(in.mask + ray) != 0;
    float carry = 0.0f, fg[3] = {0.0f, 0.0f, 0.0f}, ex[E > 0 ? E : 1] = {};
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int t = lane + 32 * i;
      const Sample<E> x = smem_sample<E>(sp, in, warp, t);
      const ScanStep r = scan_step(x.density, x.delta, carry, lane);
      if (t < k) w_row[t] = r.w;
#pragma unroll
      for (int c = 0; c < 3; ++c) fg[c] += r.w * x.rgb[c];
#pragma unroll
      for (int j = 0; j < E; ++j) ex[j] += r.w * x.extra[j];
    }
    const float w_last = expf(-carry);
    float mine = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = warp_sum(fg[c]);
      if (lane == c) mine = hit ? v + w_last * __ldg(in.background + c) : __ldg(in.background + c);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j < in.c) {
        const float v = warp_sum(ex[j]);
        if (lane == 3 + j) mine = hit ? v : 0.0f;
      }
    }
    if (lane < 3) outputs[ray * 3ll + lane] = mine;
    if (lane >= 3 && lane < 3 + in.c) extras_out[static_cast<long long>(ray) * in.c + lane - 3] = mine;
    if (lane == 31) {
      w_row[k] = w_last;
      alphas[ray] = hit ? 1.0f - w_last : 0.0f;
    }
  }
  // The block's weights back as one span.
  fence_proxy_async();
  __syncthreads();
  float* dst = weights + static_cast<long long>(ray0) * (k + 1);
  if (bulk) {
    if (threadIdx.x == 0) bulk_store(dst, sp.w, 4u * kCompositeWarps * (k + 1));
  } else {
    for (int i = threadIdx.x; i < rays * (k + 1); i += blockDim.x) dst[i] = sp.w[i];
  }
}

template <int S, int E>
__global__ void __launch_bounds__(kCompositeThreads)
    composite_bulk_backward_kernel(CompositeInputs in, CompositeGrads g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, k = in.k, cn = in.c;
  const int ray0 = blockIdx.x * kCompositeWarps;
  const int rays = min(kCompositeWarps, in.n - ray0);
  const bool bulk = rays == kCompositeWarps;
  const BlockSpans sp(smem, k, cn, in.per_sample);
  const uint32_t extra_bytes =
      4u * kCompositeWarps *
      ((g.grad_weights != nullptr ? k + 1 : 0) + (g.grad_outputs != nullptr ? 3 : 0) +
       (g.grad_alphas != nullptr ? 1 : 0) + (g.grad_extras_out != nullptr ? cn : 0));
  stage_inputs(sp, in, ray0, rays, &bar, extra_bytes);
  if (g.grad_weights != nullptr) {
    stage(sp.w, g.grad_weights + static_cast<long long>(ray0) * (k + 1), rays * (k + 1), bulk, &bar);
  }
  if (g.grad_outputs != nullptr) stage(sp.go, g.grad_outputs + ray0 * 3ll, rays * 3, bulk, &bar);
  if (g.grad_alphas != nullptr) stage(sp.ga, g.grad_alphas + ray0, rays, bulk, &bar);
  if (g.grad_extras_out != nullptr) {
    stage(sp.gex, g.grad_extras_out + static_cast<long long>(ray0) * cn, rays * cn, bulk, &bar);
  }
  __syncthreads();
  if (bulk) mbar_wait(&bar, 0);

  float bg_part[3] = {0.0f, 0.0f, 0.0f};
  if (warp < rays) {
    const int ray = ray0 + warp;
    const long long first = static_cast<long long>(ray) * k;
    const bool hit = __ldg(in.mask + ray) != 0;
    const float* gw_row = g.grad_weights != nullptr ? sp.w + warp * (k + 1) : nullptr;
    float go[3], gex[E > 0 ? E : 1];
#pragma unroll
    for (int c = 0; c < 3; ++c) go[c] = g.grad_outputs != nullptr ? sp.go[warp * 3 + c] : 0.0f;
#pragma unroll
    for (int j = 0; j < E; ++j) gex[j] = g.grad_extras_out != nullptr && j < cn ? sp.gex[warp * cn + j] : 0.0f;
    float g_last = gw_row != nullptr ? gw_row[k] : 0.0f;
    if (hit) {
#pragma unroll
      for (int c = 0; c < 3; ++c) g_last += go[c] * __ldg(in.background + c);
      if (g.grad_alphas != nullptr) g_last -= sp.ga[warp];
    }
    Sample<E> x[S > 0 ? S : 1];  // S = 0 (K > 64) never launches here
    float w[S > 0 ? S : 1], t_next[S > 0 ? S : 1], carry = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      x[i] = smem_sample<E>(sp, in, warp, lane + 32 * i);
      const ScanStep r = scan_step(x[i].density, x[i].delta, carry, lane);
      w[i] = r.w;
      t_next[i] = expf(-r.incl);
    }
    const float w_last = expf(-carry);
    float suffix = g_last * w_last, dt_part = 0.0f;
#pragma unroll
    for (int i = S - 1; i >= 0; --i) {
      const int t = lane + 32 * i;
      float gt = 0.0f;
      if (t < k) {
        gt = gw_row != nullptr ? gw_row[t] : 0.0f;
        if (hit) {
#pragma unroll
          for (int c = 0; c < 3; ++c) gt += go[c] * x[i].rgb[c];
#pragma unroll
          for (int j = 0; j < E; ++j) gt += gex[j] * x[i].extra[j];
        }
      }
      const float inclusive = warp_suffix_sum(gt * w[i], lane);
      float after = __shfl_down_sync(kFullWarp, inclusive, 1);
      if (lane == 31) after = 0.0f;
      const float grad_s = gt * t_next[i] - (after + suffix);
      suffix += __shfl_sync(kFullWarp, inclusive, 0);
      if (t < k) {
        const long long idx = first + t;
        g.grad_densities[idx] = grad_s * x[i].delta;
        if (in.per_sample) {
          if (g.grad_deltas != nullptr) g.grad_deltas[idx] = grad_s * x[i].density;
        } else {
          dt_part += grad_s * x[i].density;
        }
        if (g.grad_rgbs != nullptr) {
#pragma unroll
          for (int c = 0; c < 3; ++c) g.grad_rgbs[idx * 3 + c] = hit ? w[i] * go[c] : 0.0f;
        }
        if (g.grad_extras != nullptr) {
#pragma unroll
          for (int j = 0; j < E; ++j) {
            if (j < cn) g.grad_extras[idx * cn + j] = hit ? w[i] * gex[j] : 0.0f;
          }
        }
      }
    }
    if (!in.per_sample && g.grad_deltas != nullptr) {
      dt_part = warp_sum(dt_part);
      if (lane == 0) g.grad_deltas[ray] = dt_part;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) bg_part[c] = hit ? w_last * go[c] : go[c];
  }
  if (g.grad_background != nullptr) sum_background(bg_part, g, warp, lane);
}

template <int S, int E, bool P>
struct LaunchBulkForward {
  static int run(CompositeInputs in, float* outputs, float* weights, float* alphas, float* extras_out,
                 cudaStream_t stream) {
    composite_bulk_forward_kernel<S, E>
        <<<composite_blocks(in.n), kCompositeThreads, bulk_smem_bytes(in.k, in.c, in.per_sample), stream>>>(
            in, outputs, weights, alphas, extras_out);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int S, int E, bool P>
struct LaunchBulkBackward {
  static int run(CompositeInputs in, CompositeGrads g, cudaStream_t stream) {
    composite_bulk_backward_kernel<S, E>
        <<<composite_blocks(in.n), kCompositeThreads, bulk_smem_bytes(in.k, in.c, in.per_sample), stream>>>(
            in, g);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace nerf

// csrc/composite.cu's entry points, with the bulk-staged kernels for
// K <= 64 (the kernels as built beyond).
extern "C" int nerf_composite_forward(const float* densities, const float* deltas, const float* rgbs,
                                      const float* background, const unsigned char* mask,
                                      const float* extras, int n, int k, int c,
                                      int per_sample_deltas, float* outputs, float* weights,
                                      float* alphas, float* extras_out, void* stream) {
  using namespace nerf;
  if (k > 64 || !composite_valid(n, k, c, extras) || n == 0) {
    return nerf_composite_registers_forward(densities, deltas, rgbs, background, mask, extras, n, k, c,
                                            per_sample_deltas, outputs, weights, alphas, extras_out,
                                            stream);
  }
  const CompositeInputs in{densities, deltas, rgbs, background, mask, extras, n, k, c,
                           per_sample_deltas != 0};
  return composite_dispatch<LaunchBulkForward>(k, c, false, in, outputs, weights, alphas, extras_out,
                                               static_cast<cudaStream_t>(stream));
}

extern "C" int nerf_composite_backward(
    const float* densities, const float* deltas, const float* rgbs, const float* background,
    const unsigned char* mask, const float* extras, const float* grad_outputs,
    const float* grad_weights, const float* grad_alphas, const float* grad_extras_out, int n, int k,
    int c, int per_sample_deltas, float* grad_densities, float* grad_deltas, float* grad_rgbs,
    float* grad_extras, float* background_partials, unsigned int* ticket, float* grad_background,
    void* stream) {
  using namespace nerf;
  if (k > 64 || !composite_valid(n, k, c, extras) || n == 0 || grad_densities == nullptr ||
      (grad_background != nullptr && (background_partials == nullptr || ticket == nullptr))) {
    return nerf_composite_registers_backward(
        densities, deltas, rgbs, background, mask, extras, grad_outputs, grad_weights, grad_alphas,
        grad_extras_out, n, k, c, per_sample_deltas, grad_densities, grad_deltas, grad_rgbs, grad_extras,
        background_partials, ticket, grad_background, stream);
  }
  const CompositeInputs in{densities, deltas, rgbs, background, mask, extras, n, k, c,
                           per_sample_deltas != 0};
  const CompositeGrads g{grad_outputs, grad_weights, grad_alphas, grad_extras_out,
                         grad_densities, grad_deltas, grad_rgbs, c > 0 ? grad_extras : nullptr,
                         background_partials, ticket, grad_background};
  return composite_dispatch<LaunchBulkBackward>(k, c, false, in, g, static_cast<cudaStream_t>(stream));
}
