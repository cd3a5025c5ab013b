// The transmittance scan, the termination weights and the blends of both
// renderers, forward and backward, with a plain C interface for ctypes
// (learn_nerf_tpu_torch/kernels/build.py).
//
// composite_forward_kernel computes the JAX package's termination_weights +
// composite + composite_alpha + the coords blend + average_aux
// (learn_nerf_tpu/ops/volume.py:41-124, called at learn_nerf_tpu/render.py:
// 73-79 and learn_nerf_tpu/occ_render.py:217-222), which the JAX package
// leaves to XLA: for densities [N, K], bin widths delta (one per ray [N, 1],
// read with stride 0, or one per sample [N, K]), rgbs [N, K, 3], a
// background [3], a mask [N] and optional extras [N, K, C] (C <= 8: the
// sample points, then per-sample aux losses),
//   s_t = density_t * delta_t,  T_t = exp(-sum_{j<t} s_j),
//   w_t = T_t * (1 - exp(-s_t)) for t < K,  w_K = T_K,
//   out = sum_t w_t rgb_t + w_K background  (the background on a masked ray),
//   alpha = 1 - w_K                         (0 on a masked ray),
//   extras_out = sum_t w_t extra_t          (0 on a masked ray: the extras'
//                                            background is zero),
// with weights [N, K+1] (rows sum to 1), out [N, 3], alpha [N] and
// extras_out [N, C].
// composite_backward_kernel is its vector-Jacobian product for cotangents
// of all four outputs (a null pointer is a zero cotangent): with
//   G_t = dL/dw_t + dL/dout . rgb_t + dL/dextras_out . extra_t  (t < K; the
//         last two on an unmasked ray only),
//   G_K = dL/dw_K + dL/dout . background - dL/dalpha (the last two on an
//         unmasked ray only),
//   dL/ds_t = G_t T_{t+1} - sum_{j>t} G_j w_j        (T_{t+1} = T_t - w_t),
// a reverse exclusive scan, then dL/ddensity_t = dL/ds_t delta_t,
// dL/ddelta_t = dL/ds_t density_t (summed over the ray for [N, 1] widths),
// dL/drgb_t = w_t dL/dout, dL/dextra_t = w_t dL/dextras_out (0 on a masked
// ray) and dL/dbackground = sum_n w_{n,K} dL/dout_n (dL/dout_n itself on a
// masked ray).
//
// What bounds it on an H100: bytes (each value read once, each result
// written once: 2.8 MB forward at 4096 rays x 32 samples, under a
// microsecond at 3.35 TB/s, against a dozen f32 operations and two
// exponentials a sample), and at the train step's and a tile's shapes the
// latency of one wave: 512 blocks of 8 rays on 132 SMs.  Design:
// - one warp per ray, lane l takes samples l, l + 32, ...: the prefix sum
//   and the reverse suffix sum are five shuffles a chunk of 32 samples, the
//   sums over a ray's samples five more each;
// - one memory round trip a ray: every value a ray needs (densities,
//   widths, colours, extras, and in the backward the cotangents) is loaded
//   into registers before the first scan step; up to 64 samples (two a
//   lane) all at once, beyond that one chunk of 32 ahead of the scan;
// - any K: past 64 samples the forward carries the prefix from chunk to
//   chunk; the backward scans forward once (densities and widths only),
//   parking each sample's exclusive prefix in its own slot of
//   grad_densities, then walks the chunks backward with a carried suffix and
//   overwrites the slot with the gradient.  The weights it recomputes are
//   the forward's to the bit on both paths;
// - the backward recomputes the scan from the densities, so the forward
//   saves no transmittance;
// - the background's gradient: each block sums its 8 rays in a fixed order
//   into its own slot of a [blocks, 3] scratch (no memset), and the last
//   block to finish (a fence and a ticket counter that resets itself) sums
//   the slots in a fixed order: no atomics on one address, and the same
//   bits from run to run;
// - the widths' stride and the extras' capacity are template parameters:
//   a run-time flag cost registers, and past 32 registers the backward's
//   8,192-ray tiles take two waves.
// The pool layout (template parameter Q) serves the pooled passes, whose
// samples are packed ray-major into one [rows] pool (learn_nerf_tpu/
// occ_render.py:613-654: the segmented exclusive scan, the weights and the
// segment_sum blends): ray r owns rows starts[r] .. starts[r+1] - 1, at most
// k <= 64 of them in t order, and rows starts[n] .. rows - 1 are the pool's
// unused tail.  The same warp a ray and the same registers; the forward
// writes no weights, and the backward takes the cotangents of the outputs,
// alphas and extras only, writes the gradients in pool order and zeros on
// the tail itself (a grid-stride loop after the rays: nothing is zeroed
// before the launch), and sums the background's gradient as above.
// Each part was kept on a same-call measurement against its alternative
// (scripts/composite_ablations.py, which also builds the earlier kernels
// and the bulk-copy staging of csrc/ablations/, both slower).  f32
// throughout, expf at full precision (the library is built without fast
// math).
#include <cuda_runtime.h>

namespace nerf {

constexpr int kCompositeThreads = 256;
constexpr int kCompositeWarps = kCompositeThreads / 32;
constexpr int kCompositeMaxExtras = 8;
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

// The inputs both kernels read, by value.
struct CompositeInputs {
  const float* densities;   // [n, k]
  const float* deltas;      // [n, k] (per_sample) or [n, 1]
  const float* rgbs;        // [n, k, 3]
  const float* background;  // [3]
  const unsigned char* mask;  // [n]
  const float* extras;      // [n, k, c], or null when c == 0
  int n, k, c;
  bool per_sample;
  // The pool layout only (null otherwise): ray r's samples are pool rows
  // starts[r] .. starts[r+1] - 1 of `rows`.
  const int* starts;
  int rows;
};

// What one lane holds of one sample; E is the extras' capacity (C <= E).
// P (a template parameter of the kernels): the widths are per sample.
template <int E>
struct Sample {
  float density, delta, rgb[3], extra[E > 0 ? E : 1];
};

// Sample t of the ray whose first sample is row `first` (ray * k, or
// starts[ray] in the pool) of `count`; past the ray's end everything is 0
// but the width, so s = 0 there.
template <int E, bool P>
__device__ __forceinline__ Sample<E> load_sample(const CompositeInputs& in, long long first, int count,
                                                 int t, float ray_delta) {
  Sample<E> x;
  const bool inside = t < count;
  const long long i = first + t;
  x.density = inside ? __ldg(in.densities + i) : 0.0f;
  x.delta = P ? (inside ? __ldg(in.deltas + i) : 0.0f) : ray_delta;
#pragma unroll
  for (int c = 0; c < 3; ++c) x.rgb[c] = inside ? __ldg(in.rgbs + i * 3 + c) : 0.0f;
#pragma unroll
  for (int j = 0; j < E; ++j) x.extra[j] = inside && j < in.c ? __ldg(in.extras + i * in.c + j) : 0.0f;
  return x;
}

// One chunk's step of the forward scan: with `carry` the optical depth
// before the chunk, the sample's weight, its exclusive and inclusive
// prefixes; carry moves past the chunk.
struct ScanStep {
  float s, excl, incl, w;
};

__device__ __forceinline__ ScanStep scan_step(float density, float delta, float& carry, int lane) {
  ScanStep r;
  r.s = __fmul_rn(density, delta);
  r.incl = warp_prefix_sum(r.s, lane) + carry;
  r.excl = __shfl_up_sync(kFullWarp, r.incl, 1);
  if (lane == 0) r.excl = carry;
  r.w = expf(-r.excl) * (1.0f - expf(-r.s));
  carry = __shfl_sync(kFullWarp, r.incl, 31);
  return r;
}

// S > 0: K <= 32 S, every load of the ray issued before the first scan
// step; S == 0: any K, one chunk of 32 loaded ahead of the scan.
// The first row and the number of samples of `ray`.
template <bool Q>
__device__ __forceinline__ void ray_rows(const CompositeInputs& in, int ray, long long& first, int& count) {
  if constexpr (Q) {
    first = __ldg(in.starts + ray);
    count = __ldg(in.starts + ray + 1) - static_cast<int>(first);
  } else {
    first = static_cast<long long>(ray) * in.k;
    count = in.k;
  }
}

// Q: the pool layout (no weights written; P is false).
template <int S, int E, bool P, bool Q>
__global__ void __launch_bounds__(kCompositeThreads)
    composite_forward_kernel(CompositeInputs in, float* __restrict__ outputs,
                             float* __restrict__ weights, float* __restrict__ alphas,
                             float* __restrict__ extras_out) {
  const int ray = blockIdx.x * kCompositeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ray >= in.n) return;  // a whole warp leaves together
  long long first;
  int k;
  ray_rows<Q>(in, ray, first, k);
  float* w_row = Q ? nullptr : weights + static_cast<long long>(ray) * (k + 1);
  const float ray_delta = P ? 0.0f : __ldg(in.deltas + ray);
  const bool hit = __ldg(in.mask + ray) != 0;
  float carry = 0.0f, fg[3] = {0.0f, 0.0f, 0.0f}, ex[E > 0 ? E : 1] = {};

  auto step = [&](const Sample<E>& x, int t) {
    const ScanStep r = scan_step(x.density, x.delta, carry, lane);
    if (!Q && t < k) w_row[t] = r.w;
#pragma unroll
    for (int c = 0; c < 3; ++c) fg[c] += r.w * x.rgb[c];
#pragma unroll
    for (int j = 0; j < E; ++j) ex[j] += r.w * x.extra[j];
  };
  if constexpr (S > 0) {
    Sample<E> x[S];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = load_sample<E, P>(in, first, k, lane + 32 * i, ray_delta);
#pragma unroll
    for (int i = 0; i < S; ++i) step(x[i], lane + 32 * i);
  } else {
    Sample<E> cur = load_sample<E, P>(in, first, k, lane, ray_delta), next;
    for (int base = 0; base < k; base += 32) {
      if (base + 32 < k) next = load_sample<E, P>(in, first, k, base + 32 + lane, ray_delta);
      step(cur, base + lane);
      cur = next;
    }
  }

  const float w_last = expf(-carry);
  float mine = 0.0f;  // lane c < 3 writes out[c]; lane 3 + j writes extras_out[j]
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
    if (!Q) w_row[k] = w_last;
    alphas[ray] = hit ? 1.0f - w_last : 0.0f;
  }
}

// The cotangents (each may be null: zero) and the gradients the backward
// writes (each but grad_densities may be null: not wanted).
struct CompositeGrads {
  const float* grad_outputs;       // [n, 3]
  const float* grad_weights;       // [n, k + 1]
  const float* grad_alphas;        // [n]
  const float* grad_extras_out;    // [n, c]
  float* grad_densities;           // [n, k]; also the backward's scratch
  float* grad_deltas;              // like deltas
  float* grad_rgbs;                // [n, k, 3]
  float* grad_extras;              // [n, k, c]
  float* background_partials;      // [blocks, 3]
  unsigned int* ticket;            // [1], 0 between launches
  float* grad_background;          // [3]
};

// The background's gradient: each block's 8 rays in warp order into its
// slot of background_partials, then the last block to take a ticket sums
// the slots (thread t takes slots t, t + 256, ..., then the warps' sums in
// warp order: a fixed order) and resets the ticket.  Every thread of the
// block calls it.
__device__ __forceinline__ void sum_background(const float (&bg_part)[3], const CompositeGrads& g,
                                               int warp, int lane) {
  __shared__ float block_bg[kCompositeWarps][3];
  __shared__ bool last_block;
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) block_bg[warp][c] = bg_part[c];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kCompositeWarps; ++w) sum += block_bg[w][threadIdx.x];
    g.background_partials[blockIdx.x * 3ll + threadIdx.x] = sum;
    __threadfence();  // the slot is visible before this block takes its ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) last_block = atomicAdd(g.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;  // the same for the whole block
  __threadfence();
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kCompositeThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += __ldcg(g.background_partials + b * 3ll + c);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = warp_sum(acc[c]);
  if (lane == 0) {  // block_bg was read before the ticket's barriers
#pragma unroll
    for (int c = 0; c < 3; ++c) block_bg[warp][c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kCompositeWarps; ++w) sum += block_bg[w][threadIdx.x];
    g.grad_background[threadIdx.x] = sum;
  }
  if (threadIdx.x == 0) *g.ticket = 0u;  // ready for the next launch on this stream
}

// The pool's unused tail, rows starts[n] .. rows - 1, gets zero gradients:
// a grid-stride loop over each gradient's flat range (coalesced).
__device__ __forceinline__ void zero_pool_tail(const CompositeInputs& in, const CompositeGrads& g) {
  const long long tail = __ldg(in.starts + in.n);
  const long long stride = static_cast<long long>(gridDim.x) * kCompositeThreads;
  const long long start = static_cast<long long>(blockIdx.x) * kCompositeThreads + threadIdx.x;
  for (long long i = tail + start; i < in.rows; i += stride) g.grad_densities[i] = 0.0f;
  if (g.grad_rgbs != nullptr) {
    for (long long i = 3 * tail + start; i < 3ll * in.rows; i += stride) g.grad_rgbs[i] = 0.0f;
  }
  if (g.grad_extras != nullptr) {
    const long long c = in.c;
    for (long long i = c * tail + start; i < c * in.rows; i += stride) g.grad_extras[i] = 0.0f;
  }
}

template <int S, int E, bool P, bool Q>
__global__ void __launch_bounds__(kCompositeThreads)
    composite_backward_kernel(CompositeInputs in, CompositeGrads g) {
  const int warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kCompositeWarps + warp;
  const int lane = threadIdx.x & 31;
  float bg_part[3] = {0.0f, 0.0f, 0.0f};
  if (ray < in.n) {  // a whole warp together
    long long first;
    int k;
    ray_rows<Q>(in, ray, first, k);
    const float ray_delta = P ? 0.0f : __ldg(in.deltas + ray);
    const bool hit = __ldg(in.mask + ray) != 0;
    const float* gw_row = !Q && g.grad_weights != nullptr
                              ? g.grad_weights + static_cast<long long>(ray) * (k + 1)
                              : nullptr;
    float go[3], gex[E > 0 ? E : 1];
#pragma unroll
    for (int c = 0; c < 3; ++c) go[c] = g.grad_outputs != nullptr ? __ldg(g.grad_outputs + ray * 3ll + c) : 0.0f;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      gex[j] = g.grad_extras_out != nullptr && j < in.c
                   ? __ldg(g.grad_extras_out + static_cast<long long>(ray) * in.c + j)
                   : 0.0f;
    }
    float g_last = gw_row != nullptr ? __ldg(gw_row + k) : 0.0f;
    if (hit) {
#pragma unroll
      for (int c = 0; c < 3; ++c) g_last += go[c] * __ldg(in.background + c);
      if (g.grad_alphas != nullptr) g_last -= __ldg(g.grad_alphas + ray);
    }
    float dt_part = 0.0f;

    // G_t of a sample from its cotangent of w_t and its colour and extras.
    auto big_g = [&](const Sample<E>& x, float gw) {
      float v = gw;
      if (hit) {
#pragma unroll
        for (int c = 0; c < 3; ++c) v += go[c] * x.rgb[c];
#pragma unroll
        for (int j = 0; j < E; ++j) v += gex[j] * x.extra[j];
      }
      return v;
    };
    // One chunk of the reverse scan; `suffix` is sum_{j >= next chunk} G_j w_j.
    auto reverse_step = [&](const Sample<E>& x, float w, float t_next, float gw, int t, float& suffix) {
      const float gt = t < k ? big_g(x, gw) : 0.0f;
      const float inclusive = warp_suffix_sum(gt * w, lane);
      float after = __shfl_down_sync(kFullWarp, inclusive, 1);
      if (lane == 31) after = 0.0f;
      const float grad_s = gt * t_next - (after + suffix);
      suffix += __shfl_sync(kFullWarp, inclusive, 0);
      if (t < k) {
        const long long i = first + t;
        g.grad_densities[i] = grad_s * x.delta;
        if (P) {
          if (g.grad_deltas != nullptr) g.grad_deltas[i] = grad_s * x.density;
        } else if (!Q) {
          dt_part += grad_s * x.density;
        }
        if (g.grad_rgbs != nullptr) {
#pragma unroll
          for (int c = 0; c < 3; ++c) g.grad_rgbs[i * 3 + c] = hit ? w * go[c] : 0.0f;
        }
        if (g.grad_extras != nullptr) {
#pragma unroll
          for (int j = 0; j < E; ++j) {
            if (j < in.c) g.grad_extras[i * in.c + j] = hit ? w * gex[j] : 0.0f;
          }
        }
      }
    };

    float carry = 0.0f, w_last;
    if constexpr (S > 0) {
      Sample<E> x[S];
      float gw[S], w[S], t_next[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int t = lane + 32 * i;
        x[i] = load_sample<E, P>(in, first, k, t, ray_delta);
        gw[i] = gw_row != nullptr && t < k ? __ldg(gw_row + t) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const ScanStep r = scan_step(x[i].density, x[i].delta, carry, lane);
        w[i] = r.w;
        t_next[i] = expf(-r.incl);
      }
      w_last = expf(-carry);
      float suffix = g_last * w_last;
#pragma unroll
      for (int i = S - 1; i >= 0; --i) reverse_step(x[i], w[i], t_next[i], gw[i], lane + 32 * i, suffix);
    } else {
      // Forward over densities and widths only; each sample's exclusive
      // prefix waits in its own slot of grad_densities (the last chunk's in
      // registers), and the reverse walk reads it back from the same lane.
      const int chunks = (k + 31) / 32;
      float excl_last = 0.0f;
      for (int base = 0; base < k; base += 32) {
        const int t = base + lane;
        const float density = t < k ? __ldg(in.densities + first + t) : 0.0f;
        const float delta = P ? (t < k ? __ldg(in.deltas + first + t) : 0.0f) : ray_delta;
        const ScanStep r = scan_step(density, delta, carry, lane);
        if (base + 32 < k) {
          g.grad_densities[first + t] = r.excl;
        } else {
          excl_last = r.excl;
        }
      }
      w_last = expf(-carry);
      float suffix = g_last * w_last, next_excl = carry;
      for (int chunk = chunks - 1; chunk >= 0; --chunk) {
        const int t = 32 * chunk + lane;
        const Sample<E> x = load_sample<E, P>(in, first, k, t, ray_delta);
        const float gw = gw_row != nullptr && t < k ? __ldg(gw_row + t) : 0.0f;
        const float excl = chunk == chunks - 1 ? excl_last : g.grad_densities[first + t];
        float incl = __shfl_down_sync(kFullWarp, excl, 1);
        if (lane == 31) incl = next_excl;
        next_excl = __shfl_sync(kFullWarp, excl, 0);
        const float w = expf(-excl) * (1.0f - expf(-__fmul_rn(x.density, x.delta)));
        reverse_step(x, w, expf(-incl), gw, t, suffix);
      }
    }
    if (!P && !Q && g.grad_deltas != nullptr) {
      dt_part = warp_sum(dt_part);
      if (lane == 0) g.grad_deltas[ray] = dt_part;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) bg_part[c] = hit ? w_last * go[c] : go[c];
  }
  if constexpr (Q) zero_pool_tail(in, g);
  if (g.grad_background != nullptr) sum_background(bg_part, g, warp, lane);  // the same for every block
}

inline int composite_blocks(int n) { return (n + kCompositeWarps - 1) / kCompositeWarps; }

// Registers for up to 64 samples (S = 1, 2), else the chunk loop (S = 0);
// extras' capacity 0, 4 or 8; widths per ray or per sample.
template <template <int, int, bool, bool> class Launch, typename... Args>
int composite_dispatch(int k, int c, bool per_sample, Args... args) {
  const int s = k <= 32 ? 1 : (k <= 64 ? 2 : 0);
  const int e = c == 0 ? 0 : (c <= 4 ? 4 : 8);
#define NERF_COMPOSITE_CASE(S_, E_)                                                     \
  if (s == S_ && e == E_) {                                                             \
    return per_sample ? Launch<S_, E_, true, false>::run(args...)                       \
                      : Launch<S_, E_, false, false>::run(args...);                     \
  }
  NERF_COMPOSITE_CASE(1, 0) NERF_COMPOSITE_CASE(1, 4) NERF_COMPOSITE_CASE(1, 8)
  NERF_COMPOSITE_CASE(2, 0) NERF_COMPOSITE_CASE(2, 4) NERF_COMPOSITE_CASE(2, 8)
  NERF_COMPOSITE_CASE(0, 0) NERF_COMPOSITE_CASE(0, 4) NERF_COMPOSITE_CASE(0, 8)
#undef NERF_COMPOSITE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The pool layout: registers only (k <= 64), widths per ray.
template <template <int, int, bool, bool> class Launch, typename... Args>
int composite_pooled_dispatch(int k, int c, Args... args) {
  const int e = c == 0 ? 0 : (c <= 4 ? 4 : 8);
#define NERF_COMPOSITE_POOLED_CASE(E_)                                                  \
  if (e == E_) {                                                                        \
    return k <= 32 ? Launch<1, E_, false, true>::run(args...)                           \
                   : Launch<2, E_, false, true>::run(args...);                          \
  }
  NERF_COMPOSITE_POOLED_CASE(0) NERF_COMPOSITE_POOLED_CASE(4) NERF_COMPOSITE_POOLED_CASE(8)
#undef NERF_COMPOSITE_POOLED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int S, int E, bool P, bool Q>
struct LaunchForward {
  static int run(CompositeInputs in, float* outputs, float* weights, float* alphas, float* extras_out,
                 cudaStream_t stream) {
    composite_forward_kernel<S, E, P, Q><<<composite_blocks(in.n), kCompositeThreads, 0, stream>>>(
        in, outputs, weights, alphas, extras_out);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int S, int E, bool P, bool Q>
struct LaunchBackward {
  static int run(CompositeInputs in, CompositeGrads g, cudaStream_t stream) {
    composite_backward_kernel<S, E, P, Q><<<composite_blocks(in.n), kCompositeThreads, 0, stream>>>(in, g);
    return static_cast<int>(cudaGetLastError());
  }
};

inline bool composite_valid(int n, int k, int c, const float* extras) {
  return n >= 0 && k >= 1 && c >= 0 && c <= kCompositeMaxExtras && (c == 0) == (extras == nullptr);
}

}  // namespace nerf

// densities [n, k], deltas [n, k] (per_sample_deltas) or [n, 1], rgbs
// [n, k, 3], background [3], extras [n, k, c] (null when c = 0) f32 and mask
// [n] bytes (0 or 1) on the device; outputs [n, 3], weights [n, k + 1],
// alphas [n] and extras_out [n, c] f32 are written.  Any k >= 1, c <= 8.
// Launches on the given stream, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).
extern "C" int nerf_composite_forward(const float* densities, const float* deltas, const float* rgbs,
                                      const float* background, const unsigned char* mask,
                                      const float* extras, int n, int k, int c,
                                      int per_sample_deltas, float* outputs, float* weights,
                                      float* alphas, float* extras_out, void* stream) {
  using namespace nerf;
  if (!composite_valid(n, k, c, extras)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const CompositeInputs in{densities, deltas, rgbs, background, mask, extras, n, k, c,
                           per_sample_deltas != 0, nullptr, 0};
  return composite_dispatch<LaunchForward>(k, c, in.per_sample, in, outputs, weights, alphas, extras_out,
                                           static_cast<cudaStream_t>(stream));
}

// The forward's inputs, then the cotangents grad_outputs [n, 3],
// grad_weights [n, k + 1], grad_alphas [n] and grad_extras_out [n, c] (each
// may be null: zero); grad_densities [n, k] is written, and so are
// grad_deltas (deltas' shape), grad_rgbs [n, k, 3], grad_extras [n, k, c]
// and grad_background [3] unless null.  With grad_background,
// background_partials holds one float3 per block of 8 rays (uninitialised)
// and ticket is a counter that is 0 before the launch and after it; launches
// that share a ticket run one after another (one stream).
extern "C" int nerf_composite_backward(
    const float* densities, const float* deltas, const float* rgbs, const float* background,
    const unsigned char* mask, const float* extras, const float* grad_outputs,
    const float* grad_weights, const float* grad_alphas, const float* grad_extras_out, int n, int k,
    int c, int per_sample_deltas, float* grad_densities, float* grad_deltas, float* grad_rgbs,
    float* grad_extras, float* background_partials, unsigned int* ticket, float* grad_background,
    void* stream) {
  using namespace nerf;
  if (!composite_valid(n, k, c, extras) || grad_densities == nullptr ||
      (grad_background != nullptr && (background_partials == nullptr || ticket == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const CompositeInputs in{densities, deltas, rgbs, background, mask, extras, n, k, c,
                           per_sample_deltas != 0, nullptr, 0};
  const CompositeGrads g{grad_outputs, grad_weights, grad_alphas, grad_extras_out,
                         grad_densities, grad_deltas, grad_rgbs, c > 0 ? grad_extras : nullptr,
                         background_partials, ticket, grad_background};
  return composite_dispatch<LaunchBackward>(k, c, in.per_sample, in, g, static_cast<cudaStream_t>(stream));
}


// The pool layout.  densities [rows], rgbs [rows, 3] and extras [rows, c]
// (null when c = 0) f32, starts [n + 1] int32 (non-decreasing, starts[0] =
// 0, starts[n] <= rows, at most k rows a ray), deltas [n] (one width a ray)
// f32 and mask [n] bytes on the device; outputs [n, 3], alphas [n] and
// extras_out [n, c] are written.  1 <= k <= 64, c <= 8.  Launches on the
// given stream and returns the cudaError_t of the launch (0 on success).
extern "C" int nerf_composite_pooled_forward(const float* densities, const int* starts, const float* deltas,
                                             const float* rgbs, const float* background,
                                             const unsigned char* mask, const float* extras, int n, int k,
                                             int c, int rows, float* outputs, float* alphas,
                                             float* extras_out, void* stream) {
  using namespace nerf;
  if (!composite_valid(n, k, c, extras) || k > 64 || rows < 0 || starts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const CompositeInputs in{densities, deltas, rgbs, background, mask, extras, n, k, c, false, starts, rows};
  return composite_pooled_dispatch<LaunchForward>(k, c, in, outputs, nullptr, alphas, extras_out,
                                                  static_cast<cudaStream_t>(stream));
}

// The pool layout's backward: the forward's inputs, then the cotangents
// grad_outputs [n, 3], grad_alphas [n] and grad_extras_out [n, c] (each may
// be null: zero); grad_densities [rows] is written, and so are grad_rgbs
// [rows, 3], grad_extras [rows, c] and grad_background [3] unless null, all
// in pool order with zeros on the tail (rows starts[n] .. rows - 1).
// background_partials and ticket as for nerf_composite_backward.  n >= 1.
extern "C" int nerf_composite_pooled_backward(
    const float* densities, const int* starts, const float* deltas, const float* rgbs,
    const float* background, const unsigned char* mask, const float* extras, const float* grad_outputs,
    const float* grad_alphas, const float* grad_extras_out, int n, int k, int c, int rows,
    float* grad_densities, float* grad_rgbs, float* grad_extras, float* background_partials,
    unsigned int* ticket, float* grad_background, void* stream) {
  using namespace nerf;
  if (!composite_valid(n, k, c, extras) || n == 0 || k > 64 || rows < 0 || starts == nullptr ||
      grad_densities == nullptr ||
      (grad_background != nullptr && (background_partials == nullptr || ticket == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CompositeInputs in{densities, deltas, rgbs, background, mask, extras, n, k, c, false, starts, rows};
  const CompositeGrads g{grad_outputs, nullptr, grad_alphas, grad_extras_out,
                         grad_densities, nullptr, grad_rgbs, c > 0 ? grad_extras : nullptr,
                         background_partials, ticket, grad_background};
  return composite_pooled_dispatch<LaunchBackward>(k, c, in, g, static_cast<cudaStream_t>(stream));
}
