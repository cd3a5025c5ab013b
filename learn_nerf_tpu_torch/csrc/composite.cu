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
// The pool layout has kernels of its own (composite_pooled_forward_kernel,
// composite_pooled_backward_kernel, below).  They serve the pooled passes,
// whose samples are packed ray-major into one [rows] pool (learn_nerf_tpu/
// occ_render.py:613-654: the segmented exclusive scan, the weights and the
// segment_sum blends): ray r owns rows starts[r] .. starts[r+1] - 1, at most
// k <= 64 of them in t order, and rows starts[n] .. rows - 1 are the pool's
// unused tail.  What bounds them is not bytes (a few hundred KB: under
// 2 us at 3.35 TB/s) but one launch (an empty kernel at the same grid
// takes 1.2-1.7 us), each warp's chain of dependent loads and shuffles,
// and in the backward the background gradient's last-block sum (~2 us).
// A pool has two kinds of rays: short ones, a few rows each (a pool of
// thinly occupied cells: about 10 rows at the train step's bench_pooled
// pool, 5 at a budget-6 tile of short rays), where a warp a ray leaves most
// lanes idle through every shuffle; and long ones, in runs (a served
// frame's rays through the ball own ~31 rows each, the rest none), which
// fill a warp.  So a warp a ray (one warp per ray in the grid, as the dense
// kernels), and the groups of R consecutive rays (R from the caller, by
// the pool's rows a ray) whose rows fit in one chunk of 32 go whole to the
// warp of their first ray; the group's other warps leave.  Every warp of a
// group reads the group's first and last rows and decides alike; nothing
// is searched.  A group: lane l on row first + l (loads coalesce across
// ray boundaries), lane j holds ray j (starts, width, mask, cotangents);
// the head and tail flags are one __reduce_or_sync each, a row finds its
// ray by the count of heads up to it through a 32-byte table of the rays
// that own rows, and the scans are segmented shuffle scans (the optical
// depth's, the blends', and the backward's reverse scan as a segmented
// suffix sum), each ray's totals taken by its own lane from its last row:
// no atomics, the same bits every run.  No run-time branch sits around a
// shuffle: one around each extra's scan cost a reconvergence point a
// shuffle and half the forward's time.  A group never spans two chunks:
// a warp walking several chunks of a group, their sums carried from one to
// the next, was slower than a warp a ray wherever it had to, on cold
// caches most of all, and staging the next chunk by cp.async slower still
// (scripts/composite_ablations.py --pooled).  The backward writes zeros on
// the pool's tail itself (nothing is zeroed before the launch): before the
// rays' work where groups leave warps idle and there are no extras, so the
// stores overlap it, after it otherwise; and it sums the background's
// gradient in the dense backward's order (a block a slot, the last block
// sums them), on the same ticket and scratch, but in f64.
// Each part was kept on a same-call measurement against its alternative
// (scripts/composite_ablations.py, which also builds the earlier kernels
// and the bulk-copy staging of csrc/ablations/, both slower).  f32
// throughout but that f64 sum, expf at full precision (the library is
// built without fast math).
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
};

// What one lane holds of one sample; E is the extras' capacity (C <= E).
// P (a template parameter of the kernels): the widths are per sample.
template <int E>
struct Sample {
  float density, delta, rgb[3], extra[E > 0 ? E : 1];
};

// Sample t of the ray whose first sample is row `first` (ray * k) of
// `count`; past the ray's end everything is 0
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
template <int S, int E, bool P>
__global__ void __launch_bounds__(kCompositeThreads)
    composite_forward_kernel(CompositeInputs in, float* __restrict__ outputs,
                             float* __restrict__ weights, float* __restrict__ alphas,
                             float* __restrict__ extras_out) {
  const int ray = blockIdx.x * kCompositeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ray >= in.n) return;  // a whole warp leaves together
  const long long first = static_cast<long long>(ray) * in.k;
  const int k = in.k;
  float* w_row = weights + static_cast<long long>(ray) * (k + 1);
  const float ray_delta = P ? 0.0f : __ldg(in.deltas + ray);
  const bool hit = __ldg(in.mask + ray) != 0;
  float carry = 0.0f, fg[3] = {0.0f, 0.0f, 0.0f}, ex[E > 0 ? E : 1] = {};

  auto step = [&](const Sample<E>& x, int t) {
    const ScanStep r = scan_step(x.density, x.delta, carry, lane);
    if (t < k) w_row[t] = r.w;
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
    w_row[k] = w_last;
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

template <int S, int E, bool P>
__global__ void __launch_bounds__(kCompositeThreads)
    composite_backward_kernel(CompositeInputs in, CompositeGrads g) {
  const int warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kCompositeWarps + warp;
  const int lane = threadIdx.x & 31;
  float bg_part[3] = {0.0f, 0.0f, 0.0f};
  if (ray < in.n) {  // a whole warp together
    const long long first = static_cast<long long>(ray) * in.k;
    const int k = in.k;
    const float ray_delta = P ? 0.0f : __ldg(in.deltas + ray);
    const bool hit = __ldg(in.mask + ray) != 0;
    const float* gw_row = g.grad_weights != nullptr
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
        } else {
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
    if (!P && g.grad_deltas != nullptr) {
      dt_part = warp_sum(dt_part);
      if (lane == 0) g.grad_deltas[ray] = dt_part;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) bg_part[c] = hit ? w_last * go[c] : go[c];
  }
  if (g.grad_background != nullptr) sum_background(bg_part, g, warp, lane);  // the same for every block
}

inline int composite_blocks(int n) { return (n + kCompositeWarps - 1) / kCompositeWarps; }

// Registers for up to 64 samples (S = 1, 2), else the chunk loop (S = 0);
// extras' capacity 0, 4 or 8; widths per ray or per sample.
template <template <int, int, bool> class Launch, typename... Args>
int composite_dispatch(int k, int c, bool per_sample, Args... args) {
  const int s = k <= 32 ? 1 : (k <= 64 ? 2 : 0);
  const int e = c == 0 ? 0 : (c <= 4 ? 4 : 8);
#define NERF_COMPOSITE_CASE(S_, E_)                                                     \
  if (s == S_ && e == E_) {                                                             \
    return per_sample ? Launch<S_, E_, true>::run(args...)                              \
                      : Launch<S_, E_, false>::run(args...);                            \
  }
  NERF_COMPOSITE_CASE(1, 0) NERF_COMPOSITE_CASE(1, 4) NERF_COMPOSITE_CASE(1, 8)
  NERF_COMPOSITE_CASE(2, 0) NERF_COMPOSITE_CASE(2, 4) NERF_COMPOSITE_CASE(2, 8)
  NERF_COMPOSITE_CASE(0, 0) NERF_COMPOSITE_CASE(0, 4) NERF_COMPOSITE_CASE(0, 8)
#undef NERF_COMPOSITE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int S, int E, bool P>
struct LaunchForward {
  static int run(CompositeInputs in, float* outputs, float* weights, float* alphas, float* extras_out,
                 cudaStream_t stream) {
    composite_forward_kernel<S, E, P><<<composite_blocks(in.n), kCompositeThreads, 0, stream>>>(
        in, outputs, weights, alphas, extras_out);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int S, int E, bool P>
struct LaunchBackward {
  static int run(CompositeInputs in, CompositeGrads g, cudaStream_t stream) {
    composite_backward_kernel<S, E, P><<<composite_blocks(in.n), kCompositeThreads, 0, stream>>>(in, g);
    return static_cast<int>(cudaGetLastError());
  }
};

inline bool composite_valid(int n, int k, int c, const float* extras) {
  return n >= 0 && k >= 1 && c >= 0 && c <= kCompositeMaxExtras && (c == 0) == (extras == nullptr);
}

// -- the pool layout ---------------------------------------------------------

constexpr int kPooledMaxRaysPerWarp = 32;

// The inputs of both pool-layout kernels, by value.
struct PooledInputs {
  const float* densities;     // [rows]
  const int* starts;          // [n + 1]
  const float* deltas;        // [n]
  const float* rgbs;          // [rows, 3]
  const float* background;    // [3]
  const unsigned char* mask;  // [n]
  const float* extras;        // [rows, c], or null when c == 0
  int n, c, rows;
};

// What one lane holds of one pool row (0 where it is outside).
template <int E>
struct PoolRow {
  float density, rgb[3], extra[E > 0 ? E : 1];
};

template <int E>
__device__ __forceinline__ PoolRow<E> load_pool_row(const PooledInputs& in, int row, bool inside) {
  PoolRow<E> x;
  x.density = inside ? __ldg(in.densities + row) : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) x.rgb[c] = inside ? __ldg(in.rgbs + row * 3ll + c) : 0.0f;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    x.extra[j] = inside && j < in.c ? __ldg(in.extras + static_cast<long long>(row) * in.c + j) : 0.0f;
  }
  return x;
}

// A thin group: the rays r0 .. r0 + rays - 1, whose rows first .. last - 1
// fit in one chunk of 32; lane l holds row first + l, lane j ray r0 + j.
struct PoolGroup {
  int r0, rays, first, last;
  int start, end;        // lane j's ray's rows (an empty ray at the end past the group's rays)
  bool owns;             // lane j's ray owns a row
  unsigned int hits;     // bit j: ray r0 + j is not masked
  bool inside;           // lane l's row belongs to the group
  unsigned int tails;    // bit l: row first + l is its ray's last
  int ray;               // the group lane of lane l's row's ray
  int seg_first;         // the lane of that ray's first row
  int seg_last;          // the lane of its last row
};

// `ray_of`: 32 bytes of shared memory of the warp, for the rays that own
// rows in order; a row finds its ray by the count of ray heads up to it.
__device__ __forceinline__ PoolGroup pool_group(const PooledInputs& in, int r0, int rays, int first, int last,
                                                int lane, unsigned char* ray_of) {
  PoolGroup g;
  g.r0 = r0;
  g.rays = rays;
  g.first = first;
  g.last = last;
  const bool mine = lane < rays;
  g.start = mine ? __ldg(in.starts + r0 + lane) : last;
  g.end = mine ? __ldg(in.starts + r0 + lane + 1) : last;
  g.owns = g.end > g.start;
  g.hits = __ballot_sync(kFullWarp, mine && __ldg(in.mask + r0 + lane) != 0);
  const unsigned int owners = __ballot_sync(kFullWarp, g.owns);
  if (g.owns) ray_of[__popc(owners & ((1u << lane) - 1u))] = static_cast<unsigned char>(lane);
  const unsigned int head_at = static_cast<unsigned int>(g.start - first);
  const unsigned int heads = __reduce_or_sync(kFullWarp, g.owns ? 1u << (head_at & 31u) : 0u);
  g.tails = __reduce_or_sync(kFullWarp, g.owns ? 1u << ((g.end - 1 - first) & 31u) : 0u);
  const unsigned int upto = heads & (0xffffffffu >> (31 - lane));
  const unsigned int from = g.tails & (0xffffffffu << lane);
  g.inside = first + lane < last;
  g.seg_first = upto != 0u ? 31 - __clz(upto) : 0;
  g.seg_last = from != 0u ? __ffs(from) - 1 : 31;
  __syncwarp();
  g.ray = g.inside ? ray_of[__popc(upto) - 1] : 0;
  return g;
}

// Inclusive segmented sums over the chunk of each of v[0..M).  No branch
// around a shuffle: a run-time condition there (a sum of an extra the call
// does not have) cost a reconvergence point a shuffle.
template <int M>
__device__ __forceinline__ void segmented_prefix(float (&v)[M], int seg_first, int lane) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const bool take = lane - offset >= seg_first;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float u = __shfl_up_sync(kFullWarp, v[m], offset);
      if (take) v[m] += u;
    }
  }
}

// Inclusive segmented suffix sum over the chunk.
__device__ __forceinline__ float segmented_suffix(float v, int seg_last, int lane) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const float u = __shfl_down_sync(kFullWarp, v, offset);
    if (lane + offset <= seg_last) v += u;
  }
  return v;
}

// The forward of a thin group: the optical depth's segmented scan, the
// weights, the blends' segmented sums; lane j writes ray r0 + j.
template <int E>
__device__ __forceinline__ void group_forward(const PooledInputs& in, const PoolGroup& g, int lane,
                                              float* __restrict__ outputs, float* __restrict__ alphas,
                                              float* __restrict__ extras_out) {
  const PoolRow<E> x = load_pool_row<E>(in, g.first + lane, g.inside);
  const float delta = lane < g.rays ? __ldg(in.deltas + g.r0 + lane) : 0.0f;
  const float s = __fmul_rn(x.density, __shfl_sync(kFullWarp, delta, g.ray));
  float depth[1] = {s};
  segmented_prefix<1>(depth, g.seg_first, lane);
  float excl = __shfl_up_sync(kFullWarp, depth[0], 1);
  if (lane == g.seg_first) excl = 0.0f;
  const float w = expf(-excl) * (1.0f - expf(-s));
  constexpr int M = 3 + E;  // 3 colours, then E extras
  float v[M];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = w * x.rgb[k];
#pragma unroll
  for (int j = 0; j < E; ++j) v[3 + j] = w * x.extra[j];
  segmented_prefix<M>(v, g.seg_first, lane);
  // Each ray's totals from its last row, by its own lane.
  const int tail_lane = (g.end - 1 - g.first) & 31;
  const float depth_t = __shfl_sync(kFullWarp, depth[0], tail_lane);  // every lane shuffles
  const float ray_depth = g.owns ? depth_t : 0.0f;
  float total[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float t = __shfl_sync(kFullWarp, v[m], tail_lane);
    total[m] = g.owns ? t : 0.0f;
  }
  if (lane < g.rays) {
    const int ray = g.r0 + lane;
    const bool hit = (g.hits >> lane) & 1u;
    const float w_last = expf(-ray_depth);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float bg = __ldg(in.background + k);
      outputs[ray * 3ll + k] = hit ? total[k] + w_last * bg : bg;
    }
    alphas[ray] = hit ? 1.0f - w_last : 0.0f;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j < in.c) extras_out[static_cast<long long>(ray) * in.c + j] = hit ? total[3 + j] : 0.0f;
    }
  }
}

// The forward of one ray by a warp (S = 1 or 2 chunks of 32 rows, k <=
// 32 S), the dense kernels' design and arithmetic: every load of the ray
// before the first scan step, the sums over the ray warp sums.
template <int S, int E>
__device__ __forceinline__ void ray_forward(const PooledInputs& in, int ray, int lane, float* __restrict__ outputs,
                                            float* __restrict__ alphas, float* __restrict__ extras_out) {
  const int first = __ldg(in.starts + ray);
  const int k = __ldg(in.starts + ray + 1) - first;
  const float delta = __ldg(in.deltas + ray);
  const bool hit = __ldg(in.mask + ray) != 0;
  PoolRow<E> x[S];
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = load_pool_row<E>(in, first + lane + 32 * i, lane + 32 * i < k);
  float carry = 0.0f, fg[3] = {0.0f, 0.0f, 0.0f}, ex[E > 0 ? E : 1] = {};
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const ScanStep r = scan_step(x[i].density, delta, carry, lane);
#pragma unroll
    for (int c = 0; c < 3; ++c) fg[c] += r.w * x[i].rgb[c];
#pragma unroll
    for (int j = 0; j < E; ++j) ex[j] += r.w * x[i].extra[j];
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
  if (lane == 31) alphas[ray] = hit ? 1.0f - w_last : 0.0f;
}

// Warp w of the grid belongs to ray w and to the group of R rays from
// R floor(w / R).  A thin group (its rows fit in one chunk of 32) is taken
// whole by the warp of its first ray, the others leave; every ray of a
// group that is not thin is taken by its own warp.  The choice is made
// alike by every warp of a group, from the group's first and last rows.
template <int R>
__device__ __forceinline__ bool thin_group(const PooledInputs& in, int ray, int& r0, int& rays, int& first,
                                           int& last) {
  if constexpr (R == 1) {
    return false;
  } else {
    r0 = ray - ray % R;
    rays = in.n - r0 < R ? in.n - r0 : R;
    first = __ldg(in.starts + r0);
    last = __ldg(in.starts + r0 + rays);
    return last - first <= 32;
  }
}

template <int R, int S, int E>
__global__ void __launch_bounds__(kCompositeThreads)
    composite_pooled_forward_kernel(PooledInputs in, float* __restrict__ outputs, float* __restrict__ alphas,
                                    float* __restrict__ extras_out) {
  __shared__ unsigned char ray_of[kCompositeWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kCompositeWarps + warp;
  if (ray >= in.n) return;  // a whole warp leaves together
  int r0, rays, first, last;
  if (thin_group<R>(in, ray, r0, rays, first, last)) {
    if (ray == r0) {
      const PoolGroup g = pool_group(in, r0, rays, first, last, lane, ray_of[warp]);
      group_forward<E>(in, g, lane, outputs, alphas, extras_out);
    }
    return;
  }
  ray_forward<S, E>(in, ray, lane, outputs, alphas, extras_out);
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFullWarp, v, offset);
  return v;
}

// The background's gradient of the pool-layout backward: sum_background's
// fixed order, on the same ticket and [blocks, 3] scratch, with the sums
// over a block's warps and over the blocks in f64 (each block's slot
// rounded to f32 once).  Over thousands of rays, about half of them empty
// (dL/dout itself), the f32 sums lost up to 1.4e-6 of the result against
// an f64 sum, where the plain version's lost 4.4e-7 (chip_smoke's rays
// alternating 0 and 64 rows).  bg_part: the warp's sum, in every lane.
// Every thread of the block calls it.
__device__ __forceinline__ void sum_background_pooled(const float (&bg_part)[3], const CompositeGrads& g,
                                                      int warp, int lane) {
  __shared__ float block_bg[kCompositeWarps][3];
  __shared__ double grid_bg[kCompositeWarps][3];
  __shared__ bool last_block;
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) block_bg[warp][c] = bg_part[c];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double sum = 0.0;
#pragma unroll
    for (int w = 0; w < kCompositeWarps; ++w) sum += block_bg[w][threadIdx.x];
    g.background_partials[blockIdx.x * 3ll + threadIdx.x] = static_cast<float>(sum);
    __threadfence();  // the slot is visible before this block takes its ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) last_block = atomicAdd(g.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;  // the same for the whole block
  __threadfence();
  double acc[3] = {0.0, 0.0, 0.0};
#pragma unroll 4
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kCompositeThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += __ldcg(g.background_partials + b * 3ll + c);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = warp_sum_f64(acc[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) grid_bg[warp][c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double sum = 0.0;
#pragma unroll
    for (int w = 0; w < kCompositeWarps; ++w) sum += grid_bg[w][threadIdx.x];
    g.grad_background[threadIdx.x] = static_cast<float>(sum);
  }
  if (threadIdx.x == 0) *g.ticket = 0u;  // ready for the next launch on this stream
}

// The pool's unused tail, rows starts[n] .. rows - 1, gets zero gradients:
// a grid-stride loop over each gradient's flat range (coalesced).
__device__ __forceinline__ void zero_pool_tail(const PooledInputs& in, const CompositeGrads& g) {
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

// The cotangents of the outputs, alphas and extras' blend of `ray` (0 past
// the rays), and G_K = dL/dout . background - dL/dalpha on a hit ray.
template <int E>
struct RayCotangents {
  float go[3], gex[E > 0 ? E : 1], g_last;
};

template <int E>
__device__ __forceinline__ RayCotangents<E> ray_cotangents(const PooledInputs& in, const CompositeGrads& g,
                                                           long long ray, bool valid, bool hit) {
  RayCotangents<E> t;
#pragma unroll
  for (int c = 0; c < 3; ++c) t.go[c] = valid && g.grad_outputs != nullptr ? __ldg(g.grad_outputs + ray * 3 + c) : 0.0f;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    t.gex[j] = valid && g.grad_extras_out != nullptr && j < in.c ? __ldg(g.grad_extras_out + ray * in.c + j) : 0.0f;
  }
  t.g_last = 0.0f;
  if (valid && hit) {
#pragma unroll
    for (int c = 0; c < 3; ++c) t.g_last += t.go[c] * __ldg(in.background + c);
    if (g.grad_alphas != nullptr) t.g_last -= __ldg(g.grad_alphas + ray);
  }
  return t;
}

// The backward of a thin group: the scan again, then the reverse scan of
// G_t w_t as a segmented suffix sum; bg_part: the group's part of the
// background's gradient (the same in every lane).
template <int E>
__device__ __forceinline__ void group_backward(const PooledInputs& in, const CompositeGrads& g, const PoolGroup& grp,
                                               int lane, float (&bg_part)[3]) {
  const PoolRow<E> x = load_pool_row<E>(in, grp.first + lane, grp.inside);
  const bool mine = lane < grp.rays;
  const float delta = mine ? __ldg(in.deltas + grp.r0 + lane) : 0.0f;
  const bool hit = (grp.hits >> lane) & 1u;
  const RayCotangents<E> t = ray_cotangents<E>(in, g, grp.r0 + lane, mine, hit);
  const float d = __shfl_sync(kFullWarp, delta, grp.ray);
  const float s = __fmul_rn(x.density, d);
  float incl[1] = {s};
  segmented_prefix<1>(incl, grp.seg_first, lane);
  float excl = __shfl_up_sync(kFullWarp, incl[0], 1);
  if (lane == grp.seg_first) excl = 0.0f;
  const float depth_t = __shfl_sync(kFullWarp, incl[0], (grp.end - 1 - grp.first) & 31);
  const float w_last = expf(-(grp.owns ? depth_t : 0.0f));
  const float w = expf(-excl) * (1.0f - expf(-s));
  const bool row_hit = grp.inside && ((grp.hits >> grp.ray) & 1u);
  float go[3], gex[E > 0 ? E : 1];
#pragma unroll
  for (int c = 0; c < 3; ++c) go[c] = __shfl_sync(kFullWarp, t.go[c], grp.ray);
#pragma unroll
  for (int j = 0; j < E; ++j) gex[j] = __shfl_sync(kFullWarp, t.gex[j], grp.ray);
  float gt = 0.0f;
  if (row_hit) {
#pragma unroll
    for (int c = 0; c < 3; ++c) gt += go[c] * x.rgb[c];
#pragma unroll
    for (int j = 0; j < E; ++j) gt += gex[j] * x.extra[j];
  }
  const float from = segmented_suffix(gt * w, grp.seg_last, lane);
  float after = __shfl_down_sync(kFullWarp, from, 1);
  if ((grp.tails >> lane) & 1u) after = 0.0f;
  const float gw_last = __shfl_sync(kFullWarp, t.g_last * w_last, grp.ray);
  const float grad_s = gt * expf(-incl[0]) - (after + gw_last);
  if (grp.inside) {
    const long long i = grp.first + lane;
    g.grad_densities[i] = grad_s * d;
    if (g.grad_rgbs != nullptr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) g.grad_rgbs[i * 3 + c] = row_hit ? w * go[c] : 0.0f;
    }
    if (g.grad_extras != nullptr) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j < in.c) g.grad_extras[i * in.c + j] = row_hit ? w * gex[j] : 0.0f;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) bg_part[c] = warp_sum(mine ? (hit ? w_last * t.go[c] : t.go[c]) : 0.0f);
}

// The backward of one ray by a warp, the dense kernels' design.
template <int S, int E>
__device__ __forceinline__ void ray_backward(const PooledInputs& in, const CompositeGrads& g, int ray, int lane,
                                             float (&bg_part)[3]) {
  const long long first = __ldg(in.starts + ray);
  const int k = __ldg(in.starts + ray + 1) - static_cast<int>(first);
  const float delta = __ldg(in.deltas + ray);
  const bool hit = __ldg(in.mask + ray) != 0;
  const RayCotangents<E> t = ray_cotangents<E>(in, g, ray, true, hit);
  PoolRow<E> x[S];
  float w[S], t_next[S], carry = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = load_pool_row<E>(in, static_cast<int>(first) + lane + 32 * i, lane + 32 * i < k);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const ScanStep r = scan_step(x[i].density, delta, carry, lane);
    w[i] = r.w;
    t_next[i] = expf(-r.incl);
  }
  const float w_last = expf(-carry);
  float suffix = t.g_last * w_last;  // sum_{j >= the next chunk} G_j w_j
#pragma unroll
  for (int i = S - 1; i >= 0; --i) {
    const int row = lane + 32 * i;
    float gt = 0.0f;
    if (row < k && hit) {
#pragma unroll
      for (int c = 0; c < 3; ++c) gt += t.go[c] * x[i].rgb[c];
#pragma unroll
      for (int j = 0; j < E; ++j) gt += t.gex[j] * x[i].extra[j];
    }
    const float inclusive = warp_suffix_sum(gt * w[i], lane);
    float after = __shfl_down_sync(kFullWarp, inclusive, 1);
    if (lane == 31) after = 0.0f;
    const float grad_s = gt * t_next[i] - (after + suffix);
    suffix += __shfl_sync(kFullWarp, inclusive, 0);
    if (row < k) {
      const long long j0 = first + row;
      g.grad_densities[j0] = grad_s * delta;
      if (g.grad_rgbs != nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) g.grad_rgbs[j0 * 3 + c] = hit ? w[i] * t.go[c] : 0.0f;
      }
      if (g.grad_extras != nullptr) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if (j < in.c) g.grad_extras[j0 * in.c + j] = hit ? w[i] * t.gex[j] : 0.0f;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) bg_part[c] = hit ? w_last * t.go[c] : t.go[c];
}

template <int R, int S, int E>
__global__ void __launch_bounds__(kCompositeThreads)
    composite_pooled_backward_kernel(PooledInputs in, CompositeGrads g) {
  __shared__ unsigned char ray_of[kCompositeWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kCompositeWarps + warp;
  // The pool tail's zeros: before the rays' work where groups leave warps
  // idle and there are no extras (the idle warps' stores overlap the rays'
  // work), after it otherwise (measured faster there: the stores would
  // delay busy warps' loads).
  constexpr bool kTailFirst = R > 1 && E == 0;
  if constexpr (kTailFirst) zero_pool_tail(in, g);
  float bg_part[3] = {0.0f, 0.0f, 0.0f};
  if (ray < in.n) {  // a whole warp together
    int r0, rays, first, last;
    if (thin_group<R>(in, ray, r0, rays, first, last)) {
      if (ray == r0) {
        const PoolGroup grp = pool_group(in, r0, rays, first, last, lane, ray_of[warp]);
        group_backward<E>(in, g, grp, lane, bg_part);
      }
    } else {
      ray_backward<S, E>(in, g, ray, lane, bg_part);
    }
  }
  if constexpr (!kTailFirst) zero_pool_tail(in, g);
  if (g.grad_background != nullptr) sum_background_pooled(bg_part, g, warp, lane);  // after the tail's zeros
}

// A warp a ray, as many blocks of kCompositeWarps as that takes, whatever
// the groups (the background's scratch holds 3 floats a block).
inline long long pooled_blocks(int n) { return (n + kCompositeWarps - 1) / kCompositeWarps; }

// Groups of R = 1, 2, 4, ..., 32 rays; S = 1 or 2 chunks a ray (k <= 32
// or 64); extras' capacity 0, 3 (the sample points) or 8.
template <template <int, int, int> class Launch, typename... Args>
int composite_pooled_dispatch(int rays_per_warp, int k, int c, Args... args) {
  const int e = c == 0 ? 0 : (c <= 3 ? 3 : 8);
#define NERF_COMPOSITE_POOLED_CASE(R_)                                                  \
  if (rays_per_warp == R_) {                                                            \
    if (k <= 32) {                                                                      \
      if (e == 0) return Launch<R_, 1, 0>::run(args...);                                \
      if (e == 3) return Launch<R_, 1, 3>::run(args...);                                \
      return Launch<R_, 1, 8>::run(args...);                                            \
    }                                                                                   \
    if (e == 0) return Launch<R_, 2, 0>::run(args...);                                  \
    if (e == 3) return Launch<R_, 2, 3>::run(args...);                                  \
    return Launch<R_, 2, 8>::run(args...);                                              \
  }
  NERF_COMPOSITE_POOLED_CASE(1) NERF_COMPOSITE_POOLED_CASE(2) NERF_COMPOSITE_POOLED_CASE(4)
  NERF_COMPOSITE_POOLED_CASE(8) NERF_COMPOSITE_POOLED_CASE(16) NERF_COMPOSITE_POOLED_CASE(32)
#undef NERF_COMPOSITE_POOLED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int R, int S, int E>
struct LaunchPooledForward {
  static int run(PooledInputs in, float* outputs, float* alphas, float* extras_out, cudaStream_t stream) {
    composite_pooled_forward_kernel<R, S, E><<<static_cast<unsigned int>(pooled_blocks(in.n)), kCompositeThreads,
                                               0, stream>>>(in, outputs, alphas, extras_out);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int R, int S, int E>
struct LaunchPooledBackward {
  static int run(PooledInputs in, CompositeGrads g, cudaStream_t stream) {
    composite_pooled_backward_kernel<R, S, E><<<static_cast<unsigned int>(pooled_blocks(in.n)), kCompositeThreads,
                                                0, stream>>>(in, g);
    return static_cast<int>(cudaGetLastError());
  }
};

inline bool pooled_valid(int n, int k, int c, const float* extras, int rows, const int* starts,
                         int rays_per_warp) {
  const bool power_of_two = rays_per_warp >= 1 && rays_per_warp <= kPooledMaxRaysPerWarp &&
                            (rays_per_warp & (rays_per_warp - 1)) == 0;
  return composite_valid(n, k, c, extras) && k <= 64 && rows >= 0 && starts != nullptr && power_of_two;
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
                           per_sample_deltas != 0};
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
                           per_sample_deltas != 0};
  const CompositeGrads g{grad_outputs, grad_weights, grad_alphas, grad_extras_out,
                         grad_densities, grad_deltas, grad_rgbs, c > 0 ? grad_extras : nullptr,
                         background_partials, ticket, grad_background};
  return composite_dispatch<LaunchBackward>(k, c, in.per_sample, in, g, static_cast<cudaStream_t>(stream));
}


// The pool layout.  densities [rows], rgbs [rows, 3] and extras [rows, c]
// (null when c = 0) f32, starts [n + 1] int32 (non-decreasing, starts[0] =
// 0, starts[n] <= rows, at most k rows a ray), deltas [n] (one width a ray)
// f32 and mask [n] bytes on the device; outputs [n, 3], alphas [n] and
// extras_out [n, c] are written.  1 <= k <= 64, c <= 8; groups of
// rays_per_warp (1, 2, 4, 8, 16 or 32) consecutive rays whose rows fit in
// 32 go to one warp, every other ray to a warp of its own (blocks of 8
// warps, one a ray).  Launches on the given stream and returns the
// cudaError_t of the launch (0 on success).
extern "C" int nerf_composite_pooled_forward(const float* densities, const int* starts, const float* deltas,
                                             const float* rgbs, const float* background,
                                             const unsigned char* mask, const float* extras, int n, int k,
                                             int c, int rows, int rays_per_warp, float* outputs, float* alphas,
                                             float* extras_out, void* stream) {
  using namespace nerf;
  if (!pooled_valid(n, k, c, extras, rows, starts, rays_per_warp)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const PooledInputs in{densities, starts, deltas, rgbs, background, mask, extras, n, c, rows};
  return composite_pooled_dispatch<LaunchPooledForward>(rays_per_warp, k, c, in, outputs, alphas, extras_out,
                                                        static_cast<cudaStream_t>(stream));
}

// The pool layout's backward: the forward's inputs, then the cotangents
// grad_outputs [n, 3], grad_alphas [n] and grad_extras_out [n, c] (each may
// be null: zero); grad_densities [rows] is written, and so are grad_rgbs
// [rows, 3], grad_extras [rows, c] and grad_background [3] unless null, all
// in pool order with zeros on the tail (rows starts[n] .. rows - 1).
// background_partials (one float3 per block of 8 rays) and ticket are as
// for nerf_composite_backward, whose launches share them.  n >= 1.
extern "C" int nerf_composite_pooled_backward(
    const float* densities, const int* starts, const float* deltas, const float* rgbs,
    const float* background, const unsigned char* mask, const float* extras, const float* grad_outputs,
    const float* grad_alphas, const float* grad_extras_out, int n, int k, int c, int rows, int rays_per_warp,
    float* grad_densities, float* grad_rgbs, float* grad_extras, float* background_partials,
    unsigned int* ticket, float* grad_background, void* stream) {
  using namespace nerf;
  if (!pooled_valid(n, k, c, extras, rows, starts, rays_per_warp) || n == 0 || grad_densities == nullptr ||
      (grad_background != nullptr && (background_partials == nullptr || ticket == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PooledInputs in{densities, starts, deltas, rgbs, background, mask, extras, n, c, rows};
  const CompositeGrads g{grad_outputs, nullptr, grad_alphas, grad_extras_out,
                         grad_densities, nullptr, grad_rgbs, c > 0 ? grad_extras : nullptr,
                         background_partials, ticket, grad_background};
  return composite_pooled_dispatch<LaunchPooledBackward>(rays_per_warp, k, c, in, g, static_cast<cudaStream_t>(stream));
}
