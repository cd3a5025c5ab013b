// A measured variant (chip_smoke.py check_selection_kernels and
// scripts/selection_ablations.py, built on its own): the selection pair as
// first written, before selection.cu read the occupancy test from packed
// cell bits with every load of a ray in flight, and before the pack scanned
// the counts itself.  The redesign must equal it bit for bit.  Its entry
// points carry "_parent" in their names; the pack takes the inclusive scan
// of the kept counts (one torch.cumsum before it), the selection the f32
// grid densities.
//
// The occupancy renderer's sample selection and its pooled packing, with a
// plain C interface for ctypes (learn_nerf_tpu_torch/kernels/build.py,
// kernels/selection.py).
//
// select_strided_kernel replaces the XLA ops of the JAX package's candidate
// selection and strided compaction (learn_nerf_tpu/occ_render.py:279-327
// _select_candidates, with ops/geometry.py:21-62 ray_bbox_range,
// ops/sampling.py:31 stratified_ts, acceleration.py:114-131 cell_indices and
// the warmup rule, and acceleration.py:389-428 compact_occupied_strided).
// Per ray of rays [N, 2, 3] (rows of any stride) and uniforms u [N, C]:
//   - the slab test against the bbox, with the sign-preserving epsilon, and
//     the null range (0, min_t_range) for a ray that misses; with a span
//     (the two-phase span lever's t_lo, t_hi, hit from plain ops), the span
//     is the range and the mask is the slab test's and hit;
//   - the C stratified candidates t_k = t_min + (k + u_k) * bin, bin =
//     (t_max - t_min) / C;
//   - each candidate's cell, clip((x - lo) / (hi - lo), 0, 1 - 1e-7) * R
//     truncated, x fastest, its density in the grid [R^3], and the rule
//     warm || density > threshold;
//   - with eps > 0 the transmittance prune: a candidate stays where
//     exp(-(S_k - a_k)) > eps, a_k = density_k * bin on occupied candidates
//     (0 elsewhere), S_k their inclusive prefix sum;
//   - the bbox mask; c the ray's occupied count;
//   - slot s < K takes the candidate of rank floor(s * max(c, K) / K): the
//     first candidate at which the running count reaches min(rank + 1, c)
//     (candidate 0 when c = 0), valid where rank < c.
// Out: ts [N, K], sample_mask [N, K], dt [N] = bin * max(c / K, 1), mask
// [N], count [N] = c (int32, not clamped) and, unless null, the points
// [N, K, 3] = o + d * t.
//
// pool_pack_kernel replaces the pooled pass's packing (occ_render.py:586-606:
// a global cumsum of the sample mask, the scatter of each survivor into its
// slot and the gathers of its ray and t).  From ts [N, K] and the inclusive
// scan cum [N] of the kept counts min(c, K) (one torch.cumsum between the
// two launches), survivor j of ray r goes to slot cum[r - 1] + j when that
// is below the budget, and is dropped otherwise; slots from cum[N - 1] on
// hold ray N - 1 at t = 0.  Out: pool_t [budget], pool_ray [budget]
// (int64), the pool's points and directions [budget, 3], starts [N + 1] =
// (0, min(cum, budget)) (int32), and the 0-dim int64 selected = cum[N - 1]
// and dropped = max(selected - budget, 0).
//
// Rounding: every f32 step is one _rn intrinsic, so nvcc cannot contract a
// multiply and an add into an FMA, and each step rounds as the plain
// version's PyTorch op does on the card.  The two divisions by a Python
// integer, bin = (t_max - t_min) / C and c / K, multiply by the f32
// reciprocal, which the wrapper passes: PyTorch's CUDA division by a CPU
// scalar computes a * (1 / b), so this is the plain route on the card to the
// bit (chip_smoke.py holds it).  With the prune off, every output equals the
// plain version's bit for bit.  The prune's prefix sum adds in another order
// than torch.cumsum, so its decisions may differ on candidates whose
// exp(-(S_k - a_k)) lies within a few ulps of eps.
//
// What bounds it on an H100: bytes.  At the train step's 4096 rays x 192
// candidates -> 32 samples it reads u (3.1 MB), the rays and 786,432 random
// grid densities (4 bytes each, from the 8 MB grid that L2 holds) and writes
// 1.6 MB of samples and points.  Design, for a first kernel that is right:
// - one warp a ray, lane l takes candidates l, l + 32, ... in chunks of 32:
//   a chunk's prune prefix is five shuffles plus the carry from the chunk
//   before; its occupancy is one ballot, kept in shared memory (C / 32
//   words a ray), and c the sum of their popcounts;
// - slot s goes to lane s % 32, which walks the ballots to the word that
//   holds its rank and the bit within it, and recomputes that candidate's t
//   from u (the same arithmetic, so the same bits): no candidate t is kept;
// - blocks of 4 warps, fewer when a large C needs the shared memory.
// The pack is a thread a (ray, slot) pair of the [N, K] samples, a thread a
// pool slot for the tail, a thread a ray for starts; with selected and
// dropped written by thread 0 the pass needs no host sync.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace nerf {

constexpr int kSelectWarps = 4;
constexpr int kSelectSharedBytes = 48 * 1024;
constexpr int kPackThreads = 256;
constexpr unsigned int kFullMask = 0xffffffffu;
// ops/geometry.ray_bbox_range's epsilon and _cell_coords' upper clip, as
// the f32 constants the plain version's ops compare and clamp with.
constexpr float kSlabEpsilon = static_cast<float>(1e-8);
constexpr float kBelowOne = static_cast<float>(1.0 - 1e-7);

struct SelectArgs {
  const float* rays;  // [n] rows of (origin, direction), ray_stride floats apart
  const float* u;  // [n, candidates]
  const float* densities;  // [resolution^3]
  const float* span_lo;  // [n], or null: no span
  const float* span_hi;
  const unsigned char* span_hit;
  long long n, ray_stride;
  int candidates, samples, resolution, warm;
  float lo[3], hi[3];
  float threshold, min_t_range, eps, inv_candidates, inv_samples;
  float* ts;  // [n, samples]
  unsigned char* sample_mask;
  float* dt;  // [n]
  unsigned char* mask;  // [n]
  int* count;  // [n]
  float* points;  // [n, samples, 3], or null
};

// ray_bbox_range for one ray: (t_min, t_max, hit).
__device__ __forceinline__ void slab_range(const float (&o)[3], const float (&d)[3], const SelectArgs& a,
                                           float& t_min, float& t_max, bool& hit) {
  float t_enter = -CUDART_INF_F, t_exit = CUDART_INF_F;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    float safe = d[axis];
    if (fabsf(safe) < kSlabEpsilon) safe = safe < 0.0f ? -kSlabEpsilon : kSlabEpsilon;
    const float t0 = __fdiv_rn(__fsub_rn(a.lo[axis], o[axis]), safe);
    const float t1 = __fdiv_rn(__fsub_rn(a.hi[axis], o[axis]), safe);
    t_enter = fmaxf(t_enter, fminf(t0, t1));
    t_exit = fminf(t_exit, fmaxf(t0, t1));
  }
  t_enter = fmaxf(t_enter, 0.0f);
  hit = t_enter < t_exit;
  t_min = hit ? t_enter : 0.0f;
  t_max = hit ? fmaxf(t_exit, __fadd_rn(t_enter, a.min_t_range)) : a.min_t_range;
}

// The flat cell of a point (x fastest): OccupancyGrid.cell_indices.
__device__ __forceinline__ int cell_index(const float (&p)[3], const SelectArgs& a) {
  int cell[3];
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const float span = __fsub_rn(a.hi[axis], a.lo[axis]);
    const float frac = fminf(fmaxf(__fdiv_rn(__fsub_rn(p[axis], a.lo[axis]), span), 0.0f), kBelowOne);
    cell[axis] = static_cast<int>(__fmul_rn(frac, static_cast<float>(a.resolution)));
  }
  return cell[0] + a.resolution * (cell[1] + a.resolution * cell[2]);
}

// Candidate k's t: stratified_ts' t_min + (k + u) * bin.
__device__ __forceinline__ float candidate_t(float t_min, float bin, int k, float u) {
  return __fadd_rn(t_min, __fmul_rn(__fadd_rn(static_cast<float>(k), u), bin));
}

__device__ __forceinline__ void point_at(const float (&o)[3], const float (&d)[3], float t, float (&p)[3]) {
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) p[axis] = __fadd_rn(o[axis], __fmul_rn(d[axis], t));
}

__global__ void __launch_bounds__(kSelectWarps * 32) select_strided_kernel(const SelectArgs a) {
  extern __shared__ unsigned int ballots[];  // [warps][words]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (ray >= a.n) return;  // the whole warp
  const int words = (a.candidates + 31) >> 5;
  unsigned int* bits = ballots + warp * words;
  const float* row = a.rays + ray * a.ray_stride;
  const float o[3] = {row[0], row[1], row[2]};
  const float d[3] = {row[3], row[4], row[5]};
  float t_min, t_max;
  bool hit;
  slab_range(o, d, a, t_min, t_max, hit);
  if (a.span_lo != nullptr) {
    t_min = a.span_lo[ray];
    t_max = a.span_hi[ray];
    hit = hit && a.span_hit[ray] != 0;
  }
  const float bin = __fmul_rn(__fsub_rn(t_max, t_min), a.inv_candidates);
  const float* u = a.u + ray * a.candidates;

  int count = 0;
  float carry = 0.0f;  // the prune's prefix sum over the chunks before
  for (int w = 0; w < words; ++w) {
    const int k = (w << 5) + lane;
    bool occupied = false;
    float density = 0.0f;
    if (k < a.candidates) {
      float p[3];
      point_at(o, d, candidate_t(t_min, bin, k, u[k]), p);
      density = __ldg(a.densities + cell_index(p, a));
      occupied = a.warm != 0 || density > a.threshold;
    }
    if (a.eps > 0.0f) {  // the same for every lane
      const float approx = occupied ? __fmul_rn(density, bin) : 0.0f;
      float sum = approx;
#pragma unroll
      for (int offset = 1; offset < 32; offset <<= 1) {
        const float other = __shfl_up_sync(kFullMask, sum, offset);
        if (lane >= offset) sum = __fadd_rn(sum, other);
      }
      const float inclusive = __fadd_rn(carry, sum);
      carry = __shfl_sync(kFullMask, inclusive, 31);
      occupied = occupied && expf(-__fsub_rn(inclusive, approx)) > a.eps;
    }
    const unsigned int word = __ballot_sync(kFullMask, occupied && hit);
    if (lane == 0) bits[w] = word;
    count += __popc(word);
  }
  __syncwarp();

  const int cap = max(count, a.samples);
  for (int s = lane; s < a.samples; s += 32) {
    const int rank = static_cast<int>(static_cast<long long>(s) * cap / a.samples);
    const int target = min(rank + 1, count);
    int k = 0;
    if (target > 0) {
      int before = 0, w = 0;
      for (;; ++w) {
        const int here = __popc(bits[w]);
        if (before + here >= target) break;
        before += here;
      }
      unsigned int word = bits[w];
      for (int skip = target - before - 1; skip > 0; --skip) word &= word - 1;  // drop the lowest set bits
      k = (w << 5) + __ffs(word) - 1;
    }
    const float t = candidate_t(t_min, bin, k, u[k]);
    const long long slot = ray * a.samples + s;
    a.ts[slot] = t;
    a.sample_mask[slot] = rank < count;
    if (a.points != nullptr) {
      float p[3];
      point_at(o, d, t, p);
#pragma unroll
      for (int axis = 0; axis < 3; ++axis) a.points[slot * 3 + axis] = p[axis];
    }
  }
  if (lane == 0) {
    const float scale = fmaxf(__fmul_rn(static_cast<float>(count), a.inv_samples), 1.0f);
    a.dt[ray] = __fmul_rn(bin, scale);
    a.mask[ray] = hit;
    a.count[ray] = count;
  }
}

struct PackArgs {
  const float* rays;  // as SelectArgs
  const float* ts;  // [n, samples]
  const int* cum;  // [n]: inclusive scan of min(count, samples)
  long long n, ray_stride, budget;
  int samples;
  float* pool_t;  // [budget]
  long long* pool_ray;
  float* points;  // [budget, 3]
  float* dirs;
  int* starts;  // [n + 1]
  long long* selected;  // 0-dim
  long long* dropped;
};

__device__ __forceinline__ void write_slot(const PackArgs& a, long long slot, long long ray, float t) {
  const float* row = a.rays + ray * a.ray_stride;
  const float o[3] = {row[0], row[1], row[2]};
  const float d[3] = {row[3], row[4], row[5]};
  float p[3];
  point_at(o, d, t, p);
  a.pool_t[slot] = t;
  a.pool_ray[slot] = ray;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    a.points[slot * 3 + axis] = p[axis];
    a.dirs[slot * 3 + axis] = d[axis];
  }
}

__global__ void __launch_bounds__(kPackThreads) pool_pack_kernel(const PackArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = a.cum[a.n - 1];
  if (i < a.n * a.samples) {  // sample j of ray r
    const long long ray = i / a.samples;
    const long long slot = (ray > 0 ? a.cum[ray - 1] : 0) + i % a.samples;
    if (slot < a.cum[ray] && slot < a.budget) write_slot(a, slot, ray, a.ts[i]);
  }
  if (i >= total && i < a.budget) write_slot(a, i, a.n - 1, 0.0f);  // the tail
  if (i <= a.n) a.starts[i] = i == 0 ? 0 : static_cast<int>(min(static_cast<long long>(a.cum[i - 1]), a.budget));
  if (i == 0) {
    *a.selected = total;
    *a.dropped = max(total - a.budget, 0LL);
  }
}

}  // namespace nerf

// rays: n rows of (origin, direction), ray_stride floats apart; u [n, c],
// densities [r^3] f32; span_lo, span_hi [n] f32 and span_hit [n] bytes, all
// three null without a span.  ts [n, k], sample_mask [n, k] bytes, dt [n],
// mask [n] bytes and count [n] int32 are written, and points [n, k, 3]
// unless null.  1 <= k, 1 <= c, c * k < 2^31, c / 32 words in 48 KiB.
// Launches on the given stream and returns the cudaError_t of the launch.
extern "C" int nerf_select_strided_parent(const float* rays, long long ray_stride, const float* u,
                                   const float* densities, const float* span_lo, const float* span_hi,
                                   const unsigned char* span_hit, long long n, int c, int k, int r,
                                   float lo_x, float lo_y, float lo_z, float hi_x, float hi_y, float hi_z,
                                   float threshold, int warm, float min_t_range, float eps,
                                   float inv_candidates, float inv_samples, float* ts,
                                   unsigned char* sample_mask, float* dt, unsigned char* mask, int* count,
                                   float* points, void* stream) {
  using namespace nerf;
  const int words = (c + 31) / 32;
  if (c < 1 || k < 1 || r < 1 || static_cast<long long>(c) * k >= (1LL << 31) ||
      words * 4 > kSelectSharedBytes || (span_lo == nullptr) != (span_hi == nullptr) ||
      (span_lo == nullptr) != (span_hit == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int warps = kSelectWarps;
  while (warps > 1 && warps * words * 4 > kSelectSharedBytes) warps /= 2;
  const SelectArgs a{rays, u, densities, span_lo, span_hi, span_hit, n, ray_stride, c, k, r, warm,
                     {lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}, threshold, min_t_range, eps, inv_candidates,
                     inv_samples, ts, sample_mask, dt, mask, count, points};
  const long long blocks = (n + warps - 1) / warps;
  select_strided_kernel<<<static_cast<unsigned int>(blocks), warps * 32, warps * words * 4,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// rays as above; ts [n, k] f32 and cum [n] int32 on the device; pool_t,
// pool_ray (int64), points and dirs [budget, 3], starts [n + 1] (int32) and
// the 0-dim int64 selected and dropped are written.  n >= 1, budget >= 1.
extern "C" int nerf_pool_pack_parent(const float* rays, long long ray_stride, const float* ts, const int* cum,
                              long long n, int k, long long budget, float* pool_t, long long* pool_ray,
                              float* points, float* dirs, int* starts, long long* selected,
                              long long* dropped, void* stream) {
  using namespace nerf;
  if (n < 1 || k < 1 || budget < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PackArgs a{rays, ts, cum, n, ray_stride, budget, k, pool_t, pool_ray, points, dirs, starts,
                   selected, dropped};
  long long threads = n * k;
  if (budget > threads) threads = budget;
  if (n + 1 > threads) threads = n + 1;
  const long long blocks = (threads + kPackThreads - 1) / kPackThreads;
  pool_pack_kernel<<<static_cast<unsigned int>(blocks), kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
