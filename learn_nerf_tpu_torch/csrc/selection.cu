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
//     truncated, and the rule warm || density > threshold, read as the
//     cell's bit in the packed words (acceleration.pack_occupancy_words:
//     4 x 4 x 2 cells a 32-bit word, the grid padded to whole words);
//   - with eps > 0 the transmittance prune: a candidate stays where
//     exp(-(S_k - a_k)) > eps, a_k = density_k * bin on occupied candidates
//     (0 elsewhere), S_k their inclusive prefix sum; the f32 density (x
//     fastest, [R^3]) gives the test too, density > threshold, as the
//     words were packed;
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
// slot and the gathers of its ray and t).  From ts [N, K] and the
// selection's counts c [N] (its sample mask is exactly j < min(c, K)), ray
// r's survivor j goes to slot S_r + j, S_r the sum of min(c, K) over the
// rays before r, when that is below the budget, and is dropped otherwise;
// slots from S_N on hold ray N - 1 at t = 0.  Out: pool_t [budget],
// pool_ray [budget] (int64), the pool's points and directions [budget, 3],
// starts [N + 1] = (0, min(S_{r+1}, budget)) (int32), and the 0-dim int64
// selected = S_N and dropped = max(selected - budget, 0).
//
// Rounding: every f32 step is one _rn intrinsic, so nvcc cannot contract a
// multiply and an add into an FMA, and each step rounds as the plain
// version's PyTorch op does on the card.  The two divisions by a Python
// integer, bin = (t_max - t_min) / C and c / K, multiply by the f32
// reciprocal, which the wrapper passes: PyTorch's CUDA division by a CPU
// scalar computes a * (1 / b), so this is the plain route on the card to the
// bit (chip_smoke.py holds it).  A cell coordinate's division by the bbox
// side, a division of two tensors in the plain version, is its rounded
// quotient from the side's reciprocal (divide, below).  With the prune off,
// every output equals the
// plain version's bit for bit.  The prune's prefix sum adds in another order
// than torch.cumsum, so its decisions may differ on candidates whose
// exp(-(S_k - a_k)) lies within a few ulps of eps.
//
// What bounds the selection on an H100: its instructions, not DRAM bytes
// (u is 3.1 MB at the train step's 4096 rays x 192 candidates -> 32
// samples, under 1 us at 3.35 TB/s) and not its grid reads.  All 4096 warps
// of the step are resident at once, and each candidate costs some 60
// instructions of cell arithmetic (three divisions, clamps, truncations,
// indices) before its test; reading the test from packed words in place of
// f32 densities, with every load in flight, moved it by under 0.5 us, while
// each cut of the candidate's instructions moved it by about as much
// (scripts/selection_ablations.py, PERF.md).  This design:
// - one warp a ray, a template instance with and one without the prune;
//   lane l takes candidates l, l + 32, ... in chunks of 32, up to
//   kChunksInFlight chunks (256 candidates) held in registers at once: all
//   their u loads are issued, then all their word loads (with the prune,
//   density loads: the prune needs the density, and the test reads it in
//   place of the word), and only then the ballots;
// - the test reads one bit a cell from the packed words, 256 KiB at 128^3
//   (1/32 of the densities), which stay in L1 and L2;
// - a cell coordinate's division by the bbox side is a multiply by the
//   wrapper's rounded reciprocal and two residual FMAs, the rounded
//   quotient itself (divide), with no reciprocal or range check of its own;
// - a chunk's prune prefix is five shuffles plus the carry from the chunk
//   before; its occupancy is one ballot, kept in shared memory (C / 32
//   words a ray), and c the sum of their popcounts;
// - slot s goes to lane s % 32, which walks the ballots to the word that
//   holds its rank, finds the bit within it by five halvings, and
//   recomputes that candidate's t from u (the same arithmetic, so the same
//   bits): no candidate t is kept;
// - blocks of 4 warps, fewer when a large C needs the shared memory.
// The pack is one launch from the counts, with no scan before it and no
// scratch (the first design: a thread a sample after a clamp and a
// torch.cumsum, three launches): each block sums the clamped counts of the rays before its own
// (and of all rays, for the tail) from the 16-byte loads of one pass over
// the counts, then places its rays 32 at a time: each warp scans the 32
// counts with shuffles, and a group of kPackGroup lanes writes one ray's
// survivors, the ray's six floats read once.  At most kPackBlocks blocks,
// so the counts are read at most that many times over (4 MB of L2 reads at
// a tile of 8192 rays); beyond a few 10^5 rays a call that reading costs as
// much as the pack's writes, and the pack stays right at any N.  Every
// block writes its share of the tail; block 0 writes starts[0], selected
// and dropped.  Nothing syncs with the host, and a launch leaves no state.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace nerf {

constexpr int kSelectWarps = 4;
constexpr int kSelectSharedBytes = 48 * 1024;
constexpr int kChunksInFlight = 8;
constexpr int kPackThreads = 256;
constexpr int kPackGroup = 8;  // lanes a ray
constexpr int kPackChunk = kPackThreads / kPackGroup;  // rays a block places at once: one warp's scan
constexpr int kPackBlocks = 128;
constexpr unsigned int kFullMask = 0xffffffffu;
// ops/geometry.ray_bbox_range's epsilon and _cell_coords' upper clip, as
// the f32 constants the plain version's ops compare and clamp with.
constexpr float kSlabEpsilon = static_cast<float>(1e-8);
constexpr float kBelowOne = static_cast<float>(1.0 - 1e-7);

struct SelectArgs {
  const float* rays;  // [n] rows of (origin, direction), ray_stride floats apart
  const float* u;  // [n, candidates]
  const unsigned int* words;  // the cells' bits density > threshold, packed
  const float* densities;  // [resolution^3]: the prune's
  const float* span_lo;  // [n], or null: no span
  const float* span_hi;
  const unsigned char* span_hit;
  long long n, ray_stride;
  int candidates, samples, resolution, warm;
  float lo[3], hi[3];
  float threshold, min_t_range, eps, inv_candidates, inv_samples;
  float inv_span[3];  // 1 / (hi - lo) rounded to f32
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

// x / span rounded to nearest, as __fdiv_rn rounds it, from inv = RN(1 /
// span) (the wrapper's; spans in [2^-60, 2^60]): q = x * inv is within 1.5
// ulps of x / span, one residual step q + (x - q span) inv (the residual
// exact in an FMA) brings it within an ulp, and a second gives the rounded
// quotient (Markstein's theorem) wherever nothing under- or overflows, that
// is for 2^-100 <= |x| < 2^100, for 0 and NaN; an infinite x keeps x * inv.
// Outside that range the quotient may be an ulp off, where it cannot move
// a cell: under 2^-40 it is cell 0, past 2^40 it clamps to 0 or 1 - 1e-7.
__device__ __forceinline__ float divide(float x, float span, float inv) {
  const float q = __fmul_rn(x, inv);
  const float q1 = __fmaf_rn(__fmaf_rn(-q, span, x), inv, q);
  const float q2 = __fmaf_rn(__fmaf_rn(-q1, span, x), inv, q1);
  return isinf(x) ? q : q2;
}

// A point's (x, y, z) cell: OccupancyGrid._cell_coords.
__device__ __forceinline__ void cell_coords(const float (&p)[3], const SelectArgs& a, int (&cell)[3]) {
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const float span = __fsub_rn(a.hi[axis], a.lo[axis]);
    const float frac =
        fminf(fmaxf(divide(__fsub_rn(p[axis], a.lo[axis]), span, a.inv_span[axis]), 0.0f), kBelowOne);
    cell[axis] = static_cast<int>(__fmul_rn(frac, static_cast<float>(a.resolution)));
  }
}

// The flat cell (x fastest): OccupancyGrid.cell_indices.
__device__ __forceinline__ int cell_index(const int (&cell)[3], int r) {
  return cell[0] + r * (cell[1] + r * cell[2]);
}

// The cell's packed word and its bit in it: OccupancyGrid.block_indices,
// ceil(r / 4) words along x and y.
__device__ __forceinline__ int word_index(const int (&cell)[3], int r) {
  const int across = (r + 3) >> 2;
  return (cell[0] >> 2) + across * ((cell[1] >> 2) + across * (cell[2] >> 1));
}

__device__ __forceinline__ int bit_index(const int (&cell)[3]) {
  return (cell[0] & 3) + 4 * (cell[1] & 3) + 16 * (cell[2] & 1);
}

// Candidate k's t: stratified_ts' t_min + (k + u) * bin.
__device__ __forceinline__ float candidate_t(float t_min, float bin, int k, float u) {
  return __fadd_rn(t_min, __fmul_rn(__fadd_rn(static_cast<float>(k), u), bin));
}

__device__ __forceinline__ void point_at(const float (&o)[3], const float (&d)[3], float t, float (&p)[3]) {
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) p[axis] = __fadd_rn(o[axis], __fmul_rn(d[axis], t));
}

template <bool kPrune>
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
  for (int first = 0; first < words; first += kChunksInFlight) {
    // Every load of these chunks in flight before the first ballot: the
    // uniforms, then their cells' words (with the prune, densities).
    float uk[kChunksInFlight];
#pragma unroll
    for (int i = 0; i < kChunksInFlight; ++i) {
      const int k = ((first + i) << 5) + lane;
      uk[i] = k < a.candidates ? __ldg(u + k) : 0.0f;
    }
    unsigned int word[kChunksInFlight];
    int bit[kChunksInFlight], flat[kChunksInFlight];
    float density[kChunksInFlight];
#pragma unroll
    for (int i = 0; i < kChunksInFlight; ++i) {
      const int k = ((first + i) << 5) + lane;
      word[i] = 0u;
      bit[i] = 0;
      flat[i] = 0;
      density[i] = 0.0f;
      if (k < a.candidates) {
        float p[3];
        point_at(o, d, candidate_t(t_min, bin, k, uk[i]), p);
        int cell[3];
        cell_coords(p, a, cell);
        flat[i] = cell_index(cell, a.resolution);
        bit[i] = bit_index(cell);
        if (kPrune) {  // the prune needs the density: the test reads it in place of the word
          density[i] = __ldg(a.densities + flat[i]);
          word[i] = a.warm != 0 || density[i] > a.threshold ? kFullMask : 0u;
        } else {
          word[i] = a.warm != 0 ? kFullMask : __ldg(a.words + word_index(cell, a.resolution));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kChunksInFlight; ++i) {
      const int w = first + i;
      if (w >= words) break;  // the same for every lane
      bool keep = ((word[i] >> bit[i]) & 1u) && hit;
      if (kPrune) {
        const float approx = keep ? __fmul_rn(density[i], bin) : 0.0f;
        float sum = approx;
#pragma unroll
        for (int offset = 1; offset < 32; offset <<= 1) {
          const float other = __shfl_up_sync(kFullMask, sum, offset);
          if (lane >= offset) sum = __fadd_rn(sum, other);
        }
        const float inclusive = __fadd_rn(carry, sum);
        carry = __shfl_sync(kFullMask, inclusive, 31);
        keep = keep && expf(-__fsub_rn(inclusive, approx)) > a.eps;
      }
      const unsigned int ballot = __ballot_sync(kFullMask, keep);
      if (lane == 0) bits[w] = ballot;
      count += __popc(ballot);
    }
  }
  __syncwarp();

  const int cap = max(count, a.samples);
  for (int s = lane; s < a.samples; s += 32) {
    const int rank = s * cap / a.samples;  // s * cap < K * max(C, K) < 2^31
    const int target = min(rank + 1, count);
    int k = 0;
    if (target > 0) {
      int before = 0, w = 0;
      for (;; ++w) {
        const int here = __popc(bits[w]);
        if (before + here >= target) break;
        before += here;
      }
      unsigned int ballot = bits[w];
      int want = target - before;  // the want-th set bit of the ballot, by halving
#pragma unroll
      for (int width = 16; width > 0; width >>= 1) {
        const int low = __popc(ballot & ((1u << width) - 1u));
        if (low < want) {
          want -= low;
          ballot >>= width;
          k += width;
        }
      }
      k += w << 5;
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
  const int* count;  // [n]: the selection's occupied counts, not clamped
  long long n, ray_stride, budget, rays_per_block;
  int samples;
  float* pool_t;  // [budget]
  long long* pool_ray;
  float* points;  // [budget, 3]
  float* dirs;
  int* starts;  // [n + 1]
  long long* selected;  // 0-dim
  long long* dropped;
};

__device__ __forceinline__ void write_slot(const PackArgs& a, long long slot, long long ray, const float (&o)[3],
                                           const float (&d)[3], float t) {
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

__device__ __forceinline__ void read_ray(const PackArgs& a, long long ray, float (&o)[3], float (&d)[3]) {
  const float* row = a.rays + ray * a.ray_stride;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    o[axis] = row[axis];
    d[axis] = row[3 + axis];
  }
}

// Adds ray i's kept count to total, and to before when i < first.
__device__ __forceinline__ void tally(long long i, int c, const PackArgs& a, long long first, long long& before,
                                      long long& total) {
  const int kept = min(c, a.samples);
  total += kept;
  if (i < first) before += kept;
}

__global__ void __launch_bounds__(kPackThreads) pool_pack_kernel(const PackArgs a) {
  __shared__ long long partial[kPackThreads / 32][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * a.rays_per_block;
  const long long last = min(first + a.rays_per_block, a.n);

  // 1. The kept counts of the rays before this block's and of all rays, in
  // one pass of 16-byte loads over the counts (a scalar head and tail).
  long long before = 0, total = 0;
  const long long head = min(static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(a.count) & 15)) & 15) / 4,
                             a.n);
  const long long body = (a.n - head) / 4;
  const int4* quads = reinterpret_cast<const int4*>(a.count + head);
#pragma unroll 4
  for (long long q = threadIdx.x; q < body; q += kPackThreads) {
    const int4 c = __ldg(quads + q);
    const long long i = head + 4 * q;
    tally(i, c.x, a, first, before, total);
    tally(i + 1, c.y, a, first, before, total);
    tally(i + 2, c.z, a, first, before, total);
    tally(i + 3, c.w, a, first, before, total);
  }
  if (threadIdx.x < head) tally(threadIdx.x, __ldg(a.count + threadIdx.x), a, first, before, total);
  for (long long i = head + 4 * body + threadIdx.x; i < a.n; i += kPackThreads) {
    tally(i, __ldg(a.count + i), a, first, before, total);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    before += __shfl_xor_sync(kFullMask, before, offset);
    total += __shfl_xor_sync(kFullMask, total, offset);
  }
  if (lane == 0) {
    partial[warp][0] = before;
    partial[warp][1] = total;
  }
  __syncthreads();
  before = total = 0;
#pragma unroll
  for (int w = 0; w < kPackThreads / 32; ++w) {
    before += partial[w][0];
    total += partial[w][1];
  }

  // 2. This block's rays, kPackChunk at a time: every warp scans the chunk's
  // kept counts, and lane group g writes the survivors of the chunk's ray g.
  const int group = threadIdx.x / kPackGroup;
  const int sub = threadIdx.x % kPackGroup;
  long long carry = before;  // slots of the rays before the chunk
  for (long long chunk = first; chunk < last; chunk += kPackChunk) {
    const int kept = chunk + lane < last ? min(__ldg(a.count + chunk + lane), a.samples) : 0;
    int inclusive = kept;
#pragma unroll
    for (int offset = 1; offset < 32; offset <<= 1) {
      const int other = __shfl_up_sync(kFullMask, inclusive, offset);
      if (lane >= offset) inclusive += other;
    }
    const int mine = __shfl_sync(kFullMask, kept, group);
    const long long end = carry + __shfl_sync(kFullMask, inclusive, group);
    carry += __shfl_sync(kFullMask, inclusive, 31);
    const long long ray = chunk + group;
    if (ray >= last) continue;
    if (sub == 0) a.starts[ray + 1] = static_cast<int>(min(end, a.budget));
    const long long start = end - mine;
    if (start >= a.budget) continue;
    float o[3], d[3];
    read_ray(a, ray, o, d);
    const float* ts = a.ts + ray * a.samples;
    for (int j = sub; j < mine && start + j < a.budget; j += kPackGroup) write_slot(a, start + j, ray, o, d, ts[j]);
  }

  // 3. The tail, shared among the blocks: the last ray at t = 0.
  const long long stride = static_cast<long long>(gridDim.x) * kPackThreads;
  long long i = total + static_cast<long long>(blockIdx.x) * kPackThreads + threadIdx.x;
  if (i < a.budget) {
    float o[3], d[3];
    read_ray(a, a.n - 1, o, d);
    for (; i < a.budget; i += stride) write_slot(a, i, a.n - 1, o, d, 0.0f);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.starts[0] = 0;
    *a.selected = total;
    *a.dropped = max(total - a.budget, 0LL);
  }
}

}  // namespace nerf

// rays: n rows of (origin, direction), ray_stride floats apart; u [n, c];
// words: the cells' bits (density > threshold) packed 4 x 4 x 2 to a word,
// ceil(r / 4)^2 * ceil(r / 2) of them, read when eps = 0; densities [r^3]
// f32, read when eps > 0 (null otherwise allowed), tested against
// threshold; inv_x, inv_y, inv_z the f32 reciprocals of the bbox sides hi -
// lo (each side in [2^-60, 2^60]); span_lo, span_hi [n] f32 and span_hit
// [n] bytes, all three null without a span.  ts [n, k], sample_mask [n, k]
// bytes, dt [n], mask [n] bytes and count [n] int32 are written, and points
// [n, k, 3] unless null.  1 <= k, 1 <= c, c * k < 2^31, r^3 < 2^31, c / 32
// words in 48 KiB.  Launches on the given stream and returns the
// cudaError_t of the launch.
extern "C" int nerf_select_strided(const float* rays, long long ray_stride, const float* u,
                                   const unsigned int* words, const float* densities, const float* span_lo,
                                   const float* span_hi, const unsigned char* span_hit, long long n, int c, int k,
                                   int r, float lo_x, float lo_y, float lo_z, float hi_x, float hi_y, float hi_z,
                                   float threshold, int warm, float min_t_range, float eps, float inv_candidates,
                                   float inv_samples, float inv_x, float inv_y, float inv_z, float* ts,
                                   unsigned char* sample_mask, float* dt, unsigned char* mask, int* count,
                                   float* points, void* stream) {
  using namespace nerf;
  const int ballot_words = (c + 31) / 32;
  if (c < 1 || k < 1 || r < 1 || static_cast<long long>(c) * k >= (1LL << 31) ||
      static_cast<long long>(r) * r * r >= (1LL << 31) || ballot_words * 4 > kSelectSharedBytes ||
      words == nullptr || (eps > 0.0f && densities == nullptr) || (span_lo == nullptr) != (span_hi == nullptr) ||
      (span_lo == nullptr) != (span_hit == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int warps = kSelectWarps;
  while (warps > 1 && warps * ballot_words * 4 > kSelectSharedBytes) warps /= 2;
  const SelectArgs a{rays, u, words, densities, span_lo, span_hi, span_hit, n, ray_stride, c, k, r, warm,
                     {lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}, threshold, min_t_range, eps, inv_candidates, inv_samples,
                     {inv_x, inv_y, inv_z}, ts, sample_mask, dt, mask, count, points};
  const long long blocks = (n + warps - 1) / warps;
  auto* kernel = eps > 0.0f ? select_strided_kernel<true> : select_strided_kernel<false>;
  kernel<<<static_cast<unsigned int>(blocks), warps * 32, warps * ballot_words * 4,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// rays as above; ts [n, k] f32 and count [n] int32 (the selection's, not
// clamped) on the device; pool_t, pool_ray (int64), points and dirs [budget,
// 3], starts [n + 1] (int32) and the 0-dim int64 selected and dropped are
// written.  n >= 1, 1 <= budget < 2^31.
extern "C" int nerf_pool_pack(const float* rays, long long ray_stride, const float* ts, const int* count,
                              long long n, int k, long long budget, float* pool_t, long long* pool_ray,
                              float* points, float* dirs, int* starts, long long* selected, long long* dropped,
                              void* stream) {
  using namespace nerf;
  if (n < 1 || k < 1 || budget < 1 || budget >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n + kPackChunk - 1) / kPackChunk;
  const long long rays_per_block = kPackChunk * ((chunks + kPackBlocks - 1) / kPackBlocks);
  const PackArgs a{rays, ts, count, n, ray_stride, budget, rays_per_block, k, pool_t, pool_ray, points, dirs,
                   starts, selected, dropped};
  const long long blocks = (n + rays_per_block - 1) / rays_per_block;
  pool_pack_kernel<<<static_cast<unsigned int>(blocks), kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
