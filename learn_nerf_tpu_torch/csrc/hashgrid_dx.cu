// The hash-grid encoding's gradient in the points, and that gradient's own
// backward, with a plain C interface for ctypes
// (learn_nerf_tpu_torch/kernels/build.py).
//
// hashgrid_dx_kernel computes the vector-Jacobian product of the JAX
// package's hash_grid_encode in its points (learn_nerf_tpu/ops/hashgrid.py:
// 135 under jax.vjp at learn_nerf_tpu/models/ref_nerf.py:71-74, which XLA
// differentiates: Ref-NeRF's normal is the VJP of the density channel):
// for points x [N, 3], a cotangent g [N, L*F] and L levels of f32 tables
// [rows_l, F],
//   dx[p, a] = sum_l sum_c dw_c/dx_a * <g[p, l*F:(l+1)*F], T_l[row_c]>
// over the 8 corners c of point p's cell in level l.
//
// hashgrid_dx_backward_kernel is that function's VJP in g and the tables
// (jax.grad through the jax.vjp, for Ref-NeRF's normal loss): for a
// cotangent h [N, 3] and a_c = grad(w_c) . h_p,
//   grad_g[p, l*F + f] = sum_c a_c T_l[row_c, f]      (the encode with weights a_c)
//   grad_T_l[row_c, f] += a_c g[p, l*F + f]            (the table gradient with them)
// in one launch: a thread holds its cell's corners once for both.
//
// The derivative of a corner weight: w_c is a product of one factor per
// axis, cf or 1 - cf, so dw_c/dx_a is that product with axis a's factor
// replaced by +-slope_a, where slope_a = clip'(frac_a) * scale / (hi_a -
// lo_a) (scale = g - 2 in smooth mode, g - 1 otherwise), times the
// smoothstep's derivative 6c(1 - c) in smooth mode.  clip' is jnp.clip's
// gradient: 1 inside (0, 1), 1/2 where the clipped value is exactly 0 or
// 1 (jnp.clip is a max and a min, and JAX splits the gradient of a tie),
// 0 outside.  floor has no gradient.
//
// Cells, rows and weights come from hashgrid.cuh (cell_of, corner_row), as
// in the encode and table-gradient kernels, so rows are bit-equal to the
// forward's; every f32 step is an _rn intrinsic, so nvcc contracts no FMA
// and the slopes are the plain version's (ops/hashgrid.py,
// corner_weight_gradients) step for step.
//
// What bounds them on an H100: as the encode, row reads from L2 (8 random
// rows a point and level), and for the backward also the atomics of the
// table gradient (8 a point and level), as hashgrid_backward.  Each kernel
// takes the layout and the levers of the kernel it resembles:
// - hashgrid_dx: the encode kernel's (hashgrid_encode.cu).  One thread a
//   (point, work item), a point's items on consecutive threads, a block of
//   floor(256 / items) whole points; each thread reads its 8 rows a level
//   with gather.cuh's load_corners (without the encode's pair loads:
//   kPairLoads) and its K * F columns of g as one vector (a float4 at K =
//   F = 2, so a warp reads g in whole lines), and writes its per-level
//   terms (3 floats a level) to shared memory.  After one barrier a thread a (point, axis) sums the terms over
//   levels 0..L-1 in order from 0.0f: the sum of a thread a point over all
//   levels (the first design, csrc/ablations/hashgrid_dx_parent.cu), bit
//   for bit.  The table-gradient kernel's warp-per-item layout was 3-9 %
//   slower for the encode, which reads the same rows, and is not taken.
//   A schedule of dense levels alone (the hierarchy's coarse model) keeps
//   the first design's thread a point over all levels, g read as vectors:
//   its tables are small and neighbouring samples share rows, which
//   the lanes of one instruction read together where a warp holds 32
//   points of one level; the encode's grid lost there (PERF.md, section 6);
// - the backward: the table-gradient kernel's (encode_args.cuh: a block
//   tile of kTilePoints consecutive points, a warp a work item, a lane a
//   point).  x, h and the tile's slab of g are staged in shared memory
//   from whole lines; a lane reads its item's columns of g from the slab
//   and writes its columns of grad_g in their place, and the slab goes out
//   in whole lines.  Rows are read as in the forward, and one read of a
//   row serves both grad_g and the table gradient; a_c * g goes through
//   table_atomics.cuh's tail (run combining, pair atomics) into
//   hashgrid_backward's padded flat buffer.  grad_g is summed as in the
//   first design, bit for bit; the table gradients are f32 atomics, whose
//   order changes from run to run.
// scripts/hashgrid_ablations.py times the first design and this one with
// pair loads, without combining, without pair atomics, at 3 blocks a SM
// and with the encode's grid for every schedule.
#include <cstdint>

#include "encode_args.cuh"
#include "gather.cuh"
#include "table_atomics.cuh"

namespace nerf {
namespace {

// The encode's pair loads (gather.cuh's load_corners) are off: they made
// the forward 3-8 % slower at every shape on an H100 and moved the backward
// by -1 to +3 % (PERF.md, section 6); scripts/hashgrid_ablations.py times
// them ("dx pair loads").
constexpr bool kPairLoads = false;
constexpr bool kPairAtomics = true;
constexpr bool kCombineRuns = true;
constexpr int kDxThreads = 256;
// Shared floats of the forward's level terms: (3 * levels) | 1 a point, at
// most floor(256 / items) points, and levels <= 2 * items.
constexpr int kDxTermFloats = 7 * kDxThreads;

// d cf_a / d x_a for each axis a, as JAX differentiates cell_of's steps.
__device__ __forceinline__ void cell_slopes(const float (&x)[3], int g, const Bbox& box, bool smooth,
                                            float (&slope)[3]) {
  const float scale = static_cast<float>(smooth ? g - 2 : g - 1);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float span = __fsub_rn(box.hi[a], box.lo[a]);
    const float raw = __fdiv_rn(__fsub_rn(x[a], box.lo[a]), span);
    const float clip = (raw > 0.0f && raw < 1.0f) ? 1.0f : ((raw == 0.0f || raw == 1.0f) ? 0.5f : 0.0f);
    float s = __fmul_rn(clip, __fdiv_rn(scale, span));
    if (smooth) {
      const float frac = fminf(fmaxf(raw, 0.0f), 1.0f);
      const float findex = __fadd_rn(0.5f, __fmul_rn(scale, frac));
      const float floored = fminf(floorf(findex), static_cast<float>(g - 2));
      const float c = __fsub_rn(findex, floored);
      s = __fmul_rn(s, __fmul_rn(__fmul_rn(6.0f, c), __fsub_rn(1.0f, c)));
    }
    slope[a] = s;
  }
}

// The gradient of corner c's weight in the point.
__device__ __forceinline__ void weight_gradient(const Cell& cell, const float (&slope)[3], int c,
                                                float (&out)[3]) {
  const bool bx = (c >> 2) & 1, by = (c >> 1) & 1, bz = c & 1;
  const float wx = bx ? cell.cf[0] : __fsub_rn(1.0f, cell.cf[0]);
  const float wy = by ? cell.cf[1] : __fsub_rn(1.0f, cell.cf[1]);
  const float wz = bz ? cell.cf[2] : __fsub_rn(1.0f, cell.cf[2]);
  const float dx = bx ? slope[0] : -slope[0];
  const float dy = by ? slope[1] : -slope[1];
  const float dz = bz ? slope[2] : -slope[2];
  out[0] = __fmul_rn(__fmul_rn(dx, wy), wz);
  out[1] = __fmul_rn(__fmul_rn(wx, dy), wz);
  out[2] = __fmul_rn(__fmul_rn(wx, wy), dz);
}

// The rows of a cell's 8 corners in level l0's lattice, and the slopes.
__device__ __forceinline__ Cell corner_rows(const float (&x)[3], const EncodeArgs& a, int l0,
                                            unsigned int (&rows)[8], float (&slope)[3]) {
  const int g = a.grid[l0];
  const bool smooth = a.smooth != 0;
  const Cell cell = cell_of(x, g, a.box, smooth);
  cell_slopes(x, g, a.box, smooth, slope);
  const unsigned int size = a.size[l0];
  const bool hashed = a.hashed[l0] != 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) rows[c] = corner_row(cell, c, static_cast<unsigned int>(g), size, hashed);
  return cell;
}

// The terms dx_l of the K levels from l0 on (3 floats a level, each summed
// over corners 0..7 from 0.0f; gp: the point's row of g at column l0 * F).
template <int F, int K>
__device__ __forceinline__ void dx_terms(const float (&x)[3], const EncodeArgs& a, int l0,
                                         const float* __restrict__ gp, float (&terms)[K][3]) {
  unsigned int rows[8];
  float slope[3];
  const Cell cell = corner_rows(x, a, l0, rows, slope);
  Row<F> v[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k) load_corners<F>(a.table[l0 + k], rows, kPairLoads && a.paired[l0 + k] != 0, v[k]);
  float gk[K * F];
  load_floats<K * F>(gp, gk);
  float grad[8][3];
#pragma unroll
  for (int c = 0; c < 8; ++c) weight_gradient(cell, slope, c, grad[c]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) terms[k][ax] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float dot = __fmul_rn(v[k][c].v[0], gk[k * F]);
#pragma unroll
      for (int f = 1; f < F; ++f) dot = __fadd_rn(dot, __fmul_rn(v[k][c].v[f], gk[k * F + f]));
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) terms[k][ax] = __fadd_rn(terms[k][ax], __fmul_rn(grad[c][ax], dot));
    }
  }
}

// One (point, item) thread's terms into its slots of the block's shared
// memory (slot: the point's row at level l0).
template <int F, int K>
__device__ __forceinline__ void dx_item(const float (&x)[3], const EncodeArgs& a, int l0,
                                        const float* __restrict__ gp, float* slot) {
  float terms[K][3];
  dx_terms<F, K>(x, a, l0, gp, terms);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) slot[3 * k + ax] = terms[k][ax];
  }
}

template <int F>
__global__ void __launch_bounds__(kDxThreads)
    hashgrid_dx_kernel(const float* __restrict__ x, const float* __restrict__ g, long long n,
                       const __grid_constant__ EncodeArgs a, float* __restrict__ out) {
  __shared__ float terms[kDxTermFloats];  // [points, stride]: level l's 3 terms at 3 * l
  const int items = a.items, points = kDxThreads / items, stride = (3 * a.levels) | 1;
  const long long base = static_cast<long long>(blockIdx.x) * points;
  const int count = static_cast<int>(n - base < points ? n - base : points);
  const int local = threadIdx.x / items;
  if (local < count) {  // the last block's threads past n only meet the barrier
    const int item = threadIdx.x - local * items;
    const float* xp = x + 3 * (base + local);
    const float point[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
    const int l0 = a.item_level[item];
    const float* gp = g + (base + local) * (a.levels * F) + l0 * F;
    float* slot = terms + local * stride + 3 * l0;
    if (a.item_levels[item] == kLevelsPerItem) {
      dx_item<F, kLevelsPerItem>(point, a, l0, gp, slot);
    } else {
      dx_item<F, 1>(point, a, l0, gp, slot);
    }
  }
  __syncthreads();
  // dx[p, ax]: the levels' terms in level order from 0.0f.
  for (int i = threadIdx.x; i < 3 * count; i += blockDim.x) {
    const int q = i / 3;
    const float* t = terms + q * stride + (i - 3 * q);
    float sum = 0.0f;
    for (int l = 0; l < a.levels; ++l) sum = __fadd_rn(sum, t[3 * l]);
    out[3 * base + i] = sum;
  }
}

// dx += the terms of the K levels from l0 on, in level order.
template <int F, int K>
__device__ __forceinline__ void dx_add(const float (&x)[3], const EncodeArgs& a, int l0,
                                       const float* __restrict__ gp, float (&dx)[3]) {
  float terms[K][3];
  dx_terms<F, K>(x, a, l0, gp, terms);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) dx[ax] = __fadd_rn(dx[ax], terms[k][ax]);
  }
}

// The first design's layout, for schedules of dense levels alone (see
// launch_dx): a thread a point over all levels in order, dx in registers.
template <int F>
__global__ void __launch_bounds__(kDxThreads)
    hashgrid_dx_points_kernel(const float* __restrict__ x, const float* __restrict__ g, long long n,
                              const __grid_constant__ EncodeArgs a, float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * kDxThreads + threadIdx.x;
  if (p >= n) return;
  const float* xp = x + 3 * p;
  const float point[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
  const float* gp = g + p * (a.levels * F);
  float dx[3] = {0.0f, 0.0f, 0.0f};
  for (int item = 0; item < a.items; ++item) {
    const int l0 = a.item_level[item];
    if (a.item_levels[item] == kLevelsPerItem) {
      dx_add<F, kLevelsPerItem>(point, a, l0, gp + l0 * F, dx);
    } else {
      dx_add<F, 1>(point, a, l0, gp + l0 * F, dx);
    }
  }
  float* dst = out + 3 * p;
  dst[0] = dx[0], dst[1] = dx[1], dst[2] = dx[2];
}

// Each level's gradient buffer [rows_l, F] (views of one flat buffer).
struct LevelGrads {
  float* level[kMaxLevels];
};

// One lane's point in the K levels from l0 on.  `active` is false for the
// lanes past the tile's last point: they take part in the shuffles and add
// nothing.  slab is the point's row of the staged tile at column l0 * F: g
// on the way in, grad_g on the way out.
template <int F, int K>
__device__ __forceinline__ void dx_backward_item(bool active, const float (&x)[3], const float (&h)[3],
                                                 const EncodeArgs& a, const LevelGrads& grads, int l0,
                                                 float* slab) {
  unsigned int rows[8];
  float slope[3];
  const Cell cell = corner_rows(x, a, l0, rows, slope);
  Row<F> v[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k) load_corners<F>(a.table[l0 + k], rows, kPairLoads && a.paired[l0 + k] != 0, v[k]);
  float w[8];  // a_c = grad(w_c) . h
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float grad[3];
    weight_gradient(cell, slope, c, grad);
    w[c] = __fadd_rn(__fadd_rn(__fmul_rn(grad[0], h[0]), __fmul_rn(grad[1], h[1])), __fmul_rn(grad[2], h[2]));
  }
  float gk[K * F];
#pragma unroll
  for (int i = 0; i < K * F; ++i) gk[i] = active ? slab[i] : 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float acc = __fmul_rn(w[0], v[k][0].v[f]);
#pragma unroll
      for (int c = 1; c < 8; ++c) acc = __fadd_rn(acc, __fmul_rn(w[c], v[k][c].v[f]));
      if (active) slab[k * F + f] = acc;
    }
  }
  float t[8][K * F];  // t[c][k * F + f] = a_c * g[k * F + f]
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int i = 0; i < K * F; ++i) t[c][i] = __fmul_rn(w[c], gk[i]);
  }
  bool adds = active;
  if constexpr (kCombineRuns) adds = combine_runs<K * F>(active, cell, t);
  if (!adds) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    add_corners<F, K * F, kPairAtomics>(grads.level[l0 + k], rows, t, k, a.paired[l0 + k] != 0);
  }
}

template <int F>
__global__ void __launch_bounds__(kTileThreads)
    hashgrid_dx_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                const float* __restrict__ h, long long n, long long tiles,
                                const __grid_constant__ EncodeArgs a,
                                const __grid_constant__ LevelGrads grads, float* __restrict__ grad_g) {
  extern __shared__ __align__(16) float smem[];
  const int width = a.levels * F, stride = tile_stride(width);
  float* xs = smem;                     // [kTilePoints, 3]
  float* hs = smem + 3 * kTilePoints;   // [kTilePoints, 3]
  float* tile = hs + 3 * kTilePoints;   // [kTilePoints, stride]: g in, grad_g out
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = a.items * kTileChunks;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * kTilePoints;
    const int count = static_cast<int>(n - base < kTilePoints ? n - base : kTilePoints);
    for (int i = threadIdx.x; i < 3 * count; i += blockDim.x) {
      xs[i] = __ldg(x + 3 * base + i);
      hs[i] = __ldg(h + 3 * base + i);
    }
    // The tile's slabs of g and grad_g are contiguous: count * width floats.
    const float* src = g + base * width;
    for (int e = threadIdx.x; e < count * width; e += blockDim.x) {
      const int row = e / width;
      tile[row * stride + (e - row * width)] = __ldg(src + e);
    }
    __syncthreads();
    for (int u = warp; u < units; u += warps) {  // the same for all lanes of a warp
      const int chunk = kTileChunks == 1 ? 0 : u / a.items;
      const int item = u - chunk * a.items;
      const int p = 32 * chunk + lane;
      const bool active = p < count;
      const float point[3] = {active ? xs[3 * p] : 0.0f, active ? xs[3 * p + 1] : 0.0f,
                              active ? xs[3 * p + 2] : 0.0f};
      const float cot[3] = {active ? hs[3 * p] : 0.0f, active ? hs[3 * p + 1] : 0.0f,
                            active ? hs[3 * p + 2] : 0.0f};
      const int l0 = a.item_level[item];
      float* slab = tile + p * stride + l0 * F;
      if (a.item_levels[item] == kLevelsPerItem) {
        dx_backward_item<F, kLevelsPerItem>(active, point, cot, a, grads, l0, slab);
      } else {
        dx_backward_item<F, 1>(active, point, cot, a, grads, l0, slab);
      }
    }
    __syncthreads();
    float* dst = grad_g + base * width;
    for (int e = threadIdx.x; e < count * width; e += blockDim.x) {
      const int row = e / width;
      dst[e] = tile[row * stride + (e - row * width)];
    }
    __syncthreads();  // the next tile overwrites xs, hs and the slab
  }
}

// Does every level index its table densely?  Then the tables are small
// and neighbouring samples share rows, which lanes of one instruction read
// together where a warp holds 32 points of one level: the first design's
// thread a point is faster there (the hierarchy's coarse pass, PERF.md
// section 6), the encode's grid wherever a level hashes.
bool dense_only(const EncodeArgs& a) {
  for (int l = 0; l < a.levels; ++l) {
    if (a.hashed[l]) return false;
  }
  return true;
}

template <int F>
cudaError_t launch_dx(const float* x, const float* g, long long n, const EncodeArgs& a, float* out,
                      cudaStream_t stream) {
  if (dense_only(a)) {
    const unsigned int blocks = static_cast<unsigned int>((n + kDxThreads - 1) / kDxThreads);
    hashgrid_dx_points_kernel<F><<<blocks, kDxThreads, 0, stream>>>(x, g, n, a, out);
    return cudaGetLastError();
  }
  const int points = kDxThreads / a.items;
  const unsigned int blocks = static_cast<unsigned int>((n + points - 1) / points);
  hashgrid_dx_kernel<F><<<blocks, points * a.items, 0, stream>>>(x, g, n, a, out);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_dx_backward(const float* x, const float* g, const float* h, long long n,
                               long long tiles, const EncodeArgs& a, const LevelGrads& grads,
                               float* grad_g, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * kTilePoints + tile_floats(a.levels * F));
  hashgrid_dx_backward_kernel<F><<<static_cast<unsigned int>(tiles), tile_block_threads(a.items), smem,
                                   stream>>>(x, g, h, n, tiles, a, grads, grad_g);
  return cudaGetLastError();
}

bool valid_args(const EncodeArgs& a) {
  return a.levels >= 1 && a.levels <= kMaxLevels && a.items >= 1 && a.items <= a.levels &&
         a.levels <= 2 * a.items && a.features >= 1 && a.features <= 4;
}

}  // namespace
}  // namespace nerf

// x [n, 3], g [n, levels * features] and dx [n, 3], f32 on the device;
// args in host memory (the encode kernel's, with the tables' pointers).
// Launches on the given stream, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).  The caller checks shapes, the
// tables' dtype and alignment, and n < 2^31.
extern "C" int nerf_hashgrid_dx(const float* x, const float* g, long long n, const nerf::EncodeArgs* args,
                                float* dx, void* stream) {
  using namespace nerf;
  const EncodeArgs& a = *args;
  if (!valid_args(a) || n >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.features) {
    case 1: return static_cast<int>(launch_dx<1>(x, g, n, a, dx, s));
    case 2: return static_cast<int>(launch_dx<2>(x, g, n, a, dx, s));
    case 3: return static_cast<int>(launch_dx<3>(x, g, n, a, dx, s));
    default: return static_cast<int>(launch_dx<4>(x, g, n, a, dx, s));
  }
}

// x [n, 3], g [n, levels * features], h [n, 3] and grad_g [n, levels *
// features] f32 on the device; args as for nerf_hashgrid_dx (the tables
// are read); grad is one zeroed f32 buffer, aligned to 16 bytes, laid out
// as nerf_hashgrid_backward's (level l from an even row on; rows of odd
// count padded by one).  Launches on the given stream, does not
// synchronise, returns the cudaError_t of the launch.  The caller checks
// shapes and that the tiles of kTilePoints points number under 2^31.
extern "C" int nerf_hashgrid_dx_backward(const float* x, const float* g, const float* h, long long n,
                                         const nerf::EncodeArgs* args, float* grad_g, float* grad,
                                         void* stream) {
  using namespace nerf;
  const EncodeArgs& a = *args;
  const long long tiles = (n + kTilePoints - 1) / kTilePoints;
  if (!valid_args(a) || n < 0 || tiles >= (1ll << 31) || reinterpret_cast<uintptr_t>(grad) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  LevelGrads grads;
  unsigned long long row = 0;
  for (int l = 0; l < a.levels; ++l) {
    grads.level[l] = grad + row * a.features;
    const unsigned long long rows = level_rows(a, l);
    row += rows + (rows & 1ull);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.features) {
    case 1: return static_cast<int>(launch_dx_backward<1>(x, g, h, n, tiles, a, grads, grad_g, s));
    case 2: return static_cast<int>(launch_dx_backward<2>(x, g, h, n, tiles, a, grads, grad_g, s));
    case 3: return static_cast<int>(launch_dx_backward<3>(x, g, h, n, tiles, a, grads, grad_g, s));
    default: return static_cast<int>(launch_dx_backward<4>(x, g, h, n, tiles, a, grads, grad_g, s));
  }
}
