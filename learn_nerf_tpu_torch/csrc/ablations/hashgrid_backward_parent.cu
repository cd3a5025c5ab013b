// The table gradients of the all-level hash-grid encoding in one launch,
// with a plain C interface for ctypes (learn_nerf_tpu_torch/kernels/build.py).
//
// hashgrid_backward_kernel computes the vector-Jacobian product of the JAX
// package's hash_grid_encode in its tables (learn_nerf_tpu/ops/hashgrid.py:
// 198-203 under jax.grad, which XLA lowers to one scatter-add per level):
// for points x [N, 3], the encoding's cotangent g [N, L*F] and L levels,
//   grad_l[row_c, f] += w_c * g[p, l*F + f]
// over the 8 corners c of point p's cell in level l, into L zeroed f32
// buffers [rows_l, F].
//
// It takes the encode kernel's EncodeArgs by value, with the gradient
// buffers' pointers in place of the tables', and recomputes each cell with
// hashgrid.cuh (cell_of, corner_row, corner_weight): rows and weights are
// bit-equal to the forward's, and the forward saves nothing but x.
//
// What bounds it on an H100: atomics in L2.  Its bytes are g, x and the
// gradients once (44 MB, 13 us at 3.35 TB/s, at 131,072 points x the
// 16-level fine schedule, F = 2), but it makes 8 row atomics per point and
// level (16.8 M there), each a read-modify-write of one L2 sector; in the
// coarse dense levels (grid 16: 4,096 rows) some 256 atomics meet on every
// row and serialise, while the hashed levels scatter over the whole table.
// Design (a first version: right and simple):
// - one thread per (point, work item), the encode kernel's layout, so a
//   warp reads a contiguous run of g and two levels of a run share one
//   cell;
// - at F = 2 (and 4) a row takes one vector atomic (red.global.add.v2.f32,
//   new with sm_90) instead of F scalar ones: 1.85 times faster on an H100
//   (scripts/hashgrid_ablations.py times the scalar form);
// - all levels' gradients are views of one flat buffer that the wrapper
//   zeroes with one memset.
// Sums are f32 atomics in an order that changes from run to run: two runs
// agree to rounding, not bit for bit.
#include "encode_args.cuh"

namespace nerf {

constexpr int kBackwardThreads = 256;

// grad[row, :] += w * g[:], as one vector atomic per pair of floats where F
// is even (the buffer is aligned to 8 bytes), else one scalar atomic per
// float.
template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ grad, unsigned int row, float w,
                                        const float* g) {
  float* dst = grad + static_cast<unsigned long long>(row) * F;
  if constexpr (F % 2 == 0) {
#pragma unroll
    for (int f = 0; f < F; f += 2) {
      atomicAdd(reinterpret_cast<float2*>(dst + f),
                make_float2(__fmul_rn(w, g[f]), __fmul_rn(w, g[f + 1])));
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(dst + f, __fmul_rn(w, g[f]));
  }
}

template <int F, int K>
__device__ __forceinline__ void backward_item(const float (&x)[3], const EncodeArgs& a, int l0,
                                              const float* __restrict__ gp) {
  float g[K * F];
#pragma unroll
  for (int i = 0; i < K * F; ++i) g[i] = __ldg(gp + i);
  const int grid = a.grid[l0];
  const Cell cell = cell_of(x, grid, a.box, a.smooth != 0);
  const unsigned int size = a.size[l0];
  const bool hashed = a.hashed[l0] != 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned int row = corner_row(cell, c, static_cast<unsigned int>(grid), size, hashed);
    const float w = corner_weight(cell, c);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      add_row<F>(const_cast<float*>(a.table[l0 + k]), row, w, g + k * F);
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kBackwardThreads)
    hashgrid_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                             unsigned int total, const __grid_constant__ EncodeArgs a) {
  const unsigned int t = blockIdx.x * kBackwardThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned int items = static_cast<unsigned int>(a.items);
  const unsigned int p = t / items;
  const int item = static_cast<int>(t - p * items);
  const float* xp = x + 3ull * p;
  const float point[3] = {xp[0], xp[1], xp[2]};
  const int l0 = a.item_level[item];
  const float* gp = g + static_cast<unsigned long long>(p) * (a.levels * F) + l0 * F;
  if (a.item_levels[item] == kLevelsPerItem) {
    backward_item<F, kLevelsPerItem>(point, a, l0, gp);
  } else {
    backward_item<F, 1>(point, a, l0, gp);
  }
}

template <int F>
cudaError_t launch_backward(const float* x, const float* g, long long n, const EncodeArgs& a,
                            cudaStream_t stream) {
  const long long total = n * a.items;
  if (total >= (1ll << 31)) return cudaErrorInvalidValue;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kBackwardThreads - 1) / kBackwardThreads);
  hashgrid_backward_kernel<F><<<blocks, kBackwardThreads, 0, stream>>>(
      x, g, static_cast<unsigned int>(total), a);
  return cudaGetLastError();
}

}  // namespace nerf

// x [n, 3] f32 and g [n, levels * features] f32 on the device; args in host
// memory, as for nerf_hashgrid_encode (its table pointers are not read);
// grad is one zeroed f32 buffer on the device that holds level l's
// gradient [rows_l, features] at the float offset features * (rows of the
// levels before l), rows_l = grid^3 in a dense level and the table size in
// a hashed one; it must be aligned to 8 bytes.  Launches on the given
// stream, does not synchronise, and returns the cudaError_t of the launch (0
// on success).  The caller checks shapes and n * items < 2^31.
extern "C" int nerf_hashgrid_backward(const float* x, const float* g, long long n,
                                      const nerf::EncodeArgs* args, float* grad, void* stream) {
  using namespace nerf;
  EncodeArgs a = *args;
  if (a.levels < 1 || a.levels > kMaxLevels || a.items < 1 || a.items > a.levels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  unsigned long long offset = 0;
  for (int l = 0; l < a.levels; ++l) {
    a.table[l] = grad + offset;
    const unsigned long long g3 = static_cast<unsigned long long>(a.grid[l]) * a.grid[l] * a.grid[l];
    offset += (a.hashed[l] ? a.size[l] : g3) * a.features;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.features) {
    case 1: return static_cast<int>(launch_backward<1>(x, g, n, a, s));
    case 2: return static_cast<int>(launch_backward<2>(x, g, n, a, s));
    case 3: return static_cast<int>(launch_backward<3>(x, g, n, a, s));
    case 4: return static_cast<int>(launch_backward<4>(x, g, n, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
