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
// table gradient (8 a point and level), as hashgrid_backward.  This first
// design is the simple one:
// - hashgrid_dx: one thread a point, over all levels in order (the sum
//   over levels stays in registers, in the plain version's order, with no
//   atomics and no second pass); a work item of two levels of one run
//   (encode_args.cuh) computes its cell once and issues its 16 row loads
//   before the first multiply-add;
// - the backward: one thread a (point, work item), as the encode kernel,
//   its grad_g columns written by that thread alone, one atomic a corner
//   row (a vector atomic of F floats at F = 2 and 4) into the
//   table-gradient kernel's padded flat buffer.
// The pair loads, pair atomics and run combining of the encode and
// table-gradient kernels are left for a later redesign.
#include <cstdint>

#include "encode_args.cuh"
#include "gather.cuh"

namespace nerf {
namespace {

constexpr int kDxThreads = 256;

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

// dx += the K levels from l0 on (gp: the point's row of g).
template <int F, int K>
__device__ __forceinline__ void dx_item(const float (&x)[3], const EncodeArgs& a, int l0,
                                        const float* __restrict__ gp, float (&dx)[3]) {
  unsigned int rows[8];
  float slope[3];
  const Cell cell = corner_rows(x, a, l0, rows, slope);
  Row<F> v[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < 8; ++c) v[k][c] = load_row<F>(a.table[l0 + k], rows[c]);
  }
  float grad[8][3];
#pragma unroll
  for (int c = 0; c < 8; ++c) weight_gradient(cell, slope, c, grad[c]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float gk[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gk[f] = __ldg(gp + (l0 + k) * F + f);
    float term[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float dot = __fmul_rn(v[k][c].v[0], gk[0]);
#pragma unroll
      for (int f = 1; f < F; ++f) dot = __fadd_rn(dot, __fmul_rn(v[k][c].v[f], gk[f]));
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) term[ax] = __fadd_rn(term[ax], __fmul_rn(grad[c][ax], dot));
    }
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) dx[ax] = __fadd_rn(dx[ax], term[ax]);
  }
}

template <int F>
__global__ void __launch_bounds__(kDxThreads)
    hashgrid_dx_kernel(const float* __restrict__ x, const float* __restrict__ g, unsigned int n,
                       const __grid_constant__ EncodeArgs a, float* __restrict__ out) {
  const unsigned int p = blockIdx.x * kDxThreads + threadIdx.x;
  if (p >= n) return;
  const float* xp = x + 3ull * p;
  const float point[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
  const float* gp = g + static_cast<unsigned long long>(p) * (a.levels * F);
  float dx[3] = {0.0f, 0.0f, 0.0f};
  for (int item = 0; item < a.items; ++item) {
    const int l0 = a.item_level[item];
    if (a.item_levels[item] == kLevelsPerItem) {
      dx_item<F, kLevelsPerItem>(point, a, l0, gp, dx);
    } else {
      dx_item<F, 1>(point, a, l0, gp, dx);
    }
  }
  float* dst = out + 3ull * p;
  dst[0] = dx[0], dst[1] = dx[1], dst[2] = dx[2];
}

// Each level's gradient buffer [rows_l, F] (views of one flat buffer).
struct LevelGrads {
  float* level[kMaxLevels];
};

// grad[row, :] += v[:]: one vector atomic of F floats at F = 2 and 4 (the
// buffer is 16-byte aligned and every level starts at an even row), else
// one scalar atomic a float.
template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ grad, unsigned int row, const float (&v)[F]) {
  float* dst = grad + static_cast<unsigned long long>(row) * F;
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(dst + f, v[f]);
  }
}

template <int F, int K>
__device__ __forceinline__ void dx_backward_item(const float (&x)[3], const float (&h)[3],
                                                 const EncodeArgs& a, const LevelGrads& grads, int l0,
                                                 const float* __restrict__ gp, float* __restrict__ gg) {
  unsigned int rows[8];
  float slope[3];
  const Cell cell = corner_rows(x, a, l0, rows, slope);
  Row<F> v[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < 8; ++c) v[k][c] = load_row<F>(a.table[l0 + k], rows[c]);
  }
  float w[8];  // a_c = grad(w_c) . h
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float grad[3];
    weight_gradient(cell, slope, c, grad);
    w[c] = __fadd_rn(__fadd_rn(__fmul_rn(grad[0], h[0]), __fmul_rn(grad[1], h[1])), __fmul_rn(grad[2], h[2]));
  }
  float out[K * F];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float acc = __fmul_rn(w[0], v[k][0].v[f]);
#pragma unroll
      for (int c = 1; c < 8; ++c) acc = __fadd_rn(acc, __fmul_rn(w[c], v[k][c].v[f]));
      out[k * F + f] = acc;
    }
  }
  store_floats<K * F>(gg + l0 * F, out);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float gk[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gk[f] = __ldg(gp + (l0 + k) * F + f);
    float* grad = grads.level[l0 + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float row[F];
#pragma unroll
      for (int f = 0; f < F; ++f) row[f] = __fmul_rn(w[c], gk[f]);
      add_row<F>(grad, rows[c], row);
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kDxThreads)
    hashgrid_dx_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                const float* __restrict__ h, unsigned int total,
                                const __grid_constant__ EncodeArgs a,
                                const __grid_constant__ LevelGrads grads, float* __restrict__ grad_g) {
  const unsigned int t = blockIdx.x * kDxThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned int items = static_cast<unsigned int>(a.items);
  const unsigned int p = t / items;
  const int item = static_cast<int>(t - p * items);
  const float* xp = x + 3ull * p;
  const float point[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
  const float* hp = h + 3ull * p;
  const float cot[3] = {__ldg(hp), __ldg(hp + 1), __ldg(hp + 2)};
  const unsigned long long row = static_cast<unsigned long long>(p) * (a.levels * F);
  const int l0 = a.item_level[item];
  if (a.item_levels[item] == kLevelsPerItem) {
    dx_backward_item<F, kLevelsPerItem>(point, cot, a, grads, l0, g + row, grad_g + row);
  } else {
    dx_backward_item<F, 1>(point, cot, a, grads, l0, g + row, grad_g + row);
  }
}

template <int F>
cudaError_t launch_dx(const float* x, const float* g, long long n, const EncodeArgs& a, float* out,
                      cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((n + kDxThreads - 1) / kDxThreads);
  hashgrid_dx_kernel<F><<<blocks, kDxThreads, 0, stream>>>(x, g, static_cast<unsigned int>(n), a, out);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_dx_backward(const float* x, const float* g, const float* h, long long n,
                               const EncodeArgs& a, const LevelGrads& grads, float* grad_g,
                               cudaStream_t stream) {
  const long long total = n * a.items;
  const unsigned int blocks = static_cast<unsigned int>((total + kDxThreads - 1) / kDxThreads);
  hashgrid_dx_backward_kernel<F><<<blocks, kDxThreads, 0, stream>>>(
      x, g, h, static_cast<unsigned int>(total), a, grads, grad_g);
  return cudaGetLastError();
}

bool valid_args(const EncodeArgs& a) {
  return a.levels >= 1 && a.levels <= kMaxLevels && a.items >= 1 && a.items <= a.levels &&
         a.features >= 1 && a.features <= 4;
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
// shapes and n * items < 2^31.
extern "C" int nerf_hashgrid_dx_backward(const float* x, const float* g, const float* h, long long n,
                                         const nerf::EncodeArgs* args, float* grad_g, float* grad,
                                         void* stream) {
  using namespace nerf;
  const EncodeArgs& a = *args;
  if (!valid_args(a) || n * a.items >= (1ll << 31) || reinterpret_cast<uintptr_t>(grad) % 16 != 0) {
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
    case 1: return static_cast<int>(launch_dx_backward<1>(x, g, h, n, a, grads, grad_g, s));
    case 2: return static_cast<int>(launch_dx_backward<2>(x, g, h, n, a, grads, grad_g, s));
    case 3: return static_cast<int>(launch_dx_backward<3>(x, g, h, n, a, grads, grad_g, s));
    default: return static_cast<int>(launch_dx_backward<4>(x, g, h, n, a, grads, grad_g, s));
  }
}
