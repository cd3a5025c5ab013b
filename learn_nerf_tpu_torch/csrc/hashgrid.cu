// Hash-grid corner indices and trilinear weights for all levels in one
// launch, with a plain C interface for ctypes
// (learn_nerf_tpu_torch/kernels/build.py).
//
// hashgrid_corners_kernel is the forward index half of the hash-grid
// encoding, which the JAX package leaves to XLA:
//   learn_nerf_tpu/ops/hashgrid.py:43-99 (corner_weights_and_coords +
//   level_indices).
// For points x [N, 3] and L levels it writes idx [L, N, 8] int32 (the
// table row of each cell corner) and w [L, N, 8] f32 (the corner's
// trilinear weight), computed by the corner math of hashgrid.cuh, which the
// all-level encode kernel (hashgrid_encode.cu) shares: indices bit-equal to
// the plain version's.  The serving path runs the encode kernel, which
// keeps indices and weights in registers; this kernel is for what needs
// them in memory (the hash-grid backward).
//
// What bounds it on an H100: the stores.  Each (level, point) writes 64
// bytes and reads 12; the arithmetic is a few dozen instructions.  Design:
// one thread per (level, point), threads of a block on consecutive points
// of one level, each writing its 8 indices and 8 weights as four 16-byte
// stores, so a warp's stores cover contiguous memory.
#include "hashgrid.cuh"

namespace nerf {

constexpr int kCornerThreads = 256;

struct Levels {
  int grid[kMaxLevels];
  unsigned int table[kMaxLevels];
  int hashed[kMaxLevels];  // grid^3 > table
};

__global__ void __launch_bounds__(kCornerThreads)
    hashgrid_corners_kernel(const float* __restrict__ x, long long n, int levels,
                            const __grid_constant__ Levels lv,
                            const __grid_constant__ Bbox box, int smooth,
                            int* __restrict__ idx, float* __restrict__ w) {
  const long long t = static_cast<long long>(blockIdx.x) * kCornerThreads + threadIdx.x;
  if (t >= n * levels) return;
  const int level = static_cast<int>(t / n);
  const long long p = t - static_cast<long long>(level) * n;
  const int g = lv.grid[level];
  const float xp[3] = {__ldg(x + p * 3), __ldg(x + p * 3 + 1), __ldg(x + p * 3 + 2)};
  const Cell cell = cell_of(xp, g, box, smooth != 0);

  const unsigned int table = lv.table[level];
  const bool hashed = lv.hashed[level] != 0;
  int rows[8];
  float weights[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    rows[c] = static_cast<int>(corner_row(cell, c, static_cast<unsigned int>(g), table, hashed));
    weights[c] = corner_weight(cell, c);
  }
  int4* idx_out = reinterpret_cast<int4*>(idx + t * 8);
  idx_out[0] = make_int4(rows[0], rows[1], rows[2], rows[3]);
  idx_out[1] = make_int4(rows[4], rows[5], rows[6], rows[7]);
  float4* w_out = reinterpret_cast<float4*>(w + t * 8);
  w_out[0] = make_float4(weights[0], weights[1], weights[2], weights[3]);
  w_out[1] = make_float4(weights[4], weights[5], weights[6], weights[7]);
}

}  // namespace nerf

// grid_sizes, table_sizes and hashed (1 where grid^3 > table) are host
// arrays of `levels` entries; they go to the kernel by value.  Launches on
// the given stream, does not synchronise, and returns the cudaError_t of
// the launch (0 on success).
extern "C" int nerf_hashgrid_corners(const float* x, long long n, const int* grid_sizes,
                                     const int* table_sizes, const int* hashed, int levels,
                                     float lo_x, float lo_y, float lo_z, float hi_x,
                                     float hi_y, float hi_z, int smooth, int* idx, float* w,
                                     void* stream) {
  using namespace nerf;
  if (levels < 1 || levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Levels lv{};
  for (int l = 0; l < levels; ++l) {
    lv.grid[l] = grid_sizes[l];
    lv.table[l] = static_cast<unsigned int>(table_sizes[l]);
    lv.hashed[l] = hashed[l];
  }
  const Bbox box{{lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}};
  const long long total = n * levels;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kCornerThreads - 1) / kCornerThreads);
  hashgrid_corners_kernel<<<blocks, kCornerThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, levels, lv, box, smooth, idx, w);
  return static_cast<int>(cudaGetLastError());
}
