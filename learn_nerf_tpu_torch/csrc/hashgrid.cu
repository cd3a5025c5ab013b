// Hash-grid corner indices and trilinear weights for all levels in one
// launch, with a plain C interface for ctypes
// (learn_nerf_tpu_torch/kernels/build.py).
//
// hashgrid_corners_kernel is the forward index half of the hash-grid
// encoding, which the JAX package leaves to XLA:
//   learn_nerf_tpu/ops/hashgrid.py:43-99 (corner_weights_and_coords +
//   level_indices).
// For points x [N, 3] and L levels it writes idx [L, N, 8] int32 (the
// table row of each cell corner: x-major dense index x + g*(y + g*z) when
// g^3 <= T, else the hash x ^ (19349663*y) ^ (83492791*z) mod T in uint32
// arithmetic) and w [L, N, 8] f32 (the corner's trilinear weight).  Corner
// c has x = bit 2, y = bit 1, z = bit 0.
//
// Rounding: every f32 step is written with an _rn intrinsic so that nvcc
// cannot contract a multiply and an add into an FMA.  An FMA would round
// findex differently, which moves floor() at a cell face and changes the
// corner by one; with these intrinsics the kernel's indices equal the
// plain version's (one PyTorch op per step, each rounded).
//
// What bounds it on an H100: the stores.  Each (level, point) writes 64
// bytes and reads 12; the arithmetic is a few dozen instructions.  Design:
// one thread per (level, point), threads of a block on consecutive points
// of one level, each writing its 8 indices and 8 weights as four 16-byte
// stores, so a warp's stores cover contiguous memory.
#include <cuda_runtime.h>

namespace nerf {

constexpr int kCornerThreads = 256;
constexpr int kMaxLevels = 32;
constexpr unsigned int kPrimeY = 19349663u;
constexpr unsigned int kPrimeZ = 83492791u;

struct Levels {
  int grid[kMaxLevels];
  unsigned int table[kMaxLevels];
  int hashed[kMaxLevels];  // grid^3 > table
};

struct Bbox {
  float lo[3];
  float hi[3];
};

__global__ void __launch_bounds__(kCornerThreads)
    hashgrid_corners_kernel(const float* __restrict__ x, long long n, int levels,
                            Levels lv, Bbox box, int smooth,
                            int* __restrict__ idx, float* __restrict__ w) {
  const long long t = static_cast<long long>(blockIdx.x) * kCornerThreads + threadIdx.x;
  if (t >= n * levels) return;
  const int level = static_cast<int>(t / n);
  const long long p = t - static_cast<long long>(level) * n;
  const int g = lv.grid[level];

  unsigned int base[3];
  float cf[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float span = __fsub_rn(box.hi[a], box.lo[a]);
    float frac = __fdiv_rn(__fsub_rn(__ldg(x + p * 3 + a), box.lo[a]), span);
    frac = fminf(fmaxf(frac, 0.0f), 1.0f);
    const float findex = smooth ? __fadd_rn(0.5f, __fmul_rn(static_cast<float>(g - 2), frac))
                                : __fmul_rn(static_cast<float>(g - 1), frac);
    const float floored = fminf(floorf(findex), static_cast<float>(g - 2));
    float c = __fsub_rn(findex, floored);
    if (smooth) c = __fmul_rn(__fmul_rn(c, c), __fsub_rn(3.0f, __fmul_rn(2.0f, c)));
    base[a] = static_cast<unsigned int>(floored);
    cf[a] = c;
  }

  const unsigned int gu = static_cast<unsigned int>(g);
  const unsigned int table = lv.table[level];
  const bool hashed = lv.hashed[level] != 0;
  int rows[8];
  float weights[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned int bx = (c >> 2) & 1, by = (c >> 1) & 1, bz = c & 1;
    const unsigned int cx = base[0] + bx, cy = base[1] + by, cz = base[2] + bz;
    const unsigned int row = hashed ? (cx ^ (kPrimeY * cy) ^ (kPrimeZ * cz)) % table
                                    : cx + gu * (cy + gu * cz);
    rows[c] = static_cast<int>(row);
    const float wx = bx ? cf[0] : __fsub_rn(1.0f, cf[0]);
    const float wy = by ? cf[1] : __fsub_rn(1.0f, cf[1]);
    const float wz = bz ? cf[2] : __fsub_rn(1.0f, cf[2]);
    weights[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
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
