// The whole hash-grid encoding of all levels in one launch, with a plain C
// interface for ctypes (learn_nerf_tpu_torch/kernels/build.py).
//
// hashgrid_encode_kernel computes the JAX package's hash_grid_encode
// (learn_nerf_tpu/ops/hashgrid.py:135, the non-fused path), which the JAX
// package leaves to XLA: for points x [N, 3] and L levels with tables
// [rows_l, F] f32 (F = 1..4), out [N, L*F] f32, level l's F features at
// columns [l*F, (l+1)*F): the 8 corner rows of the point's cell in level
// l's lattice, weighted by their trilinear weights and summed in corner
// order 0..7 (dense or hashed index, plain or smooth mode).
//
// What bounds it on an H100: row reads from L2.  Its bytes are x, out and
// the tables once (172.5 MB, 51.5 us at 3.35 TB/s, at 2^20 points x the
// 16-level fine schedule, F = 2), but it reads 8 random rows per point and
// level, each pulling a 32-byte sector: 4.29 GB of L2 sectors there.
// Design:
// - the corner math is hashgrid.cuh's, shared with the corner kernel, so
//   indices and weights equal the plain version's; they live in registers
//   and never go to memory;
// - consecutive levels with equal (grid, table size) have the same corners
//   and weights (the standard schedule 2^(4 + l/2) pairs every level): one
//   work item is up to two such levels, whose corners it computes once,
//   then it issues all its row loads before its first multiply-add;
// - corners c and c + 4 differ in x alone, so their rows are neighbours in
//   a dense level, and in a hashed level of a power-of-two table when x is
//   even (x ^ 1 flips bit 0 of the hash): where both lie in one aligned
//   pair of rows, one load of 2F floats reads both (F = 1, 2).  That cuts
//   a quarter of the row loads and a third of the kernel's time on an
//   H100 (PERF.md, section 6);
// - rows are read through the read-only path (rows that share a sector
//   are one L2 read); the tables (25.8 MB at the fine schedule) stay in
//   the 50 MB L2 with no cache hint;
// - one thread per (point, item), items of a point on consecutive threads,
//   so a warp writes a contiguous run of out (16 bytes a thread at F = 2);
// - the per-level parameters and table pointers come by value in one
//   struct, packed once per model by the wrapper.
#include "gather.cuh"
#include "hashgrid.cuh"

namespace nerf {

constexpr int kEncodeThreads = 256;
constexpr int kLevelsPerItem = 2;

// The by-value argument: kernels/hashgrid_encode.py's EncodeArgs mirrors
// this layout field for field.
struct EncodeArgs {
  const float* table[kMaxLevels];  // level l's rows [rows_l, features]
  int grid[kMaxLevels];            // lattice resolution
  unsigned int size[kMaxLevels];   // table size T (the hash modulus)
  int hashed[kMaxLevels];          // grid^3 > T
  int paired[kMaxLevels];          // even row count: every aligned row pair is in the table
  int item_level[kMaxLevels];      // work item i covers levels
  int item_levels[kMaxLevels];     //   [item_level[i], + item_levels[i]), 1 or 2
  int items;
  int levels;
  int features;
  int smooth;
  Bbox box;
};

// The rows of a cell's 8 corners.  Where a level's tables hold whole
// aligned pairs of rows (and F <= 2), corner c's pair is read as one row
// of 2F floats, and corner c + 4 takes its row from the same load when it
// lies in that pair.
template <int F>
__device__ __forceinline__ void load_corners(const float* __restrict__ table,
                                             const unsigned int (&rows)[8], bool paired,
                                             Row<F> (&v)[8]) {
  if constexpr (F <= 2) {
    if (paired) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned int r0 = rows[c], r1 = rows[c + 4];
        const Row<2 * F> pair = load_row<2 * F>(table, r0 >> 1);
#pragma unroll
        for (int f = 0; f < F; ++f) v[c].v[f] = (r0 & 1) ? pair.v[F + f] : pair.v[f];
        if ((r0 >> 1) == (r1 >> 1)) {
#pragma unroll
          for (int f = 0; f < F; ++f) v[c + 4].v[f] = (r1 & 1) ? pair.v[F + f] : pair.v[f];
        } else {
          v[c + 4] = load_row<F>(table, r1);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = load_row<F>(table, rows[c]);
}

template <int F, int K>
__device__ __forceinline__ void encode_item(const float (&x)[3], const EncodeArgs& a, int l0,
                                            float* __restrict__ dst) {
  const int g = a.grid[l0];
  const Cell cell = cell_of(x, g, a.box, a.smooth != 0);
  const unsigned int size = a.size[l0];
  const bool hashed = a.hashed[l0] != 0;
  unsigned int rows[8];
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    rows[c] = corner_row(cell, c, static_cast<unsigned int>(g), size, hashed);
    w[c] = corner_weight(cell, c);
  }
  Row<F> v[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k) load_corners<F>(a.table[l0 + k], rows, a.paired[l0 + k] != 0, v[k]);
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
  store_floats<K * F>(dst, out);
}

template <int F>
__global__ void __launch_bounds__(kEncodeThreads)
    hashgrid_encode_kernel(const float* __restrict__ x, unsigned int total,
                           const __grid_constant__ EncodeArgs a, float* __restrict__ out) {
  const unsigned int t = blockIdx.x * kEncodeThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned int items = static_cast<unsigned int>(a.items);
  const unsigned int p = t / items;
  const int item = static_cast<int>(t - p * items);
  const float* xp = x + 3ull * p;
  const float point[3] = {xp[0], xp[1], xp[2]};
  const int l0 = a.item_level[item];
  float* dst = out + static_cast<unsigned long long>(p) * (a.levels * F) + l0 * F;
  if (a.item_levels[item] == kLevelsPerItem) {
    encode_item<F, kLevelsPerItem>(point, a, l0, dst);
  } else {
    encode_item<F, 1>(point, a, l0, dst);
  }
}

template <int F>
cudaError_t launch_encode(const float* x, long long n, const EncodeArgs& a, float* out,
                          cudaStream_t stream) {
  const long long total = n * a.items;
  if (total >= (1ll << 31)) return cudaErrorInvalidValue;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kEncodeThreads - 1) / kEncodeThreads);
  hashgrid_encode_kernel<F><<<blocks, kEncodeThreads, 0, stream>>>(
      x, static_cast<unsigned int>(total), a, out);
  return cudaGetLastError();
}

}  // namespace nerf

// sizeof the by-value argument, for the wrapper to hold its own layout to.
extern "C" int nerf_hashgrid_encode_args_size() {
  return static_cast<int>(sizeof(nerf::EncodeArgs));
}

// x [n, 3] f32 and out [n, levels * features] f32 on the device; args in
// host memory, copied into the launch.  Launches on the given stream, does
// not synchronise, and returns the cudaError_t of the launch (0 on
// success).  The caller checks shapes, the tables' dtype and alignment (to
// 2F floats for F <= 2, where a pair of rows is read as one vector; to F
// floats for F = 4), and n * items < 2^31.
extern "C" int nerf_hashgrid_encode(const float* x, long long n, const nerf::EncodeArgs* args,
                                    float* out, void* stream) {
  using namespace nerf;
  const EncodeArgs& a = *args;
  if (a.levels < 1 || a.levels > kMaxLevels || a.items < 1 || a.items > a.levels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.features) {
    case 1: return static_cast<int>(launch_encode<1>(x, n, a, out, s));
    case 2: return static_cast<int>(launch_encode<2>(x, n, a, out, s));
    case 3: return static_cast<int>(launch_encode<3>(x, n, a, out, s));
    case 4: return static_cast<int>(launch_encode<4>(x, n, a, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
