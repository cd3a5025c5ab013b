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
// 16-level fine schedule, F = 2), but one atomic per corner row would be 8
// per point and level (16.8 M there), each a read-modify-write of one L2
// sector.  Going faster means issuing fewer atomics.  Design:
// - the thread layout is encode_args.cuh's: a block tile of kTilePoints
//   consecutive points, one warp per work item (up to two levels that share
//   a cell), one lane per point; x and the tile's slab of g are read as
//   whole lines into shared memory;
// - the tail is table_atomics.cuh's, shared with hashgrid_dx.cu's backward:
//   pair atomics (where corners c and c + 4 take the two rows of one
//   aligned pair, ONE vector atomic of 2F floats: 6 atomics a point and
//   level on average in place of 8; for that, every level's buffer starts
//   at an even row of the flat buffer, which is aligned to 16 bytes: the
//   wrapper pads, and the entry point below lays the levels out the same
//   way), and run combining (the callers feed points along rays, so the
//   lanes of a warp that fall in one cell form runs; where a warp has at
//   least kCombineMinMerged lanes that continue a run, it sums each run by
//   shuffles and only the run's first lane adds to the tables);
// - a row alone takes one vector atomic per 2 floats (F = 2), or one per
//   row at F = 4.
// Sums are f32 atomics in an order that changes from run to run: two runs
// agree to rounding, not bit for bit.
// The card adds random vector atomics at 84.6 G/s, of 2 floats or of 4
// (csrc/ablations/probes.cu); with a quarter of the atomics paired away
// and the runs combined the kernel runs at about 90 % of that rate for the
// atomics it still makes (PERF.md, section 6).
// scripts/hashgrid_ablations.py times what was tried beside this and is
// not on the path: the layout it replaced (csrc/ablations/
// hashgrid_backward_parent.cu: one thread per (point, item), one atomic per
// row), this layout without pair atomics and without combining, and the
// coarsest levels' gradients summed in shared memory by a persistent grid
// (kSharedCoarse), which lost.
#include "encode_args.cuh"
#include "table_atomics.cuh"

namespace nerf {

constexpr bool kPairAtomics = true;
constexpr bool kCombineRuns = true;
// Ablation switch (off as built): the leading dense levels of at most
// kSharedFloats floats sum in shared memory, flushed once per block.
constexpr bool kSharedCoarse = false;
constexpr int kSharedLevels = 2;
constexpr int kSharedFloats = 8192;
constexpr int kSharedBlocksPerSm = 2;

// Scalar atomics into a level's sums in shared memory (kSharedCoarse).
template <int F>
__device__ __forceinline__ void add_row_shared(float* sums, unsigned int row, const float (&v)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) atomicAdd(sums + row * F + f, v[f]);
}

// One lane's point in the K levels from l0 on.  `active` is false for the
// lanes past the tile's last point: they take part in the shuffles and add
// nothing.  gp is the point's row of the staged cotangent at column l0 * F.
template <int F, int K>
__device__ __forceinline__ void backward_item(bool active, const float (&x)[3],
                                              const EncodeArgs& a, int l0, const float* gp,
                                              float* const (&shared)[kSharedLevels]) {
  float g[K * F];
#pragma unroll
  for (int i = 0; i < K * F; ++i) g[i] = active ? gp[i] : 0.0f;
  const int grid = a.grid[l0];
  const Cell cell = cell_of(x, grid, a.box, a.smooth != 0);
  const unsigned int size = a.size[l0];
  const bool hashed = a.hashed[l0] != 0;
  unsigned int rows[8];
  float v[8][K * F];  // v[c][k * F + f] = w_c * g[k * F + f]
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    rows[c] = corner_row(cell, c, static_cast<unsigned int>(grid), size, hashed);
    const float w = corner_weight(cell, c);
#pragma unroll
    for (int i = 0; i < K * F; ++i) v[c][i] = __fmul_rn(w, g[i]);
  }

  bool adds = active;
  if constexpr (kCombineRuns) adds = combine_runs<K * F>(active, cell, v);
  if (!adds) return;

#pragma unroll
  for (int k = 0; k < K; ++k) {
    float* grad = const_cast<float*>(a.table[l0 + k]);
    if constexpr (kSharedCoarse) {
      if (l0 + k < kSharedLevels && shared[l0 + k] != nullptr) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float row[F];
#pragma unroll
          for (int f = 0; f < F; ++f) row[f] = v[c][k * F + f];
          add_row_shared<F>(shared[l0 + k], rows[c], row);
        }
        continue;
      }
    }
    add_corners<F, K * F, kPairAtomics>(grad, rows, v, k, a.paired[l0 + k] != 0);
  }
}

template <int F>
__global__ void __launch_bounds__(kTileThreads)
    hashgrid_backward_kernel(const float* __restrict__ x, const float* __restrict__ g, long long n,
                             long long tiles, const __grid_constant__ EncodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int width = a.levels * F, stride = tile_stride(width);
  float* xs = smem;                     // [kTilePoints, 3]
  float* tile = smem + 3 * kTilePoints; // [kTilePoints, stride]: the cotangent's slab
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = a.items * kTileChunks;

  float* shared[kSharedLevels] = {};
  if constexpr (kSharedCoarse) {
    float* sums = smem + tile_floats(width);
    for (int l = 0; l < kSharedLevels && l < a.levels; ++l) {
      if (a.hashed[l] || level_rows(a, l) * F > kSharedFloats) break;
      shared[l] = sums + l * kSharedFloats;
    }
    for (int i = threadIdx.x; i < kSharedLevels * kSharedFloats; i += blockDim.x) sums[i] = 0.0f;
  }

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * kTilePoints;
    const int count = static_cast<int>(n - base < kTilePoints ? n - base : kTilePoints);
    for (int i = threadIdx.x; i < 3 * count; i += blockDim.x) xs[i] = __ldg(x + 3 * base + i);
    // The tile's slab of g is contiguous: count * width floats.
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
      const int l0 = a.item_level[item];
      const float* gp = tile + p * stride + l0 * F;
      if (a.item_levels[item] == kLevelsPerItem) {
        backward_item<F, kLevelsPerItem>(active, point, a, l0, gp, shared);
      } else {
        backward_item<F, 1>(active, point, a, l0, gp, shared);
      }
    }
    __syncthreads();  // the next tile overwrites xs and the slab
  }

  if constexpr (kSharedCoarse) {
    __syncthreads();
    for (int l = 0; l < kSharedLevels; ++l) {
      if (shared[l] == nullptr) continue;
      float* grad = const_cast<float*>(a.table[l]);
      const int floats = static_cast<int>(level_rows(a, l)) * F;
      for (int i = threadIdx.x; i < floats; i += blockDim.x) {
        const float s = shared[l][i];
        if (s != 0.0f) atomicAdd(grad + i, s);
      }
    }
  }
}

template <int F>
cudaError_t launch_backward(const float* x, const float* g, long long n, const EncodeArgs& a,
                            cudaStream_t stream) {
  const long long tiles = (n + kTilePoints - 1) / kTilePoints;
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  size_t smem = sizeof(float) * tile_floats(a.levels * F);
  long long blocks = tiles;
  if constexpr (kSharedCoarse) {
    smem += sizeof(float) * kSharedLevels * kSharedFloats;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (blocks > static_cast<long long>(kSharedBlocksPerSm) * sms) blocks = kSharedBlocksPerSm * sms;
    const cudaError_t err = cudaFuncSetAttribute(
        hashgrid_backward_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  hashgrid_backward_kernel<F><<<static_cast<unsigned int>(blocks), tile_block_threads(a.items), smem,
                                stream>>>(x, g, n, tiles, a);
  return cudaGetLastError();
}

}  // namespace nerf

// x [n, 3] f32 and g [n, levels * features] f32 on the device; args in host
// memory, as for nerf_hashgrid_encode (its table pointers are not read);
// grad is one zeroed f32 buffer on the device, aligned to 16 bytes, that
// holds level l's gradient [rows_l, features] from an even row on: at the
// float offset features * (the rows of the levels before l, each rounded up
// to even), rows_l = grid^3 in a dense level and the table size in a hashed
// one (kernels/hashgrid_backward.level_offsets lays it out the same way).
// Launches on the given stream, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).  The caller checks shapes.
extern "C" int nerf_hashgrid_backward(const float* x, const float* g, long long n,
                                      const nerf::EncodeArgs* args, float* grad, void* stream) {
  using namespace nerf;
  EncodeArgs a = *args;
  if (a.levels < 1 || a.levels > kMaxLevels || a.items < 1 || a.items > a.levels ||
      reinterpret_cast<uintptr_t>(grad) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  unsigned long long row = 0;
  for (int l = 0; l < a.levels; ++l) {
    a.table[l] = grad + row * a.features;
    const unsigned long long rows = level_rows(a, l);
    row += rows + (rows & 1ull);
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
