// hashgrid_encode_kernel in the table-gradient kernel's thread layout: a
// measured variant of csrc/hashgrid_encode.cu, built and timed by
// scripts/hashgrid_ablations.py (which copies it over that file), on no
// path.  Same function, same corner math, same order of the 8-corner sum:
// the same bits.
//
// What differs from the kernel as built:
// - the thread layout is encode_args.cuh's: a block tile of kTilePoints
//   consecutive points, one warp per work item, one lane per point.  Along
//   rays a warp's load instruction goes to one table with 32 neighbouring
//   samples: rows in one sector or line (the dense levels; samples in one
//   cell) are one request.  x is read once per point, and the tile's
//   [points, L*F] slab of out is staged in shared memory and written as
//   whole lines;
// - switches for what else was tried on it: the coarsest tables copied into
//   shared memory by a persistent grid with one bulk copy per table
//   (kSharedCoarse), the hashed levels' rows read without allocating in L1
//   (kStreamHashed), out written by each lane without the staging
//   (kStageOut off).
// On an H100 it is no faster than the kernel as built (3 % slower on random
// points, 9 % along rays; within 3 % either way at 128 threads a block):
// there L1 already collects the reuse between neighbouring samples
// (PERF.md, section 6).
#include "encode_args.cuh"
#include "gather.cuh"
#include "sm90.cuh"

namespace nerf {

// Ablation switches (as built: staged, the others off; see the header).
constexpr bool kStageOut = true;
constexpr bool kSharedCoarse = false;
constexpr bool kStreamHashed = false;
// With kSharedCoarse: the leading dense levels of at most this many floats
// (two lattice-16 levels at F = 2: 32 KB each) are read from shared memory.
constexpr int kSharedLevels = 2;
constexpr int kSharedFloats = 8192;
constexpr int kSharedBlocksPerSm = 2;

// Row `row` of a table of C columns as plain loads (a table copy in shared
// memory), and as loads that leave no line in L1.
template <int C>
__device__ __forceinline__ Row<C> load_row_plain(const float* table, unsigned long long row) {
  Row<C> r;
  const float* p = table + row * C;
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    r.v[0] = q.x, r.v[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) r.v[c] = p[c];
  }
  return r;
}

template <int C>
__device__ __forceinline__ Row<C> load_row_stream(const float* table, unsigned long long row) {
  Row<C> r;
  const float* p = table + row * C;
  if constexpr (C == 4) {
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(r.v[0]), "=f"(r.v[1]), "=f"(r.v[2]), "=f"(r.v[3])
        : "l"(p));
  } else if constexpr (C == 2) {
    asm("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];" : "=f"(r.v[0]), "=f"(r.v[1]) : "l"(p));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(r.v[c]) : "l"(p + c));
    }
  }
  return r;
}

// How a level's rows are read: 0 the read-only path, 1 without a line in L1
// (kStreamHashed), 2 from a copy in shared memory (kSharedCoarse).
template <int C>
__device__ __forceinline__ Row<C> load_table_row(const float* table, unsigned long long row,
                                                 int how) {
  if constexpr (kSharedCoarse) {
    if (how == 2) return load_row_plain<C>(table, row);
  }
  if constexpr (kStreamHashed) {
    if (how == 1) return load_row_stream<C>(table, row);
  }
  return load_row<C>(table, row);
}

// The rows of a cell's 8 corners.  Where a level's tables hold whole
// aligned pairs of rows (and F <= 2), corner c's pair is read as one row
// of 2F floats, and corner c + 4 takes its row from the same load when it
// lies in that pair.
template <int F>
__device__ __forceinline__ void load_corners(const float* __restrict__ table,
                                             const unsigned int (&rows)[8], bool paired, int how,
                                             Row<F> (&v)[8]) {
  if constexpr (F <= 2) {
    if (paired) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned int r0 = rows[c], r1 = rows[c + 4];
        const Row<2 * F> pair = load_table_row<2 * F>(table, r0 >> 1, how);
#pragma unroll
        for (int f = 0; f < F; ++f) v[c].v[f] = (r0 & 1) ? pair.v[F + f] : pair.v[f];
        if ((r0 >> 1) == (r1 >> 1)) {
#pragma unroll
          for (int f = 0; f < F; ++f) v[c + 4].v[f] = (r1 & 1) ? pair.v[F + f] : pair.v[f];
        } else {
          v[c + 4] = load_table_row<F>(table, r1, how);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = load_table_row<F>(table, rows[c], how);
}

// One point's features of the K levels from l0 on, into dst (the point's
// row of the staged tile, at column l0 * F).  `shared` holds the tables
// copied to shared memory (kSharedCoarse), null where a level has none.
template <int F, int K>
__device__ __forceinline__ void encode_item(const float (&x)[3], const EncodeArgs& a, int l0,
                                            const float* const (&shared)[kSharedLevels],
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
  for (int k = 0; k < K; ++k) {
    const float* table = a.table[l0 + k];
    int how = hashed ? 1 : 0;
    if constexpr (kSharedCoarse) {
      if (l0 + k < kSharedLevels && shared[l0 + k] != nullptr) table = shared[l0 + k], how = 2;
    }
    load_corners<F>(table, rows, a.paired[l0 + k] != 0, how, v[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float acc = __fmul_rn(w[0], v[k][0].v[f]);
#pragma unroll
      for (int c = 1; c < 8; ++c) acc = __fadd_rn(acc, __fmul_rn(w[c], v[k][c].v[f]));
      dst[k * F + f] = acc;
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kTileThreads)
    hashgrid_encode_kernel(const float* __restrict__ x, long long n, long long tiles,
                           const __grid_constant__ EncodeArgs a, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int width = a.levels * F, stride = tile_stride(width);
  float* xs = smem;                     // [kTilePoints, 3]
  float* tile = smem + 3 * kTilePoints; // [kTilePoints, stride]
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = a.items * kTileChunks;

  const float* shared[kSharedLevels] = {};
  if constexpr (kSharedCoarse) {
    // One bulk copy per leading dense level that fits, once per block; the
    // block then walks over many tiles.
    __shared__ __align__(8) uint64_t bar;
    float* copy = smem + tile_floats(width);  // 16-byte aligned: kTilePoints is a multiple of 32
    unsigned int bytes[kSharedLevels] = {};
    for (int l = 0; l < kSharedLevels && l < a.levels; ++l) {
      const unsigned long long floats = level_rows(a, l) * F;
      if (a.hashed[l] || floats > kSharedFloats || floats % 4 != 0 ||
          reinterpret_cast<uintptr_t>(a.table[l]) % 16 != 0) {
        break;
      }
      shared[l] = copy + l * kSharedFloats;
      bytes[l] = static_cast<unsigned int>(floats * sizeof(float));
    }
    if (threadIdx.x == 0) {
      mbar_init(&bar, 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned int total = 0;
      for (int l = 0; l < kSharedLevels; ++l) total += bytes[l];
      mbar_arrive_expect_tx(&bar, total);
      for (int l = 0; l < kSharedLevels; ++l) {
        if (bytes[l]) bulk_load(const_cast<float*>(shared[l]), a.table[l], bytes[l], &bar);
      }
    }
    mbar_wait(&bar, 0);
  }

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * kTilePoints;
    const int count = static_cast<int>(n - base < kTilePoints ? n - base : kTilePoints);
    for (int i = threadIdx.x; i < 3 * count; i += blockDim.x) xs[i] = __ldg(x + 3 * base + i);
    __syncthreads();
    for (int u = warp; u < units; u += warps) {
      const int chunk = kTileChunks == 1 ? 0 : u / a.items;
      const int item = u - chunk * a.items;
      const int p = 32 * chunk + lane;
      if (p < count) {
        const float point[3] = {xs[3 * p], xs[3 * p + 1], xs[3 * p + 2]};
        const int l0 = a.item_level[item];
        // Unstaged (kStageOut off), a lane writes its K * F floats into its
        // point's row of out: 32 part-filled sectors a warp.
        float* dst = kStageOut ? tile + p * stride + l0 * F : out + (base + p) * width + l0 * F;
        if (a.item_levels[item] == kLevelsPerItem) {
          encode_item<F, kLevelsPerItem>(point, a, l0, shared, dst);
        } else {
          encode_item<F, 1>(point, a, l0, shared, dst);
        }
      }
    }
    __syncthreads();
    if constexpr (kStageOut) {
      // The tile's slab of out is contiguous: count * width floats.
      float* dst = out + base * width;
      for (int e = threadIdx.x; e < count * width; e += blockDim.x) {
        const int row = e / width;
        dst[e] = tile[row * stride + (e - row * width)];
      }
    }
    // The next tile's x may land while other warps still store: it does not
    // touch the slab, which is next written after the barrier above.
  }
}

template <int F>
cudaError_t launch_encode(const float* x, long long n, const EncodeArgs& a, float* out,
                          cudaStream_t stream) {
  const long long tiles = (n + kTilePoints - 1) / kTilePoints;
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  const int width = a.levels * F;
  size_t smem = sizeof(float) * tile_floats(width);
  long long blocks = tiles;
  if constexpr (kSharedCoarse) {
    smem += sizeof(float) * kSharedLevels * kSharedFloats;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (blocks > static_cast<long long>(kSharedBlocksPerSm) * sms) blocks = kSharedBlocksPerSm * sms;
    const cudaError_t err = cudaFuncSetAttribute(
        hashgrid_encode_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  hashgrid_encode_kernel<F><<<static_cast<unsigned int>(blocks), tile_block_threads(a.items), smem,
                              stream>>>(x, n, tiles, a, out);
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
// floats for F = 4).
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
