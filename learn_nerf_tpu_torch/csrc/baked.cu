// The baked Instant-NGP lookup, with a plain C interface for ctypes
// (learn_nerf_tpu_torch/kernels/build.py, kernels/baked.py).
//
// baked_lookup_kernel replaces the XLA gather and weighted sum of
//   learn_nerf_tpu/baked.py:118-158 (BakedInstantNGP.__call__):
//   per point, the cell of an r^3 vertex lattice over the bbox, the 8
//   trilinear corner weights, and the weighted sum of the 8 corners' F
//   features, read from a dense table.  Out: [N, F] f32.
//
// The table is logical: [r^3, P*F] in bf16 or f32, rows x-major
// (x + r*(y + r*z)).  Row i holds the features of P corners: segment s
// (s < P) is the vertex whose low corner bits are s, shifted by +1 and
// clamped at r - 1 (z = bit 0, y = bit 1, x = bit 2).  A point reads the
// 8/P rows of the corners 0, P, 2P, ... and gets all 8 corners in the
// standard corner order, so every pack gives the same bits.
//
// What bounds it on an H100: random reads from DRAM.  Each point reads 8/P
// rows of P*F*sizeof(T) bytes (256 bytes at F = 16 in bf16, whatever the
// pack) from a table of 1.8 GB (384^3, pack 1) to 14.5 GB (pack 8) that no
// cache holds, and writes 4F bytes.  The rows of corners c and c + 4 are
// rows x and x + 1, side by side, so the table hands a point 4/P runs of
// two rows (one row at pack 8).  The card's own rate for such random runs
// (csrc/ablations/probes.cu, run by scripts/baked_ablations.py, on an H100
// 80GB HBM3 at 700 W) does not fall from 1.8 GB to 14.5 GB (by 1-3 %), so
// address translation costs little; a 32 MB buffer, which L2 holds, reads
// 2.7-3.2 times faster.  From DRAM it is about 29 G runs/s for runs of 32 or 64
// bytes, and 2.7-2.8 TB/s for runs of 128 to 512 bytes: 2^20 points take
// at least 0.097 ms at pack 4 and 0.145 ms at pack 1.
//
// Design.  Each point's cell, weights and row offsets come from the lattice
// arithmetic of hashgrid.cuh (the _rn steps keep floor() at a cell face
// equal to the plain version's), and each sum runs over corners 0..7 in
// corner order in f32 with __fmul_rn / __fadd_rn, so every layout below and
// the thread-a-point kernel it replaced (csrc/ablations/baked_parent.cu)
// give the same bits.  What changes between them is who loads which bytes,
// and when.  The thread-a-point kernel's warp loads touched 32 rows an
// instruction, each 32-byte sector in two 16-byte halves from two
// instructions, and as compiled its sums ran between its loads: the same
// layout with every load of a point before its sum takes 0.178 ms where it
// took 0.275 (pack 4; the "thread a point" ablation).  Here a load
// instruction requests whole sectors, each once, and every load of a warp
// is issued before any sum, in one of two layouts, whichever measured
// faster for the table's type and pack:
//
// * Lane groups (lookup_by_lane_groups; bf16 at packs 4 and 8): a warp
//   takes 32 points, one a lane; the G = P*F*sizeof(T)/16 lanes of a group
//   take one row, a 16-byte vector each, so an instruction requests whole
//   rows (128-byte lines at pack 4).  The rows go straight to shared memory
//   by cp.async (no registers hold them), a point's rows side by side,
//   which is its 8 corners in corner order; once the warp's copies land,
//   each lane sums its own point from shared memory.  The copies go through
//   L1: past it, a row that many points share (a pooled tile's padding is
//   one point repeated) is fetched from one L2 slice again and again.
// * Feature lanes (lookup_by_feature_lanes; bf16 at packs 1 and 2, f32):
//   the L = F*sizeof(T)/16 lanes of a point (2 in bf16, 4 in f32) each
//   load one 16-byte vector of every corner and sum those F/L features over
//   the corners themselves: no staging and no exchange.  An instruction
//   requests 32/L whole corner segments (a sector each in bf16).
//
// On 2^20 random points of a 384^3 table (chip_smoke.py, the replaced
// kernel in the same call): pack 4 0.131 ms against 0.278 (74 % of the
// card's rate for its runs), pack 1 0.204 against 0.318 (71 %), f32 pack 1
// 0.235 against 0.895.  Both layouts are baked_lookup_kernel, chosen at
// compile time, and write their output as float4s.
#include <cuda_runtime.h>

#include "hashgrid.cuh"

namespace nerf {

constexpr int kBakedThreads = 128;
constexpr int kBakedFeatures = 16;
// Lane groups: a lane owns this many points, a warp stages 32 * this.
constexpr int kPointsPerLane = 1;
// Lane groups: rows go to shared memory by cp.async (true) or through
// registers.
constexpr bool kAsyncCopy = true;
// Rows skip L1: cp.async.cg and ld.global.nc.L1::no_allocate (false:
// cp.async.ca and __ldg).
constexpr bool kRowsPastL1 = false;
// Feature lanes: a point's features split over the lanes that each take a
// 16-byte vector of every corner (false: one lane takes a whole point, the
// thread-a-point layout), and the points a lane takes at once.
constexpr bool kSplitFeatures = true;
constexpr int kSplitPoints = 1;

// 16 bytes of table elements as floats: 8 bf16 (bf16 -> f32 is exact: the
// bits move to the top half) or 4 f32.
template <typename T>
struct Elements;

template <>
struct Elements<unsigned short> {
  static constexpr int kPerVector = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float* out) {
    const unsigned int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(words[i] << 16);
      out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

template <>
struct Elements<float> {
  static constexpr int kPerVector = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
};

// The first 16-byte vector of the row of corner c0 of a cell, in a table
// of rows of `vectors` vectors (64-bit: 384^3 rows of 4 * 16 elements is
// past 2^31).
__device__ __forceinline__ long long row_vector(const Cell& cell, int c0, long long side, int vectors) {
  const long long row = (cell.base[0] + ((c0 >> 2) & 1)) +
                        side * ((cell.base[1] + ((c0 >> 1) & 1)) + side * (cell.base[2] + (c0 & 1)));
  return row * vectors;
}

// The shapes of one warp's work at pack P.
template <typename T, int P, int F>
struct Staging {
  static constexpr int kRowVectors = P * F * static_cast<int>(sizeof(T)) / 16;  // G: lanes a row
  static constexpr int kRows = 8 / P;                                          // rows a point
  static constexpr int kVectors = kRows * kRowVectors;                         // 16 bytes each, a point
  // A point's slots in shared memory: its vectors and one more, so that the
  // lanes of a quarter warp, each reading its own point, hit other banks.
  static constexpr int kStride = kVectors + 1;
  static constexpr int kPoints = 32 * kPointsPerLane;  // a warp's
  static constexpr int kRowsAtOnce = 32 / kRowVectors;  // rows a load instruction
  static constexpr int kLoads = kPoints * kRows / kRowsAtOnce;  // load instructions a warp
  static constexpr int kWarps = kBakedThreads / 32;
  static constexpr size_t kSharedBytes = sizeof(uint4) * kWarps * kPoints * kStride;
  static_assert(kRowVectors * 16 == P * F * static_cast<int>(sizeof(T)) && kRowVectors <= 32,
                "rows must be whole 16-byte vectors, at most 32 a row");
  static_assert(F % 4 == 0, "the output is written as float4s");
};

// Through L1 (.ca), which serves the rows that many points of a warp or
// block share (a pooled tile's padding is one point repeated), or past it
// (.cg).  With a source size of 0 nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void copy_async(uint4* dst, const uint4* src, bool ok) {
  const unsigned int to = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  if constexpr (kRowsPastL1) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(to), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(to), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ uint4 load_row_vector(const uint4* p) {
  if constexpr (kRowsPastL1) {
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  } else {
    return __ldg(p);
  }
}

template <typename T, int P, int F>
__device__ __forceinline__ void lookup_by_lane_groups(const T* __restrict__ grid, const float* __restrict__ x,
                                                      long long n, int r, const Bbox& box,
                                                      float* __restrict__ out) {
  using S = Staging<T, P, F>;
  constexpr int kPer = Elements<T>::kPerVector;
  extern __shared__ uint4 baked_stage[];
  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * S::kWarps + (threadIdx.x >> 5)) * S::kPoints;
  if (first >= n) return;  // the whole warp
  uint4* stage = baked_stage + (threadIdx.x >> 5) * (S::kPoints * S::kStride);
  const uint4* rows = reinterpret_cast<const uint4*>(grid);

  // 1. Each lane's own points: weights, and the first vector of each row.
  float w[kPointsPerLane][8];
  long long row_at[kPointsPerLane][S::kRows];
  const long long side = r;
#pragma unroll
  for (int q = 0; q < kPointsPerLane; ++q) {
    const long long i = first + 32 * q + lane;
    const long long k = i < n ? i : n - 1;  // a lane past the end repeats the last point
    const float p[3] = {__ldg(x + 3 * k), __ldg(x + 3 * k + 1), __ldg(x + 3 * k + 2)};
    const Cell cell = cell_of(p, r, box, false);
#pragma unroll
    for (int c = 0; c < 8; ++c) w[q][c] = corner_weight(cell, c);
#pragma unroll
    for (int j = 0; j < S::kRows; ++j) row_at[q][j] = row_vector(cell, j * P, side, S::kRowVectors);
  }

  // 2. The warp's rows, S::kRowsAtOnce a load instruction: lane group g
  // takes row slot s = t * kRowsAtOnce + g (row j = s / kPoints of point
  // s % kPoints; j and the point's owner's q are the same across the
  // instruction), lane v of the group the row's vector v.
  const int v = lane % S::kRowVectors, g = lane / S::kRowVectors;
  if constexpr (kAsyncCopy) {
#pragma unroll
    for (int t = 0; t < S::kLoads; ++t) {
      const int s0 = t * S::kRowsAtOnce, j = s0 / S::kPoints, q = (s0 % S::kPoints) / 32;
      const int point = s0 % S::kPoints + g;
      const long long at = __shfl_sync(0xffffffffu, row_at[q][j], point % 32);
      const bool live = first + point < n;
      copy_async(stage + point * S::kStride + j * S::kRowVectors + v, rows + (live ? at + v : 0), live);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // Through registers, 16 loads in flight a lane at a time.
    constexpr int kBatch = S::kLoads < 16 ? S::kLoads : 16;
#pragma unroll
    for (int t0 = 0; t0 < S::kLoads; t0 += kBatch) {
      uint4 held[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int s0 = (t0 + b) * S::kRowsAtOnce, j = s0 / S::kPoints, q = (s0 % S::kPoints) / 32;
        const long long at = __shfl_sync(0xffffffffu, row_at[q][j], (s0 % S::kPoints + g) % 32);
        held[b] = first + s0 % S::kPoints + g < n ? load_row_vector(rows + at + v) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int s0 = (t0 + b) * S::kRowsAtOnce, j = s0 / S::kPoints;
        stage[(s0 % S::kPoints + g) * S::kStride + j * S::kRowVectors + v] = held[b];
      }
    }
  }
  __syncwarp();

  // 3. Each lane sums its own points' corners in corner order: a point's
  // vectors side by side are its 8/P rows, i.e. corners 0..7, F elements each.
#pragma unroll
  for (int q = 0; q < kPointsPerLane; ++q) {
    const long long i = first + 32 * q + lane;
    if (i >= n) break;
    const uint4* src = stage + (32 * q + lane) * S::kStride;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int u = 0; u < S::kVectors; ++u) {
      float vals[kPer];
      Elements<T>::unpack(src[u], vals);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int k = u * kPer + e;  // element k of the point's rows: corner k / F, feature k % F
        acc[k % F] = __fadd_rn(acc[k % F], __fmul_rn(w[q][k / F], vals[e]));
      }
    }
    float4* dst = reinterpret_cast<float4*>(out + i * F);
#pragma unroll
    for (int f = 0; f < F; f += 4) dst[f / 4] = make_float4(acc[f], acc[f + 1], acc[f + 2], acc[f + 3]);
  }
}

// Feature lanes: the L = F*sizeof(T)/16 lanes of a point (2 in bf16, 4 in
// f32) each load one 16-byte vector of every corner, F/L features, and sum
// them over corners 0..7 in corner order themselves: no staging, no
// exchange.  A load instruction of a warp requests 32/L whole corner
// segments (a 32-byte sector each in bf16).
template <typename T, int F>
struct Split {
  static constexpr int kSegmentVectors = F * static_cast<int>(sizeof(T)) / 16;  // a corner's
  static constexpr int kLanes = kSplitFeatures ? kSegmentVectors : 1;          // L: lanes a point
  static constexpr int kVectors = kSegmentVectors / kLanes;                     // a lane's, a corner
  static constexpr int kFeatures = F / kLanes;                                  // a lane's
  static constexpr int kRound = kBakedThreads / kLanes;                         // a block's points, a round
  static constexpr int kPoints = kRound * kSplitPoints;                         // a block's
};

template <typename T, int P, int F>
__device__ __forceinline__ void lookup_by_feature_lanes(const T* __restrict__ grid, const float* __restrict__ x,
                                                        long long n, int r, const Bbox& box,
                                                        float* __restrict__ out) {
  using S = Split<T, F>;
  constexpr int kPer = Elements<T>::kPerVector;
  const int slice = threadIdx.x % S::kLanes;
  const long long first = static_cast<long long>(blockIdx.x) * S::kPoints + threadIdx.x / S::kLanes;
  const uint4* rows = reinterpret_cast<const uint4*>(grid);
  const long long side = r;
  float w[kSplitPoints][8];
  uint4 held[kSplitPoints][8][S::kVectors];
#pragma unroll
  for (int q = 0; q < kSplitPoints; ++q) {
    const long long i = first + q * S::kRound;
    if (i >= n) break;
    const float p[3] = {__ldg(x + 3 * i), __ldg(x + 3 * i + 1), __ldg(x + 3 * i + 2)};
    const Cell cell = cell_of(p, r, box, false);
#pragma unroll
    for (int c = 0; c < 8; ++c) w[q][c] = corner_weight(cell, c);
#pragma unroll
    for (int c0 = 0; c0 < 8; c0 += P) {
      const uint4* src = rows + row_vector(cell, c0, side, P * S::kSegmentVectors) + slice * S::kVectors;
#pragma unroll
      for (int c = 0; c < P; ++c) {
#pragma unroll
        for (int u = 0; u < S::kVectors; ++u) held[q][c0 + c][u] = load_row_vector(src + c * S::kSegmentVectors + u);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kSplitPoints; ++q) {
    const long long i = first + q * S::kRound;
    if (i >= n) break;
    float acc[S::kFeatures];
#pragma unroll
    for (int f = 0; f < S::kFeatures; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int u = 0; u < S::kVectors; ++u) {
        float vals[kPer];
        Elements<T>::unpack(held[q][c][u], vals);
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int f = u * kPer + e;
          acc[f] = __fadd_rn(acc[f], __fmul_rn(w[q][c], vals[e]));
        }
      }
    }
    float4* dst = reinterpret_cast<float4*>(out + i * F + slice * S::kFeatures);
#pragma unroll
    for (int f = 0; f < S::kFeatures; f += 4) dst[f / 4] = make_float4(acc[f], acc[f + 1], acc[f + 2], acc[f + 3]);
  }
}

// Which layout a table takes (scripts/baked_ablations.py times both at every
// pack): lane groups for bf16 rows of 128 bytes or more (packs 4 and 8),
// feature lanes for shorter rows and for f32 tables.
template <typename T, int P>
__host__ __device__ constexpr bool lane_groups() {
  return sizeof(T) == 2 && P * kBakedFeatures * 2 >= 128;
}

template <typename T, int P, int F>
__global__ void __launch_bounds__(kBakedThreads)
    baked_lookup_kernel(const T* __restrict__ grid, const float* __restrict__ x, long long n,
                        int r, Bbox box, float* __restrict__ out) {
  if constexpr (lane_groups<T, P>()) {
    lookup_by_lane_groups<T, P, F>(grid, x, n, r, box, out);
  } else {
    lookup_by_feature_lanes<T, P, F>(grid, x, n, r, box, out);
  }
}

template <typename T, int P>
cudaError_t launch_baked(const void* grid, const float* x, long long n, int r, const Bbox& box,
                         float* out, cudaStream_t stream) {
  const auto kernel = baked_lookup_kernel<T, P, kBakedFeatures>;
  if constexpr (!lane_groups<T, P>()) {
    constexpr long long kPerBlock = Split<T, kBakedFeatures>::kPoints;
    const unsigned int blocks = static_cast<unsigned int>((n + kPerBlock - 1) / kPerBlock);
    kernel<<<blocks, kBakedThreads, 0, stream>>>(static_cast<const T*>(grid), x, n, r, box, out);
  } else {
    using S = Staging<T, P, kBakedFeatures>;
    if (S::kSharedBytes > 48 * 1024) {  // above 48 KB a block's shared memory must be asked for
      const cudaError_t asked = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::kSharedBytes));
      if (asked != cudaSuccess) return asked;
    }
    constexpr long long kPerBlock = static_cast<long long>(S::kWarps) * S::kPoints;
    const unsigned int blocks = static_cast<unsigned int>((n + kPerBlock - 1) / kPerBlock);
    kernel<<<blocks, kBakedThreads, S::kSharedBytes, stream>>>(static_cast<const T*>(grid), x, n, r, box, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_baked_pack(int pack, const void* grid, const float* x, long long n, int r,
                              const Bbox& box, float* out, cudaStream_t stream) {
  switch (pack) {
    case 1: return launch_baked<T, 1>(grid, x, n, r, box, out, stream);
    case 2: return launch_baked<T, 2>(grid, x, n, r, box, out, stream);
    case 4: return launch_baked<T, 4>(grid, x, n, r, box, out, stream);
    case 8: return launch_baked<T, 8>(grid, x, n, r, box, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace nerf

// Launches on the given stream, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).  The caller checks shapes,
// types and 16-byte alignment: grid [r^3, pack * features] (bf16 when
// bf16 != 0, else f32), x [n, 3] f32, out [n, features] f32.
extern "C" int nerf_baked_lookup(const void* grid, int bf16, int pack, int features,
                                 const float* x, long long n, int resolution,
                                 float lo_x, float lo_y, float lo_z,
                                 float hi_x, float hi_y, float hi_z, float* out, void* stream) {
  using namespace nerf;
  if (n == 0) return 0;
  if (features != kBakedFeatures || resolution < 2) return static_cast<int>(cudaErrorInvalidValue);
  const Bbox box = {{lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_baked_pack<unsigned short>(pack, grid, x, n, resolution, box, out, s)
           : launch_baked_pack<float>(pack, grid, x, n, resolution, box, out, s);
  return static_cast<int>(err);
}
