// A measured variant (scripts/hashgrid_ablations.py, built on its own in the
// place of csrc/table_gather.cu): the row gather with the table held across
// the blocks of a thread block cluster, read through distributed shared
// memory.  It lost to csrc/table_gather.cu's L2 route at every table size
// measured on an H100 (distributed shared memory serves random 8-byte
// reads at 70-159 G/s on clusters of 16-2 against L2's 133 G random
// sectors/s, and each cluster pays its copy; PERF.md, section 6), so the
// wrapper gives it no table.  Its entry points carry "_cluster" in their
// names.
//
// out[m, :] = table[idx[m], :] with jnp.take's rule (kernels/table_gather.py).
// Block r of each cluster of Q blocks copies rows [r S, (r + 1) S) (S =
// 2^slice_shift, Q S >= T) into its shared memory by 16-byte vector loads
// (4-byte loads where the slice's first row is not 16-byte aligned, and for
// its last < 16 bytes).  A thread loads its first tile's indices before
// that copy, so those loads overlap it.  After a cluster barrier every
// block reads any row from the shared memory of the block that holds it
// (mapa, ld.shared::cluster), kInFlight rows in flight a thread, the next
// tile's indices loading meanwhile; a NaN row reads nothing.  A cluster
// launches min(Q, kMaxRanks) blocks: the rows of ranks past them are read
// from L2.  The grid is as many clusters as the card places at once
// (cudaOccupancyMaxActiveClusters), and the kernel ends with a cluster
// barrier: no block leaves while a peer may still read its slice.
#include "gather.cuh"
#include "sm90.cuh"

namespace nerf {

constexpr int kResidentThreads = 256;
constexpr int kInFlight = 8;      // indices a thread takes from a tile
constexpr int kMaxRanks = 16;     // blocks a cluster launches with
constexpr int kMaxSliceBytes = 224 * 1024;  // a block's dynamic shared memory (227 KB less the static part)
constexpr long long kTile = static_cast<long long>(kResidentThreads) * kInFlight;

__device__ __forceinline__ void load_tile(int (&held)[kInFlight], const int* __restrict__ idx, long long m,
                                          long long tile) {
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const long long i = tile * kTile + u * kResidentThreads + threadIdx.x;
    held[u] = i < m ? __ldg(idx + i) : 0;
  }
}

// Copies block `rank`'s slice of `slice_rows` rows into its shared memory.
template <int C>
__device__ __forceinline__ void fill_slice(float* slice, const float* __restrict__ table, long long rows,
                                           unsigned int rank, unsigned int ranks, long long slice_rows) {
  const long long first = rank * slice_rows;
  const long long count = first >= rows ? 0 : rows - first < slice_rows ? rows - first : slice_rows;
  const float* src = table + first * C;
  const long long n = count * C;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const long long whole = aligned ? n & ~3ll : 0;  // floats in whole 16-byte chunks
  for (long long k = threadIdx.x; k < whole / 4; k += kResidentThreads) {
    reinterpret_cast<float4*>(slice)[k] = __ldg(reinterpret_cast<const float4*>(src) + k);
  }
  for (long long k = whole + threadIdx.x; k < n; k += kResidentThreads) slice[k] = __ldg(src + k);
}

// Row `index` (jnp.take's rule) from the shared memory of the block of the
// cluster that holds it.
template <int C>
__device__ __forceinline__ Row<C> cluster_row(uint32_t base, const float* __restrict__ table, long long rows,
                                              int slice_shift, unsigned int ranks, int index) {
  long long j = index;
  if (j < 0) j += rows;
  Row<C> r;
  if (j < 0 || j >= rows) {
#pragma unroll
    for (int c = 0; c < C; ++c) r.v[c] = __int_as_float(0x7fc00000);  // quiet NaN, no shared-memory read
    return r;
  }
  const unsigned int row = static_cast<unsigned int>(j);
  unsigned int rank = row >> slice_shift;
  const unsigned int offset = row & ((1u << slice_shift) - 1);
  if (rank >= ranks) return load_row<C>(table, row);
  const uint32_t addr = map_shared_rank(base + offset * (C * 4), rank);
  if constexpr (C == 4) {
    const float4 q = ld_cluster_f32x4(addr);
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = ld_cluster_f32x2(addr);
    r.v[0] = q.x, r.v[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) r.v[c] = ld_cluster_f32(addr + 4 * c);
  }
  return r;
}

template <int C>
__global__ void __launch_bounds__(kResidentThreads, 1)
    table_gather_cluster_kernel(const float* __restrict__ table, long long rows, int slice_shift,
                                const int* __restrict__ idx, long long m, float* __restrict__ out) {
  extern __shared__ __align__(16) float slice[];
  const unsigned int rank = cluster_rank();
  const unsigned int ranks = cluster_blocks();
  const long long tiles = (m + kTile - 1) / kTile;
  long long tile = blockIdx.x;
  int held[kInFlight];
  load_tile(held, idx, m, tile);  // in flight during the fill
  fill_slice<C>(slice, table, rows, rank, ranks, 1ll << slice_shift);
  cluster_sync();
  const uint32_t base = smem_addr(slice);
  for (; tile < tiles; tile += gridDim.x) {
    int next[kInFlight];
    load_tile(next, idx, m, tile + gridDim.x);  // in flight while this tile's rows are read
    Row<C> r[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) r[u] = cluster_row<C>(base, table, rows, slice_shift, ranks, held[u]);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = tile * kTile + u * kResidentThreads + threadIdx.x;
      if (i < m) store_floats<C>(out + i * C, r[u].v);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) held[u] = next[u];
  }
  cluster_sync();  // no block leaves while a peer may read its slice
}

// The launch of clusters of `ranks` blocks of `smem` bytes each, with the
// kernel's attributes set (they belong to the kernel on the current device).
template <int C>
cudaError_t cluster_config(int ranks, size_t smem, cudaLaunchConfig_t* config, cudaLaunchAttribute* attr) {
  auto kernel = table_gather_cluster_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSliceBytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = {};
  config->gridDim = dim3(ranks);
  config->blockDim = dim3(kResidentThreads);
  config->dynamicSmemBytes = smem;
  config->attrs = attr;
  config->numAttrs = 1;
  return err;
}

// Clusters the card runs at once, into *active (0: none fits).
template <int C>
cudaError_t placement(long long rows, int cluster, int slice_shift, int* active, int* ranks, size_t* smem) {
  *active = 0;
  if (cluster < 2 || cluster > 16 || slice_shift < 0 || slice_shift > 24 ||
      (static_cast<long long>(cluster) << slice_shift) < rows) {
    return cudaErrorInvalidValue;
  }
  *smem = static_cast<size_t>(((1ll << slice_shift) * C * 4 + 15) & ~15ll);
  if (*smem > static_cast<size_t>(kMaxSliceBytes)) return cudaErrorInvalidValue;
  *ranks = cluster < kMaxRanks ? cluster : kMaxRanks;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<C>(*ranks, *smem, &config, &attr);
  if (err != cudaSuccess) return err;
  auto kernel = table_gather_cluster_kernel<C>;
  return cudaOccupancyMaxActiveClusters(active, kernel, &config);
}

template <int C>
cudaError_t launch_cluster(const float* table, long long rows, int cluster, int slice_shift, const int* idx,
                           long long m, float* out, cudaStream_t stream) {
  int active = 0, ranks = 0;
  size_t smem = 0;
  cudaError_t err = placement<C>(rows, cluster, slice_shift, &active, &ranks, &smem);
  if (err != cudaSuccess) return err;
  if (active == 0) return cudaErrorInvalidConfiguration;  // no cluster fits on the card
  const long long tiles = (m + kTile - 1) / kTile;
  const long long groups = (tiles + ranks - 1) / ranks;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  err = cluster_config<C>(ranks, smem, &config, &attr);
  if (err != cudaSuccess) return err;
  config.gridDim = dim3(static_cast<unsigned int>((groups < active ? groups : active) * ranks));
  config.stream = stream;
  err = cudaLaunchKernelEx(&config, table_gather_cluster_kernel<C>, table, rows, slice_shift, idx, m, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace nerf

// Launches clusters of `cluster` blocks (2..16) of 2^slice_shift rows each
// (cluster 2^slice_shift >= rows) on the given stream, does not
// synchronise, and returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidConfiguration where no cluster fits on the card.
extern "C" int nerf_table_gather_cluster(const float* table, long long rows, int columns, const int* idx,
                                         long long m, float* out, int cluster, int slice_shift, void* stream) {
  using namespace nerf;
  if (m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (columns) {
    case 1: return static_cast<int>(launch_cluster<1>(table, rows, cluster, slice_shift, idx, m, out, s));
    case 2: return static_cast<int>(launch_cluster<2>(table, rows, cluster, slice_shift, idx, m, out, s));
    case 3: return static_cast<int>(launch_cluster<3>(table, rows, cluster, slice_shift, idx, m, out, s));
    case 4: return static_cast<int>(launch_cluster<4>(table, rows, cluster, slice_shift, idx, m, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of that shape the card runs at once, into *active (0:
// none fits); returns the cudaError_t of the query.
extern "C" int nerf_table_gather_cluster_placement(long long rows, int columns, int cluster, int slice_shift,
                                                   int* active) {
  using namespace nerf;
  int ranks = 0;
  size_t smem = 0;
  *active = 0;
  switch (columns) {
    case 1: return static_cast<int>(placement<1>(rows, cluster, slice_shift, active, &ranks, &smem));
    case 2: return static_cast<int>(placement<2>(rows, cluster, slice_shift, active, &ranks, &smem));
    case 3: return static_cast<int>(placement<3>(rows, cluster, slice_shift, active, &ranks, &smem));
    case 4: return static_cast<int>(placement<4>(rows, cluster, slice_shift, active, &ranks, &smem));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
