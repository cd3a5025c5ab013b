// Row gather from an f32 feature table, with a plain C interface for ctypes
// (learn_nerf_tpu_torch/kernels/build.py).
//
// Replaces the Pallas TPU kernel tools/exp_gather.py:gather_kernel
// (pallas_gather): out[m, :] = table[idx[m], :] for table [T, C] f32 (C =
// 1..4) and int32 idx [M], with jnp.take's out-of-range rule: an index in
// [-T, -1] wraps to T + idx, any other index outside [0, T) gives a row of
// NaN.
//
// What bounds it on an H100: each index costs a 4-byte index read, one
// random C*4-byte row read and a C*4-byte write (14.1 MB, 4.21 us at 3.35
// TB/s, at pallas_gather's [2^18, 2] x 999,424).  Read through L2, every
// row pulls its own 32-byte sector.  The TPU kernel held the whole table
// in VMEM.  Here two kernels (routes) serve the rows, and
// kernels/table_gather.gather_route picks one from the table's shape (the
// `block` argument), by a threshold measured on an H100
// (scripts/hashgrid_ablations.py):
//
// * block-resident (block = 1), tables up to 192 KiB: each block of a
//   persistent grid, one a SM, copies the whole table into its shared
//   memory once, then strides over tiles of indices and reads each row
//   from its own shared memory (1.05 T random 8-byte reads/s on an H100,
//   csrc/ablations/probes.cu).  The copy goes by 16-byte vector loads of
//   all threads, issued after the first tile's index loads, so those
//   overlap it; the next tile's indices load while this tile's rows are
//   read, kInFlight rows in flight a thread.  A table whose first row is
//   not 16-byte aligned, and the last < 16 bytes of any table, are copied
//   by 4-byte loads.  Bulk copies on an mbarrier and one tile in flight
//   measured slower (the "gather" variants of hashgrid_ablations.py);
// * L2 (block = 0), every other table: one thread per index, rows read by
//   the gather core of gather.cuh.  No other thread layout measured
//   faster (four or two consecutive indices per thread, four strided, a
//   grid of 8 blocks per SM striding over single indices or blocks of
//   four).  Slices of larger tables held across the blocks of a thread
//   block cluster and read through distributed shared memory measured
//   slower than L2 at every size (csrc/ablations/table_gather_cluster.cu).
#include "gather.cuh"

namespace nerf {

constexpr int kGatherThreads = 256;

// Table row `row` as jnp.take reads it: wrapped if in [-T, -1], NaN if
// outside [-T, T).
template <int C>
__device__ __forceinline__ Row<C> take_row(const float* __restrict__ table, long long rows, long long row) {
  if (row < 0) row += rows;
  Row<C> r;
  if (row >= 0 && row < rows) {
    r = load_row<C>(table, static_cast<unsigned long long>(row));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) r.v[c] = __int_as_float(0x7fc00000);  // quiet NaN
  }
  return r;
}

template <int C>
__global__ void __launch_bounds__(kGatherThreads)
    table_gather_kernel(const float* __restrict__ table, long long rows,
                        const int* __restrict__ idx, long long m,
                        float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (i >= m) return;
  store_floats<C>(out + i * C, take_row<C>(table, rows, __ldg(idx + i)).v);
}

template <int C>
cudaError_t launch_gather(const float* table, long long rows, const int* idx, long long m,
                          float* out, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((m + kGatherThreads - 1) / kGatherThreads);
  table_gather_kernel<C><<<blocks, kGatherThreads, 0, stream>>>(table, rows, idx, m, out);
  return cudaGetLastError();
}

// --- the block route ------------------------------------------------------

constexpr int kResidentThreads = 256;
constexpr int kInFlight = 8;  // indices a thread takes from a tile
constexpr int kMaxTableBytes = 224 * 1024;  // a block's dynamic shared memory (227 KB less the static part)
constexpr long long kTile = static_cast<long long>(kResidentThreads) * kInFlight;

__device__ __forceinline__ void load_tile(int (&held)[kInFlight], const int* __restrict__ idx, long long m,
                                          long long tile) {
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const long long i = tile * kTile + u * kResidentThreads + threadIdx.x;
    held[u] = i < m ? __ldg(idx + i) : 0;
  }
}

// Copies the [rows, C] table into this block's shared memory.
template <int C>
__device__ __forceinline__ void fill_table(float* shared, const float* __restrict__ table, long long rows) {
  const long long n = rows * C;
  const bool aligned = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const long long whole = aligned ? n & ~3ll : 0;  // floats in whole 16-byte chunks
  for (long long k = threadIdx.x; k < whole / 4; k += kResidentThreads) {
    reinterpret_cast<float4*>(shared)[k] = __ldg(reinterpret_cast<const float4*>(table) + k);
  }
  for (long long k = whole + threadIdx.x; k < n; k += kResidentThreads) shared[k] = __ldg(table + k);
}

// Row `index` (jnp.take's rule) from the table in shared memory; a NaN row
// reads nothing.
template <int C>
__device__ __forceinline__ Row<C> shared_row(const float* shared, long long rows, int index) {
  long long j = index;
  if (j < 0) j += rows;
  Row<C> r;
  if (j < 0 || j >= rows) {
#pragma unroll
    for (int c = 0; c < C; ++c) r.v[c] = __int_as_float(0x7fc00000);  // quiet NaN
    return r;
  }
  const unsigned int row = static_cast<unsigned int>(j);
  if constexpr (C == 4) {
    const float4 q = reinterpret_cast<const float4*>(shared)[row];
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = reinterpret_cast<const float2*>(shared)[row];
    r.v[0] = q.x, r.v[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) r.v[c] = shared[row * C + c];
  }
  return r;
}

template <int C>
__global__ void __launch_bounds__(kResidentThreads, 1)
    table_gather_block_kernel(const float* __restrict__ table, long long rows, const int* __restrict__ idx,
                              long long m, float* __restrict__ out) {
  extern __shared__ __align__(16) float shared[];
  const long long tiles = (m + kTile - 1) / kTile;
  long long tile = blockIdx.x;
  int held[kInFlight];
  load_tile(held, idx, m, tile);  // in flight during the fill
  fill_table<C>(shared, table, rows);
  __syncthreads();
  for (; tile < tiles; tile += gridDim.x) {
    int next[kInFlight];
    load_tile(next, idx, m, tile + gridDim.x);  // in flight while this tile's rows are read
    Row<C> r[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) r[u] = shared_row<C>(shared, rows, held[u]);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long i = tile * kTile + u * kResidentThreads + threadIdx.x;
      if (i < m) store_floats<C>(out + i * C, r[u].v);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) held[u] = next[u];
  }
}

// A grid of min(SMs, tiles) blocks.  The shared-memory attribute is set on
// every launch: it belongs to the kernel on the current device, and the
// call costs less than the launch.
template <int C>
cudaError_t launch_block(const float* table, long long rows, const int* idx, long long m, float* out,
                         cudaStream_t stream) {
  const long long smem = (rows * C * 4 + 15) & ~15ll;
  if (rows < 0 || smem > kMaxTableBytes) return cudaErrorInvalidValue;
  auto kernel = table_gather_block_kernel<C>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxTableBytes);
  if (err != cudaSuccess) return err;
  const long long tiles = (m + kTile - 1) / kTile;
  const unsigned int blocks = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  table_gather_block_kernel<C><<<blocks, kResidentThreads, static_cast<size_t>(smem), stream>>>(table, rows, idx, m,
                                                                                             out);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_route(const float* table, long long rows, const int* idx, long long m, float* out, int block,
                         cudaStream_t stream) {
  if (block) return launch_block<C>(table, rows, idx, m, out, stream);
  return launch_gather<C>(table, rows, idx, m, out, stream);
}

}  // namespace nerf

// Launches on the given stream, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).  `block` picks the route: 1
// block-resident (a table of at most 224 KiB), 0 L2.  The caller checks
// shapes and alignment (C = 2 and 4 rows are read and written as one
// vector).
extern "C" int nerf_table_gather(const float* table, long long rows, int columns, const int* idx, long long m,
                                 float* out, int block, void* stream) {
  using namespace nerf;
  if (m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (columns) {
    case 1: return static_cast<int>(launch_route<1>(table, rows, idx, m, out, block, s));
    case 2: return static_cast<int>(launch_route<2>(table, rows, idx, m, out, block, s));
    case 3: return static_cast<int>(launch_route<3>(table, rows, idx, m, out, block, s));
    case 4: return static_cast<int>(launch_route<4>(table, rows, idx, m, out, block, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
