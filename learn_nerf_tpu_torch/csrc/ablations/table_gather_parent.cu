// A measured variant (scripts/hashgrid_ablations.py, built on its own): the
// row gather as it was before csrc/table_gather.cu held the table in shared
// memory: every table reads its rows through L2, one thread an index.  Its
// entry point carries "_parent" in its name.
//
// Row gather from an f32 feature table, with a plain C interface for ctypes
// (learn_nerf_tpu_torch/kernels/build.py).
//
// table_gather_kernel replaces the Pallas TPU kernel
//   tools/exp_gather.py:gather_kernel (pallas_gather):
//   out[m, :] = table[idx[m], :] for table [T, C] f32 (C = 1..4) and int32
//   idx [M], with jnp.take's out-of-range rule: an index in [-T, -1] wraps
//   to T + idx, any other index outside [0, T) gives a row of NaN.
//
// What bounds it on an H100: random row reads, not bytes.  Each index
// costs a 4-byte index read, one random C*4-byte row read and a C*4-byte
// write (14.1 MB, 4.2 us at 3.35 TB/s, at pallas_gather's [2^18, 2] x
// 999,424); but every row read waits on its index read and pulls a 32-byte
// sector for 8 useful bytes, and a warp's 32 random rows are 32 separate
// L1 requests.  The TPU kernel keeps the whole table in VMEM; here the
// table stays in device memory and the kernel relies on the 50 MB L2 to
// hold it (shared memory, 227 KB a block, holds no level above 2^14 rows).
// Design: one thread per index, so blocks at different stages overlap,
// rows read by the gather core of gather.cuh.  On an H100 no other layout
// measured faster (scripts/hashgrid_ablations.py; PERF.md, section 6):
// four or two consecutive indices per thread from one int4 or int2 load,
// four indices per thread strided across the block, and a grid of 8
// blocks per SM striding over single indices (the next one loaded ahead)
// or over those blocks of four.
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

}  // namespace nerf

// Launches on the given stream, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).  The caller checks shapes and
// alignment (C = 2 and 4 rows are read and written as one vector).
extern "C" int nerf_table_gather_parent(const float* table, long long rows, int columns,
                                        const int* idx, long long m, float* out,
                                        void* stream) {
  using namespace nerf;
  if (m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (columns) {
    case 1: return static_cast<int>(launch_gather<1>(table, rows, idx, m, out, s));
    case 2: return static_cast<int>(launch_gather<2>(table, rows, idx, m, out, s));
    case 3: return static_cast<int>(launch_gather<3>(table, rows, idx, m, out, s));
    case 4: return static_cast<int>(launch_gather<4>(table, rows, idx, m, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
