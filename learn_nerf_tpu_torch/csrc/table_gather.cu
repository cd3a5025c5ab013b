// Row gather from an f32 feature table, with a plain C interface for ctypes
// (learn_nerf_tpu_torch/kernels/build.py).
//
// table_gather_kernel replaces the Pallas TPU kernel
//   tools/exp_gather.py:gather_kernel (pallas_gather):
//   out[m, :] = table[idx[m], :] for table [T, C] f32 (C = 1..4) and int32
//   idx [M], with jnp.take's out-of-range rule: an index in [-T, -1] wraps
//   to T + idx, any other index outside [0, T) gives a row of NaN.
//
// What bounds it on an H100: memory transactions, not bytes.  Each index
// costs a 4-byte index read, one random C*4-byte row read and a C*4-byte
// write; the row read pulls a whole 32-byte sector for 8 useful bytes at
// C = 2.  The TPU kernel keeps the whole table in VMEM; here the table
// stays in device memory and the kernel relies on the 50 MB L2 to hold it
// (one NGP level is 2^18 x 2 x 4 B = 2 MB; all 16 fine levels are 25.8 MB),
// since shared memory (227 KB a block) holds no level above 2^14 rows.
// Design: one thread per index, the row loaded as one float2 / float4
// through the read-only path (__ldg), index reads and row stores coalesced.
#include <cuda_runtime.h>

namespace nerf {

constexpr int kGatherThreads = 256;

template <int C>
struct Row {
  float v[C];
};

template <int C>
__device__ __forceinline__ Row<C> load_row(const float* __restrict__ table, long long row) {
  Row<C> r;
  const float* p = table + row * C;
  if constexpr (C == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    r.v[0] = v.x;
    r.v[1] = v.y;
  } else if constexpr (C == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = v.x;
    r.v[1] = v.y;
    r.v[2] = v.z;
    r.v[3] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) r.v[c] = __ldg(p + c);
  }
  return r;
}

template <int C>
__device__ __forceinline__ void store_row(float* __restrict__ out, long long m, const Row<C>& r) {
  float* p = out + m * C;
  if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r.v[0], r.v[1]);
  } else if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = r.v[c];
  }
}

template <int C>
__global__ void __launch_bounds__(kGatherThreads)
    table_gather_kernel(const float* __restrict__ table, long long rows,
                        const int* __restrict__ idx, long long m,
                        float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (i >= m) return;
  long long row = __ldg(idx + i);
  if (row < 0) row += rows;
  Row<C> r;
  if (row >= 0 && row < rows) {
    r = load_row<C>(table, row);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) r.v[c] = __int_as_float(0x7fc00000);  // quiet NaN
  }
  store_row<C>(out, i, r);
}

template <int C>
cudaError_t launch_gather(const float* table, long long rows, const int* idx,
                          long long m, float* out, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((m + kGatherThreads - 1) / kGatherThreads);
  table_gather_kernel<C><<<blocks, kGatherThreads, 0, stream>>>(table, rows, idx, m, out);
  return cudaGetLastError();
}

}  // namespace nerf

// Launches on the given stream, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).  The caller checks shapes and
// alignment (C = 2 and 4 rows are read as one vector).
extern "C" int nerf_table_gather(const float* table, long long rows, int columns,
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
