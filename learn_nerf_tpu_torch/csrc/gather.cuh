// The gather core shared by table_gather.cu and hashgrid_encode.cu: one
// table row read as one vector, and W floats stored with the widest
// aligned stores.
//
// Both kernels read f32 feature tables of C = 1..4 columns at random rows.
// Rows are read through the read-only path (__ldg), so rows that share a
// sector are one L2 read.  An L2 evict_last policy on the table reads and
// streaming (.cs) accesses for what passes through once measured within
// 1 % on an H100 at these sizes (the tables stay in the 50 MB L2 without
// them) and were taken out.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace nerf {

template <int C>
struct Row {
  float v[C];
};

// Row `row` of a [T, C] table (C = 2 and 4 read as one vector: the caller
// checks the table is aligned to its row width).
template <int C>
__device__ __forceinline__ Row<C> load_row(const float* __restrict__ table, unsigned long long row) {
  Row<C> r;
  const float* p = table + row * C;
  if constexpr (C == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    r.v[0] = q.x, r.v[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) r.v[c] = __ldg(p + c);
  }
  return r;
}

// W consecutive floats to dst: 16-byte stores where dst is 16-byte
// aligned, else 8-byte, else 4-byte.
template <int W>
__device__ __forceinline__ void store_floats(float* __restrict__ dst, const float (&v)[W]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if constexpr (W % 4 == 0) {
    if ((a & 15) == 0) {
#pragma unroll
      for (int k = 0; k < W; k += 4) {
        *reinterpret_cast<float4*>(dst + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      }
      return;
    }
  }
  if constexpr (W % 2 == 0) {
    if ((a & 7) == 0) {
#pragma unroll
      for (int k = 0; k < W; k += 2) *reinterpret_cast<float2*>(dst + k) = make_float2(v[k], v[k + 1]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) dst[k] = v[k];
}

}  // namespace nerf
