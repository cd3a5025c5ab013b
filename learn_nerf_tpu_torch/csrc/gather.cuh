// The gather core shared by table_gather.cu, hashgrid_encode.cu and
// hashgrid_dx.cu: one table row read as one vector, a cell's 8 corner rows
// with pair loads, and W floats loaded or stored with the widest aligned
// accesses.
//
// The kernels read f32 feature tables of C = 1..4 columns at random rows.
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

// The rows of a cell's 8 corners (hashgrid_encode.cu and hashgrid_dx.cu
// read them with this code).  Where a level's tables hold whole aligned
// pairs of rows (and F <= 2), corner c's pair is read as one row of 2F
// floats, and corner c + 4 takes its row from the same load when it lies in
// that pair.
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

// W consecutive floats from src through the read-only path: 16-byte loads
// where src is 16-byte aligned, else 8-byte, else 4-byte.
template <int W>
__device__ __forceinline__ void load_floats(const float* __restrict__ src, float (&v)[W]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if constexpr (W % 4 == 0) {
    if ((a & 15) == 0) {
#pragma unroll
      for (int k = 0; k < W; k += 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src + k));
        v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
      }
      return;
    }
  }
  if constexpr (W % 2 == 0) {
    if ((a & 7) == 0) {
#pragma unroll
      for (int k = 0; k < W; k += 2) {
        const float2 q = __ldg(reinterpret_cast<const float2*>(src + k));
        v[k] = q.x, v[k + 1] = q.y;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = __ldg(src + k);
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
