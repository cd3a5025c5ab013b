// The tail of the two table-gradient kernels (hashgrid_backward.cu, and
// hashgrid_dx.cu's backward): one lane's terms for the 8 corners of its
// point's cell in up to two levels, summed over the runs of lanes that share
// a cell, then added into each level's gradient buffer with f32 atomics.
// Both kernels run on encode_args.cuh's layout (a warp a work item, a lane a
// point) and add into the same padded flat buffer, whose every level starts
// at an even row of a 16-byte aligned buffer.
//
// - run combining: the callers feed points along rays, so the lanes of a
//   warp that fall in one cell form runs of consecutive lanes.  Each lane
//   compares its cell with its neighbour's; where a warp has at least
//   kCombineMinMerged lanes that continue a run, it sums the terms over
//   each run (a segmented reduction by shuffles) and only the run's first
//   lane adds to the tables.  Warps without runs (the fine hashed levels,
//   unrelated points) pay three shuffles and a vote;
// - pair atomics: corners c and c + 4 differ in x alone, and where their
//   rows are the two rows of one aligned pair (always for even x in a dense
//   level of even row count, and for even x in a hashed level of a
//   power-of-two table: the forward's pair loads) both rows take ONE vector
//   atomic of 2F floats (red.global.add.v4.f32 at F = 2, new with sm_90);
// - a row alone takes one vector atomic per 2 floats (F = 2), or one per
//   row at F = 4.
// Each kernel says with its own constants (kPairAtomics, kCombineRuns)
// which of the two levers it pulls; the threshold is shared.
#pragma once

#include "hashgrid.cuh"

namespace nerf {

// Lanes of a warp that must continue a run before the warp combines: the
// reduction costs 5 shuffles per value, an eighth of the atomics it then
// has to save to be worth it.
constexpr int kCombineMinMerged = 8;

// grad[row, :] += v[:]: one vector atomic per row at F = 4 (with Vector),
// per pair of floats at F = 2 (and at F = 4 without), else one scalar
// atomic per float.
template <int F, bool Vector>
__device__ __forceinline__ void add_row(float* __restrict__ grad, unsigned int row,
                                        const float (&v)[F]) {
  float* dst = grad + static_cast<unsigned long long>(row) * F;
  if constexpr (F == 4 && Vector) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (F % 2 == 0) {
#pragma unroll
    for (int f = 0; f < F; f += 2) {
      atomicAdd(reinterpret_cast<float2*>(dst + f), make_float2(v[f], v[f + 1]));
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(dst + f, v[f]);
  }
}

// grad[2 * pair, :] += lo[:] and grad[2 * pair + 1, :] += hi[:] as one
// vector atomic of 2F floats (F = 1, 2; the buffer starts at an even row
// of a 16-byte aligned buffer).
template <int F>
__device__ __forceinline__ void add_row_pair(float* __restrict__ grad, unsigned int pair,
                                             const float (&lo)[F], const float (&hi)[F]) {
  float* dst = grad + static_cast<unsigned long long>(pair) * (2 * F);
  if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(lo[0], lo[1], hi[0], hi[1]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(lo[0], hi[0]));
  }
}

// Run combining over the warp: every lane of the warp calls it together
// (`active` is false for the lanes past the tile's last point, a suffix of
// the warp: they take part in the shuffles and add nothing).  v[c][i] is
// the lane's term of corner c and value i.  Returns whether this lane adds
// its (now summed) terms: all active lanes where the warp does not combine,
// the first lane of each run where it does.
template <int W>
__device__ __forceinline__ bool combine_runs(bool active, const Cell& cell, float (&v)[8][W]) {
  const unsigned int lane = threadIdx.x & 31u;
  constexpr unsigned int kAll = 0xffffffffu;
  // Does this lane continue its neighbour's run (the same cell)?  Active
  // lanes are a prefix of the warp, so an active lane's neighbour is one.
  // (Every lane runs all three shuffles: no short circuit between them.)
  const unsigned int left0 = __shfl_up_sync(kAll, cell.base[0], 1);
  const unsigned int left1 = __shfl_up_sync(kAll, cell.base[1], 1);
  const unsigned int left2 = __shfl_up_sync(kAll, cell.base[2], 1);
  const bool same = active && lane > 0 && left0 == cell.base[0] && left1 == cell.base[1] &&
                    left2 == cell.base[2];
  const unsigned int heads = __ballot_sync(kAll, !same);
  if (32 - __popc(heads) < kCombineMinMerged) return active;
  // The run of this lane ends before the next head above it.
  const unsigned int above = lane == 31 ? 0u : heads & ~((2u << lane) - 1u);
  const unsigned int end = above ? static_cast<unsigned int>(__ffs(above)) - 2u : 31u;
  // After the step of distance d, a lane holds the sum over itself and the
  // next 2d - 1 lanes of its run: its first lane ends with all.
#pragma unroll
  for (unsigned int d = 1; d < 32; d *= 2) {
    const bool take = lane + d <= end;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float other = __shfl_down_sync(kAll, v[c][i], d);
        if (take) v[c][i] = __fadd_rn(v[c][i], other);
      }
    }
  }
  return active && !same;
}

// Level k's terms v[c][k * F + f] into its gradient buffer grad [rows, F]:
// one vector atomic for corners c and c + 4 where their rows are the two
// rows of one aligned pair (with Pair, at F <= 2, in a level of even row
// count: `paired`), else one add_row a corner.
template <int F, int W, bool Pair>
__device__ __forceinline__ void add_corners(float* __restrict__ grad, const unsigned int (&rows)[8],
                                            const float (&v)[8][W], int k, bool paired) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned int r0 = rows[c], r1 = rows[c + 4];
    float first[F], second[F];
#pragma unroll
    for (int f = 0; f < F; ++f) first[f] = v[c][k * F + f], second[f] = v[c + 4][k * F + f];
    if constexpr (Pair && F <= 2) {
      // r0 ^ r1 == 1: the two rows of one aligned pair (two corners that
      // hash to ONE row, in a table that is no power of two, are not).
      if (paired && (r0 ^ r1) == 1u) {
        float lo[F], hi[F];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          lo[f] = (r0 & 1u) ? second[f] : first[f];
          hi[f] = (r0 & 1u) ? first[f] : second[f];
        }
        add_row_pair<F>(grad, r0 >> 1, lo, hi);
        continue;
      }
    }
    add_row<F, Pair>(grad, r0, first);
    add_row<F, Pair>(grad, r1, second);
  }
}

}  // namespace nerf
