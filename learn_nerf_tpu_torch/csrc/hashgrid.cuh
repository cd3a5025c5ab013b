// The hash-grid corner math, shared by the corner kernel (hashgrid.cu) and
// the all-level encode kernel (hashgrid_encode.cu), so the two compute the
// same indices and weights with the same code.
//
// It is the forward index half of the hash-grid encoding, which the JAX
// package leaves to XLA: learn_nerf_tpu/ops/hashgrid.py:43-99
// (corner_weights_and_coords + level_indices).  Per point and level: the
// cell of a g^3 lattice over the bbox, then for each of its 8 corners the
// table row (x-major dense index x + g*(y + g*z) when g^3 <= T, else the
// hash x ^ (19349663*y) ^ (83492791*z) mod T in uint32 arithmetic) and the
// trilinear weight.  Corner c has x = bit 2, y = bit 1, z = bit 0.
//
// Rounding: every f32 step is written with an _rn intrinsic so that nvcc
// cannot contract a multiply and an add into an FMA.  An FMA would round
// findex differently, which moves floor() at a cell face and changes the
// corner by one; with these intrinsics the indices equal the plain
// version's (one PyTorch op per step, each rounded), and so do the weights.
#pragma once

#include <cuda_runtime.h>

namespace nerf {

constexpr int kMaxLevels = 32;
constexpr unsigned int kPrimeY = 19349663u;
constexpr unsigned int kPrimeZ = 83492791u;

struct Bbox {
  float lo[3];
  float hi[3];
};

// The cell of one point in one level's lattice: its lowest corner and the
// interpolation coordinate (smoothstepped in smooth mode) along each axis.
struct Cell {
  unsigned int base[3];
  float cf[3];
};

__device__ __forceinline__ Cell cell_of(const float (&x)[3], int g, const Bbox& box, bool smooth) {
  Cell cell;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float span = __fsub_rn(box.hi[a], box.lo[a]);
    float frac = __fdiv_rn(__fsub_rn(x[a], box.lo[a]), span);
    frac = fminf(fmaxf(frac, 0.0f), 1.0f);
    const float findex = smooth ? __fadd_rn(0.5f, __fmul_rn(static_cast<float>(g - 2), frac))
                                : __fmul_rn(static_cast<float>(g - 1), frac);
    const float floored = fminf(floorf(findex), static_cast<float>(g - 2));
    float c = __fsub_rn(findex, floored);
    if (smooth) c = __fmul_rn(__fmul_rn(c, c), __fsub_rn(3.0f, __fmul_rn(2.0f, c)));
    cell.base[a] = static_cast<unsigned int>(floored);
    cell.cf[a] = c;
  }
  return cell;
}

// Table row of corner c: dense in a lattice of g^3 <= table rows, else
// hashed modulo table.
__device__ __forceinline__ unsigned int corner_row(const Cell& cell, int c, unsigned int g,
                                                   unsigned int table, bool hashed) {
  const unsigned int cx = cell.base[0] + ((c >> 2) & 1);
  const unsigned int cy = cell.base[1] + ((c >> 1) & 1);
  const unsigned int cz = cell.base[2] + (c & 1);
  return hashed ? (cx ^ (kPrimeY * cy) ^ (kPrimeZ * cz)) % table : cx + g * (cy + g * cz);
}

// Trilinear weight of corner c, as the plain version forms it: (wx*wy)*wz.
__device__ __forceinline__ float corner_weight(const Cell& cell, int c) {
  const float wx = ((c >> 2) & 1) ? cell.cf[0] : __fsub_rn(1.0f, cell.cf[0]);
  const float wy = ((c >> 1) & 1) ? cell.cf[1] : __fsub_rn(1.0f, cell.cf[1]);
  const float wz = (c & 1) ? cell.cf[2] : __fsub_rn(1.0f, cell.cf[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

}  // namespace nerf
