// The by-value argument of the all-level hash-grid kernels: the encode
// kernel (hashgrid_encode.cu) takes it with the tables' pointers, and the
// backward kernel (hashgrid_backward.cu) with the gradient buffers' in
// their place.  kernels/hashgrid_encode.py's EncodeArgs mirrors this layout
// field for field.
//
// The backward kernel's thread layout is below (the encode kernel was
// measured in it too, csrc/ablations/hashgrid_encode_tiles.cu): a block
// takes a tile of kTilePoints consecutive points and all work items; one
// warp takes one work item for 32 consecutive points, one lane per point.
// The callers feed points along rays (32 samples of a ray, ordered in t),
// so the lanes of a warp that fall in one cell are neighbours, and the 32
// lanes of one instruction address ONE table.  On unrelated points a warp
// touches 32 unrelated sectors, as with any layout.  The tile's x and its
// [points, levels * features] slab of the cotangent (or of out) pass
// through shared memory, so device memory sees whole lines.
#pragma once

#include <cstdint>

#include "hashgrid.cuh"

namespace nerf {

// Levels of one run (equal grid and table size) that one work item covers.
constexpr int kLevelsPerItem = 2;

// Points of a block tile (a multiple of 32) and the most threads of a block.
// scripts/hashgrid_ablations.py times 64 points and 128 threads beside them.
constexpr int kTilePoints = 32;
constexpr int kTileThreads = 256;
constexpr int kTileChunks = kTilePoints / 32;  // 32-point chunks of a tile

// Row stride, in floats, of a staged [kTilePoints, width] tile: odd, so the
// 32 lanes of a warp (one point each, one row each) hit 32 different banks.
__host__ __device__ __forceinline__ int tile_stride(int width) { return width | 1; }

// Shared memory of a tile: x [kTilePoints, 3], then the staged slab.
__host__ __device__ __forceinline__ int tile_floats(int width) {
  return kTilePoints * (3 + tile_stride(width));
}

// Threads of a block: one warp per (work item, chunk) unit, up to
// kTileThreads; a warp then strides over the units (unit = chunk * items +
// item).
inline int tile_block_threads(int items) {
  const int units = items * kTileChunks;
  return 32 * (units < kTileThreads / 32 ? units : kTileThreads / 32);
}

struct EncodeArgs {
  const float* table[kMaxLevels];  // level l's rows [rows_l, features]
  int grid[kMaxLevels];            // lattice resolution
  unsigned int size[kMaxLevels];   // table size T (the hash modulus)
  int hashed[kMaxLevels];          // grid^3 > T
  int paired[kMaxLevels];          // even row count: every aligned row pair is in the table
  int item_level[kMaxLevels];      // work item i covers levels
  int item_levels[kMaxLevels];     //   [item_level[i], + item_levels[i]), 1 or 2
  int items;
  int levels;
  int features;
  int smooth;
  Bbox box;
};

// Rows of level l's table (and of its gradient): the lattice's points in a
// dense level, the table size in a hashed one.
__host__ __device__ __forceinline__ unsigned long long level_rows(const EncodeArgs& a, int l) {
  const unsigned long long g = static_cast<unsigned long long>(a.grid[l]);
  return a.hashed[l] ? a.size[l] : g * g * g;
}

}  // namespace nerf
