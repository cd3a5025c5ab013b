// The by-value argument of the all-level hash-grid kernels: the encode
// kernel (hashgrid_encode.cu) takes it with the tables' pointers, and the
// backward kernel (hashgrid_backward.cu) with the gradient buffers' in
// their place.  kernels/hashgrid_encode.py's EncodeArgs mirrors this layout
// field for field.
#pragma once

#include "hashgrid.cuh"

namespace nerf {

// Levels of one run (equal grid and table size) that one work item covers.
constexpr int kLevelsPerItem = 2;

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

}  // namespace nerf
