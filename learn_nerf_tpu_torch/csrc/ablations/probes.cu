// The card's own rate for the two access patterns that bound the hash-grid
// kernels, measured because no profiler counter can be read: random 8-byte
// row reads that each pull their own 32-byte sector (the encode kernel),
// and random vector atomics (the table-gradient kernel).  Built and timed by
// scripts/hashgrid_ablations.py; nothing on a path uses them.
//
// A thread stands for one (point, level pair) of the encode kernel: it
// makes the accesses of 8 corners in each of its two levels' buffers, at
// rows drawn by an integer hash of the thread index, so nothing of a
// lattice, a ray or a cell remains: every access is to an unrelated sector.
#include <cuda_runtime.h>

namespace nerf {

constexpr int kProbeLevels = 16;
constexpr int kProbeThreads = 256;

struct ProbeArgs {
  float* table[kProbeLevels];        // [rows, 2] f32 each, aligned to 16 bytes
  unsigned int rows[kProbeLevels];   // even
};

__device__ __forceinline__ unsigned int mix(unsigned int t, unsigned int c) {
  unsigned int h = t * 2654435761u + c * 0x9E3779B9u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

// Single reads: 8 float2 loads per level, each in its own sector.  Pair
// reads, as the encode kernel's: 4 float4 loads of an aligned pair of rows
// per level, and for the half of the corners whose partner lies elsewhere
// (odd x) one more float2 load: 6 sectors per level on average.
template <bool kPairs>
__global__ void __launch_bounds__(kProbeThreads)
    probe_reads_kernel(const __grid_constant__ ProbeArgs a, unsigned int threads,
                       float* __restrict__ out) {
  const unsigned int t = blockIdx.x * kProbeThreads + threadIdx.x;
  if (t >= threads) return;
  const int l0 = 2 * (t % (kProbeLevels / 2));
  float2 single[2][8];
  float4 pair[2][4];
  unsigned int h[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) h[c] = mix(t, c);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float* table = a.table[l0 + k];
    const unsigned int rows = a.rows[l0 + k];
    if constexpr (kPairs) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pair[k][c] = __ldg(reinterpret_cast<const float4*>(table) + h[c] % (rows / 2));
        single[k][c] = (h[c] >> 31) ? __ldg(reinterpret_cast<const float2*>(table) + h[c + 4] % rows)
                                    : make_float2(0.0f, 0.0f);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        single[k][c] = __ldg(reinterpret_cast<const float2*>(table) + h[c] % rows);
      }
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int c = 0; c < (kPairs ? 4 : 8); ++c) {
      sum += single[k][c].x + single[k][c].y;
      if constexpr (kPairs) sum += pair[k][c].x + pair[k][c].y + pair[k][c].z + pair[k][c].w;
    }
  }
  out[t] = sum;
}

// 8 vector atomics per level: of 2 floats on a random row (kWidth = 2) or
// of 4 floats on a random aligned pair of rows (kWidth = 4).
template <int kWidth>
__global__ void __launch_bounds__(kProbeThreads)
    probe_atomics_kernel(const __grid_constant__ ProbeArgs a, unsigned int threads) {
  const unsigned int t = blockIdx.x * kProbeThreads + threadIdx.x;
  if (t >= threads) return;
  const int l0 = 2 * (t % (kProbeLevels / 2));
  const float v = 1e-3f * static_cast<float>(t & 7u);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned int h = mix(t, c);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float* table = a.table[l0 + k];
      const unsigned int rows = a.rows[l0 + k];
      if constexpr (kWidth == 4) {
        atomicAdd(reinterpret_cast<float4*>(table) + h % (rows / 2), make_float4(v, v, v, v));
      } else {
        atomicAdd(reinterpret_cast<float2*>(table) + h % rows, make_float2(v, v));
      }
    }
  }
}

}  // namespace nerf

// `threads` threads (< 2^32), each reading 16 rows (pairs = 0) or 8 row
// pairs and on average 4 more rows (pairs = 1); out [threads] f32.  Returns
// the cudaError_t of the launch.
extern "C" int nerf_probe_reads(const nerf::ProbeArgs* args, long long threads, int pairs,
                                float* out, void* stream) {
  using namespace nerf;
  const unsigned int n = static_cast<unsigned int>(threads);
  const unsigned int blocks = (n + kProbeThreads - 1) / kProbeThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs) {
    probe_reads_kernel<true><<<blocks, kProbeThreads, 0, s>>>(*args, n, out);
  } else {
    probe_reads_kernel<false><<<blocks, kProbeThreads, 0, s>>>(*args, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// `threads` threads, each making 16 vector atomics of `width` (2 or 4)
// floats.  Returns the cudaError_t of the launch.
extern "C" int nerf_probe_atomics(const nerf::ProbeArgs* args, long long threads, int width,
                                  void* stream) {
  using namespace nerf;
  const unsigned int n = static_cast<unsigned int>(threads);
  const unsigned int blocks = (n + kProbeThreads - 1) / kProbeThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 4) {
    probe_atomics_kernel<4><<<blocks, kProbeThreads, 0, s>>>(*args, n);
  } else {
    probe_atomics_kernel<2><<<blocks, kProbeThreads, 0, s>>>(*args, n);
  }
  return static_cast<int>(cudaGetLastError());
}
