// The card's own rate for the access patterns that bound the hash-grid and
// baked kernels, measured because no profiler counter can be read: random
// 8-byte row reads that each pull their own 32-byte sector (the encode
// kernel), random vector atomics (the table-gradient kernel), and random
// runs of 32-512 bytes read by lane groups (the baked lookup's rows); and
// the floor of a launch: an empty kernel at a kernel's grid and block (the
// pool-layout composite kernels, which do little work).  Built and timed by
// scripts/hashgrid_ablations.py, scripts/baked_ablations.py,
// scripts/composite_ablations.py and chip_smoke.py; nothing on a path uses
// them.
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

// Random runs of kRunVectors 16-byte vectors (a baked table's rows: 32 * P
// bytes in bf16, 64 * P in f32), read as the lookup reads them: the
// kRunVectors lanes of a group load one run together, a vector each, so a
// load instruction requests 32 / kRunVectors whole runs.  A group takes
// kProbeRunLoads runs, all loads in flight at once, each at a row drawn by a
// hash of the run's index from `rows` rows; a lane keeps the XOR of its words.
constexpr int kProbeRunLoads = 8;

template <int kRunVectors>
__global__ void __launch_bounds__(kProbeThreads)
    probe_runs_kernel(const uint4* __restrict__ buf, unsigned int rows, long long runs,
                      long long threads, unsigned int* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kProbeThreads + threadIdx.x;
  if (t >= threads) return;
  const long long group = t / kRunVectors;
  const int v = static_cast<int>(t % kRunVectors);
  uint4 held[kProbeRunLoads];
#pragma unroll
  for (int u = 0; u < kProbeRunLoads; ++u) {
    const long long run = group * kProbeRunLoads + u;
    const unsigned int row = mix(static_cast<unsigned int>(run), 0u) % rows;
    held[u] = run < runs ? __ldg(buf + static_cast<long long>(row) * kRunVectors + v) : make_uint4(0, 0, 0, 0);
  }
  unsigned int acc = 0;
#pragma unroll
  for (int u = 0; u < kProbeRunLoads; ++u) acc ^= held[u].x ^ held[u].y ^ held[u].z ^ held[u].w;
  out[t] = acc;
}

// Does nothing: what one launch of a grid costs.
__global__ void probe_empty_kernel() {}

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

// `runs` random runs of `run_bytes` (32, 64, 128, 256 or 512) bytes from a
// buffer of `bytes` bytes (aligned to 16; at most 2^32 runs), each loaded
// by run_bytes / 16 lanes; out [nerf_probe_runs_threads(runs, run_bytes)]
// u32.  Returns the cudaError_t of the launch.
extern "C" long long nerf_probe_runs_threads(long long runs, int run_bytes) {
  using namespace nerf;
  return (runs + kProbeRunLoads - 1) / kProbeRunLoads * (run_bytes / 16);
}

extern "C" int nerf_probe_runs(const void* buf, long long bytes, int run_bytes, long long runs,
                               unsigned int* out, void* stream) {
  using namespace nerf;
  const long long threads = nerf_probe_runs_threads(runs, run_bytes);
  const unsigned int rows = static_cast<unsigned int>(bytes / run_bytes);
  const unsigned int blocks = static_cast<unsigned int>((threads + kProbeThreads - 1) / kProbeThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* b = static_cast<const uint4*>(buf);
  switch (run_bytes) {
    case 32: probe_runs_kernel<2><<<blocks, kProbeThreads, 0, s>>>(b, rows, runs, threads, out); break;
    case 64: probe_runs_kernel<4><<<blocks, kProbeThreads, 0, s>>>(b, rows, runs, threads, out); break;
    case 128: probe_runs_kernel<8><<<blocks, kProbeThreads, 0, s>>>(b, rows, runs, threads, out); break;
    case 256: probe_runs_kernel<16><<<blocks, kProbeThreads, 0, s>>>(b, rows, runs, threads, out); break;
    case 512: probe_runs_kernel<32><<<blocks, kProbeThreads, 0, s>>>(b, rows, runs, threads, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of `blocks` blocks of `threads` threads.  Returns the
// cudaError_t of the launch.
extern "C" int nerf_probe_empty(long long blocks, int threads, void* stream) {
  using namespace nerf;
  probe_empty_kernel<<<static_cast<unsigned int>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
