// A measured variant (scripts/baked_ablations.py, built on its own): the
// baked lookup as it was before csrc/baked.cu loaded rows by lane groups,
// one thread a point.  Its entry point carries "_parent" in its name.
//
// The baked Instant-NGP lookup, with a plain C interface for ctypes
// (learn_nerf_tpu_torch/kernels/build.py, kernels/baked.py).
//
// baked_lookup_kernel replaces the XLA gather and weighted sum of
//   learn_nerf_tpu/baked.py:118-158 (BakedInstantNGP.__call__):
//   per point, the cell of an r^3 vertex lattice over the bbox, the 8
//   trilinear corner weights, and the weighted sum of the 8 corners' F
//   features, read from a dense table.  Out: [N, F] f32.
//
// The table is logical: [r^3, P*F] in bf16 or f32, rows x-major
// (x + r*(y + r*z)).  Row i holds the features of P corners: segment s
// (s < P) is the vertex whose low corner bits are s, shifted by +1 and
// clamped at r - 1 (z = bit 0, y = bit 1, x = bit 2).  A point reads the
// 8/P rows of the corners 0, P, 2P, ... and gets all 8 corners in the
// standard corner order, so every pack gives the same bits.
//
// What bounds it on an H100: random row reads.  Each point reads 8/P rows
// of P*F*sizeof(T) bytes (256 bytes at F = 16 in bf16, whatever the pack)
// from a table of 1.8 GB (384^3, pack 1) to 14.5 GB (pack 8) that no cache
// holds, and writes 4F bytes.  Design: one thread per point, the lattice
// arithmetic of hashgrid.cuh (the _rn steps keep floor() at a cell face
// equal to the plain version's), each row read as 16-byte vector loads
// (all of a point's loads are independent, so they are in flight
// together), the weighted sum in f32 in corner order, the output written
// as float4 stores.
#include <cuda_runtime.h>

#include "hashgrid.cuh"

namespace nerf {

constexpr int kBakedThreads = 128;
constexpr int kBakedFeatures = 16;

// 16 bytes of table elements as floats: 8 bf16 (bf16 -> f32 is exact: the
// bits move to the top half) or 4 f32.
template <typename T>
struct Elements;

template <>
struct Elements<unsigned short> {
  static constexpr int kPerVector = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float* out) {
    const unsigned int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(words[i] << 16);
      out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

template <>
struct Elements<float> {
  static constexpr int kPerVector = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
};

template <typename T, int P, int F>
__global__ void __launch_bounds__(kBakedThreads)
    baked_lookup_kernel(const T* __restrict__ grid, const float* __restrict__ x, long long n,
                        int r, Bbox box, float* __restrict__ out) {
  constexpr int kRow = P * F;  // elements a row
  constexpr int kPer = Elements<T>::kPerVector;
  static_assert(kRow % kPer == 0 && F % 4 == 0, "rows must be whole 16-byte vectors");
  const long long i = static_cast<long long>(blockIdx.x) * kBakedThreads + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {__ldg(x + 3 * i), __ldg(x + 3 * i + 1), __ldg(x + 3 * i + 2)};
  const Cell cell = cell_of(p, r, box, false);
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) w[c] = corner_weight(cell, c);

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  const long long side = r;
#pragma unroll
  for (int c0 = 0; c0 < 8; c0 += P) {
    // 64-bit offsets: 384^3 rows of 4 * 16 elements is past 2^31.
    const long long row = (cell.base[0] + ((c0 >> 2) & 1)) +
                          side * ((cell.base[1] + ((c0 >> 1) & 1)) + side * (cell.base[2] + (c0 & 1)));
    const uint4* src = reinterpret_cast<const uint4*>(grid + row * kRow);
#pragma unroll
    for (int v = 0; v < kRow / kPer; ++v) {
      float vals[kPer];
      Elements<T>::unpack(__ldg(src + v), vals);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int k = v * kPer + e;  // segment k / F is corner c0 + k / F
        acc[k % F] = __fadd_rn(acc[k % F], __fmul_rn(w[c0 + k / F], vals[e]));
      }
    }
  }
  float4* dst = reinterpret_cast<float4*>(out + i * F);
#pragma unroll
  for (int f = 0; f < F; f += 4) dst[f / 4] = make_float4(acc[f], acc[f + 1], acc[f + 2], acc[f + 3]);
}

template <typename T, int P>
cudaError_t launch_baked(const void* grid, const float* x, long long n, int r, const Bbox& box,
                         float* out, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((n + kBakedThreads - 1) / kBakedThreads);
  baked_lookup_kernel<T, P, kBakedFeatures><<<blocks, kBakedThreads, 0, stream>>>(
      static_cast<const T*>(grid), x, n, r, box, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_baked_pack(int pack, const void* grid, const float* x, long long n, int r,
                              const Bbox& box, float* out, cudaStream_t stream) {
  switch (pack) {
    case 1: return launch_baked<T, 1>(grid, x, n, r, box, out, stream);
    case 2: return launch_baked<T, 2>(grid, x, n, r, box, out, stream);
    case 4: return launch_baked<T, 4>(grid, x, n, r, box, out, stream);
    case 8: return launch_baked<T, 8>(grid, x, n, r, box, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace nerf

// Launches on the given stream, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).  The caller checks shapes,
// types and 16-byte alignment: grid [r^3, pack * features] (bf16 when
// bf16 != 0, else f32), x [n, 3] f32, out [n, features] f32.
extern "C" int nerf_baked_lookup_parent(const void* grid, int bf16, int pack, int features,
                                        const float* x, long long n, int resolution,
                                        float lo_x, float lo_y, float lo_z,
                                        float hi_x, float hi_y, float hi_z, float* out, void* stream) {
  using namespace nerf;
  if (n == 0) return 0;
  if (features != kBakedFeatures || resolution < 2) return static_cast<int>(cudaErrorInvalidValue);
  const Bbox box = {{lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_baked_pack<unsigned short>(pack, grid, x, n, resolution, box, out, s)
           : launch_baked_pack<float>(pack, grid, x, n, resolution, box, out, s);
  return static_cast<int>(err);
}
