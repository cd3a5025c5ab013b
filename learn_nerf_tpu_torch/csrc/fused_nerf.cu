// Hand-written Hopper (sm_90a) kernels for vanilla NeRF inference, with a
// plain C interface for ctypes (learn_nerf_tpu_torch/kernels/build.py).
//
// fused_mlp_kernel replaces the Pallas TPU kernel
//   tools/pallas_recipe/fused_mlp.py:_kernel (fused_nerf_forward):
//   points [M, 3] + directions [M, 3] -> [M, 4] (density, rgb).
// fused_render_kernel replaces
//   tools/pallas_recipe/fused_render.py:_kernel (fused_render_tiles):
//   the same MLP over [N * K] ray-major samples, then per ray the
//   transmittance scan and composite -> [N, 4] (foreground rgb, background
//   weight).  The TPU kernel takes the scan as a [K, K] triangular matmul
//   because Mosaic has no cumsum; here one thread per ray scans its K
//   samples sequentially in f32.
//
// What bounds them on an H100: products.  One sample costs about 1.18
// MFLOP at the paper's widths (nine 256-wide layers plus the heads) against
// 24 bytes in and 16 bytes out, and every block re-reads the 1.2 MB of bf16
// weights from L2 (about 63 FLOP per byte of L2 traffic at 64 rows), so
// the tensor cores are the limit to aim at.  This first design is simple:
// WMMA tiles, B tiles loaded from global memory without a pipeline, a
// shared-memory f32 staging tile per layer.  Left for later: wgmma with TMA
// weight tiles in a multi-stage ring, more rows per block so each weight
// byte feeds more products, register-resident epilogues, and a persistent
// grid.
#include <cuda_runtime.h>

#include "nerf_mlp.cuh"

namespace nerf {

__global__ void __launch_bounds__(kThreads, 2)
    fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ d,
                     const bf16* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, long long m, MlpDims dims) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;

  encode([&](int r, int dim) { return row0 + r < m ? x[(row0 + r) * 3 + dim] : 0.f; },
         dims.x_freqs, s.x_emb, kXLd);
  encode([&](int r, int dim) { return row0 + r < m ? d[(row0 + r) * 3 + dim] : 0.f; },
         dims.d_freqs, s.d_emb, kDLd);
  __syncthreads();
  mlp_forward(s, dims, w, b);

  const float* res = results(s);
  for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
    if (row0 + i / 4 < m) out[row0 * 4 + i] = res[i];
  }
}

// Each block takes kRows / k whole rays (k <= kRows); rows past
// rays * k in the tile run on zero inputs and are ignored.
__global__ void __launch_bounds__(kThreads, 2)
    fused_render_kernel(const float* __restrict__ points,
                        const float* __restrict__ dirs,
                        const float* __restrict__ deltas,
                        const bf16* __restrict__ w, const float* __restrict__ b,
                        float* __restrict__ out, long long n, int k,
                        MlpDims dims) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int rays = kRows / k;
  const long long ray0 = static_cast<long long>(blockIdx.x) * rays;
  const int rows = rays * k;

  encode(
      [&](int r, int dim) {
        return r < rows && ray0 + r / k < n ? points[(ray0 * k + r) * 3 + dim] : 0.f;
      },
      dims.x_freqs, s.x_emb, kXLd);
  encode(
      [&](int r, int dim) {
        return r < rows && ray0 + r / k < n ? dirs[(ray0 + r / k) * 3 + dim] : 0.f;
      },
      dims.d_freqs, s.d_emb, kDLd);
  __syncthreads();
  mlp_forward(s, dims, w, b);

  // Transmittance scan and composite, as the Pallas kernel:
  // sig_dt = density * delta, acc = inclusive cumsum,
  // w = exp(-(acc - sig_dt)) * (1 - exp(-sig_dt)), bg = exp(-acc_K).
  const float* res = results(s);
  const long long ray = ray0 + threadIdx.x;
  if (threadIdx.x < rays && ray < n) {
    float acc = 0.f, fr = 0.f, fg = 0.f, fb = 0.f;
    for (int j = 0; j < k; ++j) {
      const float* row = res + (threadIdx.x * k + j) * 4;
      const float sig_dt = row[0] * deltas[ray * k + j];
      acc += sig_dt;
      const float weight = expf(-(acc - sig_dt)) * (1.f - expf(-sig_dt));
      fr += weight * row[1];
      fg += weight * row[2];
      fb += weight * row[3];
    }
    out[ray * 4 + 0] = fr;
    out[ray * 4 + 1] = fg;
    out[ray * 4 + 2] = fb;
    out[ray * 4 + 3] = expf(-acc);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(Smem)));
}

}  // namespace nerf

// Every entry point launches on the given stream, does not synchronise,
// and returns the cudaError_t of the launch (0 on success).

extern "C" int nerf_fused_mlp(const float* x, const float* d, const void* w,
                              const float* b, float* out, long long m,
                              int input_layers, int mid_layers, int hidden,
                              int color, int x_freqs, int d_freqs, void* stream) {
  using namespace nerf;
  if (m == 0) return 0;
  cudaError_t err = allow_smem(fused_mlp_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const MlpDims dims{input_layers, mid_layers, hidden, color, x_freqs, d_freqs};
  const unsigned int blocks = static_cast<unsigned int>((m + kRows - 1) / kRows);
  fused_mlp_kernel<<<blocks, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      x, d, static_cast<const bf16*>(w), b, out, m, dims);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerf_fused_render(const float* points, const float* dirs,
                                 const float* deltas, const void* w,
                                 const float* b, float* out, long long n, int k,
                                 int input_layers, int mid_layers, int hidden,
                                 int color, int x_freqs, int d_freqs,
                                 void* stream) {
  using namespace nerf;
  if (n == 0) return 0;
  cudaError_t err = allow_smem(fused_render_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const MlpDims dims{input_layers, mid_layers, hidden, color, x_freqs, d_freqs};
  const int rays = kRows / k;
  const unsigned int blocks = static_cast<unsigned int>((n + rays - 1) / rays);
  fused_render_kernel<<<blocks, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      points, dirs, deltas, static_cast<const bf16*>(w), b, out, n, k, dims);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
