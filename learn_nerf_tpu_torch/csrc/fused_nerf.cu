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
//   because Mosaic has no cumsum; here one warp per ray scans its K samples
//   with shuffles in f32.
//
// What bounds them on an H100: products.  One sample costs 591,488
// multiply-adds (1.18 MFLOP) at the paper's widths against 24 bytes in and
// 16 bytes out, so the bound is the bf16 tensor-core rate (1.254 ms for
// 2^20 samples at 989 TFLOP/s).  Next come L2, which serves all 1.2 MB of
// bf16 weights to every 128-row tile (9.8 GB per 2^20 samples), and the
// sinusoidal encodings (84 full-range sines and cosines per sample).  The
// design (nerf_mlp.cuh): a persistent grid of one block per SM; in each, one
// producer thread keeps the weights in flight through a 4-stage ring of
// 32 KB bulk copies, so no product waits on L2 latency; three encoder warps
// compute the next tile's encodings while this tile's products run; two
// consumer warpgroups of 64 rows issue wgmma and pass activations between
// layers in registers (no staging tile, no block-wide barrier).  On an H100
// (700 W) that runs at about 70 % of the tensor bound.  The weight stream,
// encodings and epilogues without the products take under 60 % of the
// kernel's time (scripts/mlp_ablations.py), so L2 is not the limit and a
// 2-block cluster with a multicast copy is left alone.  What is left is
// mostly the epilogues between layers (bias, ReLU, bf16 packing), which
// both consumer groups reach together while the tensor cores wait.
#include <cuda_runtime.h>

#include "nerf_mlp.cuh"

namespace nerf {

// Row r of tile t is input row 128 t + r.
struct PointRows {
  const float* x;
  const float* d;
  long long m;
  __device__ const float* point(long long tile, int r) const {
    const long long row = tile * kTileRows + r;
    return row < m ? x + row * 3 : nullptr;
  }
  __device__ const float* dir(long long tile, int r) const {
    const long long row = tile * kTileRows + r;
    return row < m ? d + row * 3 : nullptr;
  }
};

// A tile takes kTileRows / k whole rays (k <= 64): row r is sample r % k of
// ray rays * t + r / k; rows past rays * k run on zero inputs.
struct RayRows {
  const float* points;
  const float* dirs;
  long long n;
  int k;
  int rays;
  __device__ bool valid(long long tile, int r) const {
    return r < rays * k && tile * rays + r / k < n;
  }
  __device__ const float* point(long long tile, int r) const {
    return valid(tile, r) ? points + (tile * rays * k + r) * 3 : nullptr;
  }
  __device__ const float* dir(long long tile, int r) const {
    return valid(tile, r) ? dirs + (tile * rays + r / k) * 3 : nullptr;
  }
};

// The consumer side of both kernels: for each tile of this block, run the
// network on this group's 64 rows and hand each quad leader's two rows to
// done(tile, it, tile_row, row_pair).
template <typename Done>
__device__ __forceinline__ void consume(Smem& s, const Layers& layers, long long tiles,
                                        Done done) {
  const int group = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  Ring ring{s};
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int b = it & 1;
    mbar_wait(&s.emb_full[b], (it >> 1) & 1);
    const uint32_t offset = group * kGroupRows * kRowBytes;
    const RowPair o = mlp_rows(ring, smem_addr(s.x_emb[b]) + offset,
                               smem_addr(s.d_emb[b]) + offset, s.bias, layers);
    if (lane == 0) mbar_arrive(&s.emb_empty[b]);
    done(tile, it, group * kGroupRows + (threadIdx.x % 128 / 32) * 16 + lane / 4, o);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ d,
                     const uint8_t* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, long long m, Layers layers) {
  Smem& s = shared_storage();
  const long long tiles = (m + kTileRows - 1) / kTileRows;
  init_block(s, b, layers);
  __syncthreads();
  if (threadIdx.x < 128) {
    release_registers<kProducerRegs>();
    feed(s, w, layers, tiles, PointRows{x, d, m});
    return;
  }
  claim_registers<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  consume(s, layers, tiles, [&](long long tile, int, int r, const RowPair& o) {
    const long long row = tile * kTileRows + r;
    if (lane % 4 == 0) {
      if (row < m) reinterpret_cast<float4*>(out)[row] = o.lo;
      if (row + 8 < m) reinterpret_cast<float4*>(out)[row + 8] = o.hi;
    }
  });
}

// After both consumer groups have put a tile's per-row outputs in shared
// memory, each consumer warp scans whole rays: lanes take consecutive
// samples, 32 at a time.
__global__ void __launch_bounds__(kThreads, 1)
    fused_render_kernel(const float* __restrict__ points, const float* __restrict__ dirs,
                        const float* __restrict__ deltas, const uint8_t* __restrict__ w,
                        const float* __restrict__ b, float* __restrict__ out, long long n, int k,
                        Layers layers) {
  Smem& s = shared_storage();
  const int rays = kTileRows / k;
  const long long tiles = (n + rays - 1) / rays;
  init_block(s, b, layers);
  __syncthreads();
  if (threadIdx.x < 128) {
    release_registers<kProducerRegs>();
    feed(s, w, layers, tiles, RayRows{points, dirs, n, k, rays});
    return;
  }
  claim_registers<kConsumerRegs>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x - 128) / 32;  // 0 .. kConsumerWarps - 1
  consume(s, layers, tiles, [&](long long tile, int it, int r, const RowPair& o) {
    float4* res = s.results[it & 1];  // double-buffered: no barrier before the writes
    if (lane % 4 == 0) {
      res[r] = o.lo;
      res[r + 8] = o.hi;
    }
    named_barrier(kTileBarrier, 128 * kConsumers);

    // Transmittance scan and composite, as the Pallas kernel:
    // sig_dt = density * delta, acc = inclusive cumsum,
    // w = exp(-(acc - sig_dt)) * (1 - exp(-sig_dt)), bg = exp(-acc_K).
    for (int ray_in_tile = warp; ray_in_tile < rays; ray_in_tile += kConsumerWarps) {
      const long long ray = tile * rays + ray_in_tile;
      if (ray >= n) break;
      float carry = 0.f, fr = 0.f, fg = 0.f, fb = 0.f;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int j = j0 + lane;
        float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
        float sig_dt = 0.f;
        if (j < k) {
          row = res[ray_in_tile * k + j];
          sig_dt = row.x * deltas[ray * k + j];
        }
        float acc = sig_dt;
#pragma unroll
        for (int offset = 1; offset < 32; offset *= 2) {
          const float v = __shfl_up_sync(0xffffffffu, acc, offset);
          if (lane >= offset) acc += v;
        }
        acc += carry;
        const float weight = expf(-(acc - sig_dt)) * (1.f - expf(-sig_dt));
        fr += weight * row.y;
        fg += weight * row.z;
        fb += weight * row.w;
        carry = __shfl_sync(0xffffffffu, acc, 31);
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset /= 2) {
        fr += __shfl_xor_sync(0xffffffffu, fr, offset);
        fg += __shfl_xor_sync(0xffffffffu, fg, offset);
        fb += __shfl_xor_sync(0xffffffffu, fb, offset);
      }
      if (lane == 0) reinterpret_cast<float4*>(out)[ray] = make_float4(fr, fg, fb, expf(-carry));
    }
  });
}

// One block per SM, at most one per tile; allows the kernel's shared memory.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, long long tiles, unsigned int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  *grid = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  return err;
}

}  // namespace nerf

// Every entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns the cudaError_t of the launch (0 on success).
// `w` is PackedMLP.kernel_weights (16-byte aligned), `b` kernel_biases.

extern "C" int nerf_fused_mlp(const float* x, const float* d, const void* w, const float* b,
                              float* out, long long m, int input_layers, int mid_layers,
                              int x_freqs, int d_freqs, void* stream) {
  using namespace nerf;
  if (m == 0) return 0;
  unsigned int grid = 0;
  cudaError_t err = persistent_grid(fused_mlp_kernel, (m + kTileRows - 1) / kTileRows, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layers layers{input_layers, mid_layers, x_freqs, d_freqs};
  fused_mlp_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, d, static_cast<const uint8_t*>(w), b, out, m, layers);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerf_fused_render(const float* points, const float* dirs, const float* deltas,
                                 const void* w, const float* b, float* out, long long n, int k,
                                 int input_layers, int mid_layers, int x_freqs, int d_freqs,
                                 void* stream) {
  using namespace nerf;
  if (n == 0) return 0;
  const int rays = kTileRows / k;
  unsigned int grid = 0;
  cudaError_t err = persistent_grid(fused_render_kernel, (n + rays - 1) / rays, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layers layers{input_layers, mid_layers, x_freqs, d_freqs};
  fused_render_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      points, dirs, deltas, static_cast<const uint8_t*>(w), b, out, n, k, layers);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
