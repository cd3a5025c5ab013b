// The Instant-NGP MLP forward after the hash-grid encode, in one launch,
// with a plain C interface for ctypes (learn_nerf_tpu_torch/kernels/build.py).
//
// ngp_mlp_kernel computes models.InstantNGPModel's f32 forward from the
// encoding on, for enc [R, E] (E = 12 or 32) and directions d [R, 3]:
//   h = relu(Linear(E, 64)(enc)); out = Linear(64, 16)(h);
//   density = expf(out[:, 0]);
//   d_emb = sinusoidal_features(d, 4): per dim the 4 sines, then the 4
//   cosines, of d * 2^f;
//   rgb = tanhf(Linear(64, 3)(relu(Linear(64, 64)(relu(Linear(40, 64)(
//         [d_emb, out]))))))
// and writes density [R, 1] and rgb [R, 3].  It replaces no TPU kernel: the
// JAX package leaves these 64-wide layers to XLA, and the port ran them as
// five cuBLAS/CUTLASS GEMMs and a dozen elementwise kernels (sin, cos, cat,
// relu, exp, tanh), each through device memory.
//
// Precision is the model's: f32 products and f32 sums on the CUDA cores
// (fmaf), each output summed from its bias in the order of its inputs;
// expf, tanhf, sinf and cosf, built without fast math.  Only the order of
// the sums differs from cuBLAS's.  No atomics: the kernel is deterministic.
//
// What bounds it on an H100: operations.  A row is 9,920 multiply-adds at
// E = 32 against 156 bytes of I/O (enc and d in, density and rgb out): a
// served tile's 24,576 rows are 0.488 GFLOP, 7.3 us at 67 TFLOP/s, against
// 3.8 MB, 1.1 us at 3.35 TB/s.  So the design spends its shared-memory
// loads, which take instruction slots from the FFMAs, as sparingly as it can.
// Design:
// - each block stages every parameter once into shared memory (40.5 KB at
//   E = 32), straight from the nn.Linear weights [out, in]: a weight row's
//   stride is padded to 4 floats times an odd number, so the 8 rows that a
//   warp reads at once lie in distinct banks;
// - a tile of 192 rows keeps its activations in shared memory, input-major
//   ([k][row]), in two buffers that the layers pass between them and a
//   third for the colour input; each layer is a small GEMM over the tile;
// - a thread computes a register tile of 4 rows x 8 outputs of a 64-wide
//   layer (4 x 2 of the 16-wide one): for 4 inputs it loads 4 float4 of
//   activations (one address for the 8 threads of its row group) and 8
//   float4 of weights (one row each), 12 shared loads for 128 FFMA.  A
//   thread a row with its activations in registers would load one float4
//   of weights for every 4 FFMA, and hold 128 floats live in a 64-wide
//   layer.  On the H100, tiles of 8 x 8 (fewer threads), of 4 x 4 (twice
//   the threads) and a fully unrolled input loop (spills) were each slower;
// - one persistent block an SM (12 warps) walks the tiles, so the weights
//   load once an SM, by asynchronous copies (cp.async) that overlap the
//   first tile's loads; a tile starts all its loads before it uses one.
//   A served tile's 24,576 rows are one tile for each of 128 SMs.  Two
//   blocks of 96 rows an SM (two copies of the weights) took 22.0 us
//   there against 19.1 (and 489 against 504 us at 786,432 rows);
// - d_emb is computed while the tile's encoding loads, the density's exp
//   and the colour's tanh in place; each output is written once.

#include <cuda_runtime.h>

namespace nerf {
namespace ngp {

constexpr int kHidden = 64;
constexpr int kDensity = 16;
constexpr int kDirFreqs = 4;
constexpr int kDirFeatures = 6 * kDirFreqs;        // 24
constexpr int kColorIn = kDirFeatures + kDensity;  // 40
constexpr int kTileRows = 192;
constexpr int kColGroups = 8;                      // a thread's outputs are tx + 8 j
constexpr int kRowGroups = kTileRows / 4;           // a thread's rows are 4 ty .. 4 ty + 3
constexpr int kThreads = kRowGroups * kColGroups;   // 384
constexpr int kBlocksPerSM = 1;
constexpr int kActStride = kTileRows + 4;          // an input's row of activations
constexpr int kDirLoads = (3 * kTileRows + kThreads - 1) / kThreads;  // a thread's directions

static_assert(kTileRows % 4 == 0, "row groups of 4");
static_assert(kHidden % kColGroups == 0 && kDensity % kColGroups == 0, "whole column groups");

// A weight row's stride in shared memory: K (a multiple of 4) padded to an
// odd multiple of 4, so rows n and n + 1..7 start in distinct 4-bank groups.
constexpr int padded(int k) { return (k / 4) % 2 == 0 ? k + 4 : k; }

// Offsets, in floats, of the block's shared memory: every matrix [out, in]
// row-major at its padded stride, the biases, the two activation buffers
// [64][kActStride] and the colour input [40][kActStride].  Each offset is a
// multiple of 4 floats.
template <int E>
struct Layout {
  static constexpr int kS0 = padded(E), kS1 = padded(kHidden), kS2 = padded(kColorIn),
                       kS3 = padded(kHidden), kS4 = padded(kHidden);
  static constexpr int kW0 = 0;
  static constexpr int kW1 = kW0 + kHidden * kS0;
  static constexpr int kW2 = kW1 + kDensity * kS1;
  static constexpr int kW3 = kW2 + kHidden * kS2;
  static constexpr int kW4 = kW3 + kHidden * kS3;
  static constexpr int kB0 = kW4 + 3 * kS4;
  static constexpr int kB1 = kB0 + kHidden;
  static constexpr int kB2 = kB1 + kDensity;
  static constexpr int kB3 = kB2 + kHidden;
  static constexpr int kB4 = kB3 + kHidden;
  static constexpr int kX = kB4 + 4;
  static constexpr int kY = kX + kHidden * kActStride;
  static constexpr int kC = kY + kHidden * kActStride;
  static constexpr int kBytes = (kC + kColorIn * kActStride) * static_cast<int>(sizeof(float));
  static_assert(E % 4 == 0 && kB0 % 4 == 0 && kX % 4 == 0, "float4 alignment");
};

// The nn.Linear parameters in layer order: weights [out, in] and biases
// [out], f32, contiguous, on the device.
struct Params {
  const float* w[5];
  const float* b[5];
};

// Copies from device memory into shared memory that run while the block
// goes on (cp.async), until wait_copies().
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// src [rows, cols] row-major (cols a multiple of 4, src 16-byte aligned)
// into dst at row stride `stride`, 16 bytes a copy.
__device__ __forceinline__ void stage(float* dst, int stride, const float* src, int rows, int cols) {
  const int quads = cols / 4;
  for (int i = threadIdx.x; i < rows * quads; i += kThreads) {
    const int r = i / quads, c = 4 * (i - r * quads);
    copy16(dst + r * stride + c, src + r * cols + c);
  }
}

__device__ __forceinline__ void stage_bias(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) copy4(dst + i, src + i);
}

__device__ __forceinline__ float dot4(float acc, float a0, float a1, float a2, float a3, float4 w) {
  acc = fmaf(a0, w.x, acc);
  acc = fmaf(a1, w.y, acc);
  acc = fmaf(a2, w.z, acc);
  return fmaf(a3, w.w, acc);
}

// acc[r][j] = b[n] + sum over k in order of act[k][4 ty + r] * w[n][k], for
// n = tx + kColGroups j: act [K][kActStride], w [N][S] in shared memory.
template <int K, int S, int C>
__device__ __forceinline__ void dense(const float* __restrict__ act, const float* __restrict__ w,
                                      const float* __restrict__ b, int ty, int tx, float (&acc)[4][C]) {
  static_assert(K % 4 == 0, "inputs in fours");
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const float bias = b[tx + kColGroups * j];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][j] = bias;
  }
  const float* a_row = act + 4 * ty;
  const float* w_row = w + tx * S;
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(a_row + (k + i) * kActStride);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(w_row + kColGroups * j * S + k);
      acc[0][j] = dot4(acc[0][j], a[0].x, a[1].x, a[2].x, a[3].x, wv);
      acc[1][j] = dot4(acc[1][j], a[0].y, a[1].y, a[2].y, a[3].y, wv);
      acc[2][j] = dot4(acc[2][j], a[0].z, a[1].z, a[2].z, a[3].z, wv);
      acc[3][j] = dot4(acc[3][j], a[0].w, a[1].w, a[2].w, a[3].w, wv);
    }
  }
}

// relu(x) as torch.relu takes it: NaN stays NaN.
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// The register tile into out [N][kActStride], with or without the relu.
template <int C, bool kRelu>
__device__ __forceinline__ void store(float* __restrict__ out, int ty, int tx, const float (&acc)[4][C]) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    float4 v = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    if (kRelu) v = make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
    *reinterpret_cast<float4*>(out + (tx + kColGroups * j) * kActStride + 4 * ty) = v;
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    ngp_mlp_kernel(const float* __restrict__ enc, const float* __restrict__ dirs, long long rows,
                   const Params p, float* __restrict__ density, float* __restrict__ rgb) {
  using L = Layout<E>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* x_buf = smem + L::kX;
  float* y_buf = smem + L::kY;
  float* c_buf = smem + L::kC;  // [d_emb, density out]
  stage(smem + L::kW0, L::kS0, p.w[0], kHidden, E);
  stage(smem + L::kW1, L::kS1, p.w[1], kDensity, kHidden);
  stage(smem + L::kW2, L::kS2, p.w[2], kHidden, kColorIn);
  stage(smem + L::kW3, L::kS3, p.w[3], kHidden, kHidden);
  stage(smem + L::kW4, L::kS4, p.w[4], 3, kHidden);
  stage_bias(smem + L::kB0, p.b[0], kHidden);
  stage_bias(smem + L::kB1, p.b[1], kDensity);
  stage_bias(smem + L::kB2, p.b[2], kHidden);
  stage_bias(smem + L::kB3, p.b[3], kHidden);
  stage_bias(smem + L::kB4, p.b[4], 3);

  const int tid = threadIdx.x;
  const int ty = tid / kColGroups, tx = tid % kColGroups;
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    const int n = static_cast<int>(rows - row0 < kTileRows ? rows - row0 : kTileRows);
    __syncthreads();  // the last tile's colour layers are done with x_buf and c_buf

    // enc rows [row0, row0 + n) into x_buf [k][row], rows past the end 0,
    // and d_emb into c_buf[0, 24): every load started before the first use,
    // the sines and cosines computed while the encoding is in flight.
    constexpr int kQuads = E / 4;
    constexpr int kEncLoads = (kTileRows * kQuads + kThreads - 1) / kThreads;
    const float4* src = reinterpret_cast<const float4*>(enc + row0 * E);
    float4 v[kEncLoads];
#pragma unroll
    for (int s = 0; s < kEncLoads; ++s) {
      const int i = tid + s * kThreads;
      v[s] = i < n * kQuads ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float dir[kDirLoads];
#pragma unroll
    for (int s = 0; s < kDirLoads; ++s) {
      const int i = tid + s * kThreads, dim = i / kTileRows, row = i - dim * kTileRows;
      dir[s] = i < 3 * kTileRows && row < n ? __ldg(dirs + 3 * (row0 + row) + dim) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kDirLoads; ++s) {
      const int i = tid + s * kThreads, dim = i / kTileRows, row = i - dim * kTileRows;
      if (i < 3 * kTileRows) {
        float* dst = c_buf + dim * 2 * kDirFreqs * kActStride + row;
        float scale = 1.f;
#pragma unroll
        for (int f = 0; f < kDirFreqs; ++f) {
          const float angle = dir[s] * scale;  // exact: scale is 2^f
          dst[f * kActStride] = sinf(angle);
          dst[(kDirFreqs + f) * kActStride] = cosf(angle);
          scale *= 2.f;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kEncLoads; ++s) {
      const int i = tid + s * kThreads;
      if (i < kTileRows * kQuads) {
        const int row = i / kQuads, k = 4 * (i - row * kQuads);
        x_buf[(k + 0) * kActStride + row] = v[s].x;
        x_buf[(k + 1) * kActStride + row] = v[s].y;
        x_buf[(k + 2) * kActStride + row] = v[s].z;
        x_buf[(k + 3) * kActStride + row] = v[s].w;
      }
    }
    wait_copies();  // the parameters, at the first tile
    __syncthreads();
    {  // density hidden layer: x_buf[0, E) -> y_buf
      float acc[4][kHidden / kColGroups];
      dense<E, L::kS0, kHidden / kColGroups>(x_buf, smem + L::kW0, smem + L::kB0, ty, tx, acc);
      store<kHidden / kColGroups, true>(y_buf, ty, tx, acc);
    }
    __syncthreads();
    {  // density out: y_buf -> c_buf[24, 40) and the density
      float acc[4][kDensity / kColGroups];
      dense<kHidden, L::kS1, kDensity / kColGroups>(y_buf, smem + L::kW1, smem + L::kB1, ty, tx, acc);
      store<kDensity / kColGroups, false>(c_buf + kDirFeatures * kActStride, ty, tx, acc);
      if (tx == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * ty + r < n) density[row0 + 4 * ty + r] = expf(acc[r][0]);
        }
      }
    }
    __syncthreads();
    {  // colour layer 1: c_buf = [d_emb, out] -> y_buf
      float acc[4][kHidden / kColGroups];
      dense<kColorIn, L::kS2, kHidden / kColGroups>(c_buf, smem + L::kW2, smem + L::kB2, ty, tx, acc);
      store<kHidden / kColGroups, true>(y_buf, ty, tx, acc);
    }
    __syncthreads();
    {  // colour layer 2: y_buf -> x_buf
      float acc[4][kHidden / kColGroups];
      dense<kHidden, L::kS3, kHidden / kColGroups>(y_buf, smem + L::kW3, smem + L::kB3, ty, tx, acc);
      store<kHidden / kColGroups, true>(x_buf, ty, tx, acc);
    }
    __syncthreads();
    for (int row = tid; row < n; row += kThreads) {  // rgb: a thread a row
      const float* w4 = smem + L::kW4;
      float acc[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = smem[L::kB4 + c];
#pragma unroll 4
      for (int k = 0; k < kHidden; k += 4) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = x_buf[(k + i) * kActStride + row];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[c] = dot4(acc[c], a[0], a[1], a[2], a[3], *reinterpret_cast<const float4*>(w4 + c * L::kS4 + k));
        }
      }
      float* out = rgb + 3 * (row0 + row);
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = tanhf(acc[c]);
    }
  }
}

template <int E>
cudaError_t launch(const float* enc, const float* dirs, long long rows, const Params& p, float* density,
                   float* rgb, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ngp_mlp_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<E>::kBytes);
  }
  if (err != cudaSuccess) return err;
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  const long long slots = static_cast<long long>(sms) * kBlocksPerSM;
  const unsigned int grid = static_cast<unsigned int>(tiles < slots ? tiles : slots);
  ngp_mlp_kernel<E><<<grid, kThreads, Layout<E>::kBytes, stream>>>(enc, dirs, rows, p, density, rgb);
  return cudaGetLastError();
}

}  // namespace ngp
}  // namespace nerf

// enc [rows, enc_dim], dirs [rows, 3], density [rows] and rgb [rows, 3],
// f32 and contiguous on the device; w_i [out, in] and b_i [out] the five
// nn.Linear layers' parameters in order, f32 and contiguous (64 x enc_dim,
// 16 x 64, 64 x 40, 64 x 64, 3 x 64); enc and every w_i 16-byte aligned.
// enc_dim is 12 or 32.  Launches on the given stream, allocates nothing, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
extern "C" int nerf_ngp_mlp(const float* enc, const float* dirs, long long rows, int enc_dim,
                            const float* w0, const float* b0, const float* w1, const float* b1,
                            const float* w2, const float* b2, const float* w3, const float* b3,
                            const float* w4, const float* b4, float* density, float* rgb, void* stream) {
  using namespace nerf::ngp;
  if (rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const Params p{{w0, w1, w2, w3, w4}, {b0, b1, b2, b3, b4}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (enc_dim) {
    case 12: return static_cast<int>(launch<12>(enc, dirs, rows, p, density, rgb, s));
    case 32: return static_cast<int>(launch<32>(enc, dirs, rows, p, density, rgb, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
