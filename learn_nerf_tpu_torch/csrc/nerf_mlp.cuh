// The vanilla NeRF MLP body shared by both fused kernels (fused_nerf.cu).
//
// One thread block evaluates the whole network for kRows sample rows:
// sinusoidal encodings -> input layers -> skip layer (split product over
// [z, x_emb]) -> mid layers -> softplus density head -> color layer (split
// product over [z, d_emb]) -> tanh rgb head.  Activations stay in shared
// memory between layers; nothing per layer touches device memory except the
// weights, which every block streams layer by layer from L2.
//
// Rounding points follow the Pallas kernels (tools/pallas_recipe/fused_mlp.py
// _kernel): every product operand is bf16, products sum in f32, biases are
// f32 and added to the f32 sums.  Activations are stored as bf16 because the
// next product rounds them to bf16 anyway.  The encodings are computed in
// f32 with an exact power-of-two scaling and full-range sinf/cosf (angles
// reach 2^9 * |x|, so neither a reduced-precision product nor __sinf will
// do).  Build without --use_fast_math.
//
// Products use WMMA 16x16x16 bf16 tiles with f32 accumulators.  Each of the
// 8 warps owns up to two 16-column slices of a layer's output for all
// kRows rows, and reads its B tiles straight from global memory.
//
// Packed operand layout (learn_nerf_tpu_torch/kernels/fused_mlp.py
// PackedMLP): every matrix is row-major [K, N] bf16 with K and N padded to
// multiples of 16 with zeros, stored back to back in this order:
//   input_layers x W_in, skip W_z [H, H], skip W_e [XE, H],
//   (mid_layers - 1) x [H, H], density [H, 16], color W_z [H, C],
//   color W_d [DE, C], rgb [C, 16]
// and every bias is f32 padded to its layer's N, in the same order.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace nerf {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kRows = 64;        // sample rows per block
constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowTiles = kRows / 16;
constexpr int kMaxHidden = 256;  // padded hidden width the smem tiles hold
constexpr int kMaxColor = 128;   // padded color width (fits the act tile)
constexpr int kMaxXEmb = 64;    // 6 * x_freqs, padded to 16
constexpr int kMaxDEmb = 32;     // 6 * d_freqs, padded to 16
// Leading dimensions carry a small skew so rows start on different banks;
// each stays a multiple of 8 bf16 / 4 f32 elements as WMMA requires, and
// every 16-row tile starts 32-byte aligned.
constexpr int kActLd = kMaxHidden + 8;
constexpr int kStageLd = kMaxHidden + 4;
constexpr int kXLd = kMaxXEmb + 8;
constexpr int kDLd = kMaxDEmb + 8;

struct MlpDims {
  int input_layers;
  int mid_layers;
  int hidden;   // padded to 16
  int color;    // padded to 16
  int x_freqs;
  int d_freqs;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// 114,688 bytes: two blocks fit on one SM.
struct Smem {
  bf16 act[kRows * kActLd];      // current layer input, bf16
  float stage[kRows * kStageLd]; // f32 product sums before bias/activation
  bf16 x_emb[kRows * kXLd];      // dead after the skip layer; then holds
                                 // the per-row results (see results())
  bf16 d_emb[kRows * kDLd];
};

// Per-row (density, r, g, b) f32, written by mlp_forward into the x_emb
// buffer once the skip layer no longer needs it (4 KB of its 9 KB).
__device__ inline float* results(Smem& s) {
  return reinterpret_cast<float*>(s.x_emb);
}

// emb[r, :width] = bf16(sinusoidal_features(coord(r, :), freqs)), zero past
// 6 * freqs.  Per input dim: the freqs sines, then the freqs cosines
// (learn_nerf_tpu/ops/encoding.py).
template <typename Coord>
__device__ void encode(Coord coord, int freqs, bf16* emb, int ld) {
  const int feats = 6 * freqs;
  const int width = round16(feats);
  for (int i = threadIdx.x; i < kRows * width; i += kThreads) {
    const int r = i / width;
    const int c = i % width;
    float v = 0.f;
    if (c < feats) {
      const int dim = c / (2 * freqs);
      const int j = c % (2 * freqs);
      const float a = ldexpf(coord(r, dim), j % freqs);  // exact x * 2^f
      v = j < freqs ? sinf(a) : cosf(a);
    }
    emb[r * ld + c] = __float2bfloat16_rn(v);
  }
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[j][i] += A[16i:16i+16, :K] @ W[:K, 16cf:16cf+16] with cf = warp + 8j.
__device__ __forceinline__ void accumulate(const bf16* A, int lda, int K,
                                           const bf16* W, int N, int warp,
                                           Acc (&acc)[2][kRowTiles]) {
  const int col_tiles = N / 16;
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[kRowTiles];
#pragma unroll
    for (int i = 0; i < kRowTiles; ++i) {
      wmma::load_matrix_sync(a[i], A + i * 16 * lda + k, lda);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cf = warp + j * kWarps;
      if (cf < col_tiles) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, W + static_cast<size_t>(k) * N + cf * 16, N);
#pragma unroll
        for (int i = 0; i < kRowTiles; ++i) {
          wmma::mma_sync(acc[j][i], a[i], b, acc[j][i]);
        }
      }
    }
  }
}

// stage[:, :N] = A @ W (+ A2 @ W2 when A2 is given).  N <= 256, multiple
// of 16.  The caller synchronises before reading stage.
__device__ void mma_layer(const bf16* A, int lda, int K, const bf16* W,
                          const bf16* A2, int lda2, int K2, const bf16* W2,
                          int N, float* stage) {
  const int warp = threadIdx.x / 32;
  if (warp >= N / 16) return;
  Acc acc[2][kRowTiles];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < kRowTiles; ++i) wmma::fill_fragment(acc[j][i], 0.f);
  }
  accumulate(A, lda, K, W, N, warp, acc);
  if (A2 != nullptr) accumulate(A2, lda2, K2, W2, N, warp, acc);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int cf = warp + j * kWarps;
    if (cf < N / 16) {
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) {
        wmma::store_matrix_sync(stage + i * 16 * kStageLd + cf * 16, acc[j][i],
                                kStageLd, wmma::mem_row_major);
      }
    }
  }
}

// act[:, :N] = bf16(activation(stage[:, :N] + bias)).
__device__ void bias_to_act(const float* stage, const float* bias, int N,
                            bool relu, bf16* act) {
  for (int i = threadIdx.x; i < kRows * N; i += kThreads) {
    const int r = i / N;
    const int c = i % N;
    float v = stage[r * kStageLd + c] + bias[c];
    if (relu) v = fmaxf(v, 0.f);
    act[r * kActLd + c] = __float2bfloat16_rn(v);
  }
}

// The network for the kRows rows whose encodings are already in s.x_emb
// and s.d_emb (followed by a __syncthreads).  Leaves (density, r, g, b)
// per row in results(s), followed by a __syncthreads.
__device__ void mlp_forward(Smem& s, const MlpDims& dims, const bf16* w,
                            const float* b) {
  const int H = dims.hidden;
  const int C = dims.color;
  const int XE = round16(6 * dims.x_freqs);
  const int DE = round16(6 * dims.d_freqs);

  // Input layers, ReLU.
  const bf16* in = s.x_emb;
  int ld = kXLd;
  int K = XE;
  for (int l = 0; l < dims.input_layers; ++l) {
    mma_layer(in, ld, K, w, nullptr, 0, 0, nullptr, H, s.stage);
    w += K * H;
    __syncthreads();
    bias_to_act(s.stage, b, H, true, s.act);
    b += H;
    __syncthreads();
    in = s.act;
    ld = kActLd;
    K = H;
  }
  // Skip layer over [z, x_emb], then the mid layers.  ReLU between them,
  // none after the last: its output z feeds both heads.
  mma_layer(s.act, kActLd, H, w, s.x_emb, kXLd, XE, w + H * H, H, s.stage);
  w += H * H + XE * H;
  __syncthreads();
  bias_to_act(s.stage, b, H, dims.mid_layers > 1, s.act);
  b += H;
  __syncthreads();
  for (int l = 1; l < dims.mid_layers; ++l) {
    mma_layer(s.act, kActLd, H, w, nullptr, 0, 0, nullptr, H, s.stage);
    w += H * H;
    __syncthreads();
    bias_to_act(s.stage, b, H, l + 1 < dims.mid_layers, s.act);
    b += H;
    __syncthreads();
  }

  float* res = results(s);
  // Density head (column 0 of a 16-wide tile): softplus as jax.nn.softplus.
  mma_layer(s.act, kActLd, H, w, nullptr, 0, 0, nullptr, 16, s.stage);
  w += H * 16;
  __syncthreads();
  if (threadIdx.x < kRows) {
    const float v = s.stage[threadIdx.x * kStageLd] + b[0];
    res[threadIdx.x * 4] = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  }
  b += 16;
  __syncthreads();
  // Color layer over [z, d_emb], ReLU.
  mma_layer(s.act, kActLd, H, w, s.d_emb, kDLd, DE, w + H * C, C, s.stage);
  w += H * C + DE * C;
  __syncthreads();
  bias_to_act(s.stage, b, C, true, s.act);
  b += C;
  __syncthreads();
  // rgb head (columns 0-2 of a 16-wide tile), tanh.
  mma_layer(s.act, kActLd, C, w, nullptr, 0, 0, nullptr, 16, s.stage);
  __syncthreads();
  if (threadIdx.x < kRows * 3) {
    const int r = threadIdx.x / 3;
    const int ch = threadIdx.x % 3;
    res[r * 4 + 1 + ch] = tanhf(s.stage[r * kStageLd + ch] + b[ch]);
  }
  __syncthreads();
}

}  // namespace nerf
