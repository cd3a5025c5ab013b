// The vanilla NeRF MLP core shared by both fused kernels (fused_nerf.cu),
// written for Hopper: wgmma products, weights streamed through a ring of
// shared-memory stages by bulk copies, activations kept in registers.
//
// The network: sinusoidal encodings -> input layers -> skip layer (split
// product over [z, x_emb]) -> mid layers -> softplus density head -> color
// layer (split product over [z, d_emb]) -> tanh rgb head.
//
// Roles.  A block (CTA) of three warpgroups walks 128-row tiles.  The first
// warpgroup feeds (it gives up registers): its thread 0 keeps bulk copies of
// the weights in flight, kStages stages of up to 32 KB ahead, walking the
// layer sequence once per tile; its warps 1-3 write each tile's encodings
// into one of two shared-memory buffers while the previous tile's products
// run.  The two consumer warpgroups each own 64 rows of the tile and run
// the whole network on them; both read every stage and each encoding
// buffer, and each of their 8 warps releases a stage, or a buffer, once its
// products on it have completed.
//
// Products.  wgmma m64nNk16, bf16 operands, f32 sums: N = 256 for the
// hidden layers, 128 for the color layer, 16 for each head.  The first
// layer and the second operands of the split layers (x_emb, d_emb) take A
// from the encoding buffers in shared memory.  Every later
// layer takes A from registers: layer l's f32 accumulator gets its bias
// and ReLU, is rounded to bf16 and becomes layer l+1's A fragments (the
// m64nNk16 accumulator and the k16 A fragment share one row/column
// layout, see to_fragments).  No activation goes through shared memory and
// no block-wide barrier sits between layers; only the ring's barriers do.
//
// Numerics follow the Pallas kernels (tools/pallas_recipe/fused_mlp.py
// _kernel): bf16 product operands, f32 sums, f32 biases added to the f32
// sums, bf16 activations between layers.  The encodings are computed in f32
// with an exact power-of-two scaling and full-range sincosf (angles reach
// 2^9 * |x|, so neither a reduced-precision product nor __sinf will do).
// Build without --use_fast_math.
//
// Widths are compiled in at the paper's padded full widths (hidden 256,
// color 128, 64 x features, 32 d features); PackedMLP pads narrower models
// to them with zeros, which changes no result.  Layer counts and
// frequencies are runtime arguments.
//
// Weight stream (PackedMLP.kernel_weights, learn_nerf_tpu_torch/kernels/
// fused_mlp.py), in the order the products take it:
//   input_layers x W_in, skip W_z [H, H], skip W_e [XE, H],
//   (mid_layers - 1) x [H, H], density [H, 16], color W_z [H, C],
//   color W_d [DE, C], rgb [C, 16]
// each [K, N] matrix as K / 64 slices (K padded to 64) of N rows of 128
// bytes in the swizzled K-major layout of sm90.cuh, split into ring stages
// of min(32 KB, the matrix).  Biases are f32, each padded to its full N,
// and copied once per block into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "sm90.cuh"

namespace nerf {

constexpr int kHidden = 256;
constexpr int kColor = 128;
constexpr int kXFeatures = 64;  // 6 * x_freqs, padded
constexpr int kDFeatures = 32;  // 6 * d_freqs, padded
constexpr int kHead = 16;       // the density and rgb heads' product width
constexpr int kSliceK = 64;     // K of one swizzled slice: a 128-byte row
constexpr int kRowBytes = 128;

constexpr int kConsumers = 2;
constexpr int kGroupRows = 64;  // rows per consumer warpgroup
constexpr int kTileRows = kConsumers * kGroupRows;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kStageBytes = 32768;
constexpr int kStages = 4;
// Warps 1-3 of the first warpgroup encode the next tile's rows.
constexpr int kEncoderThreads = 96;
// Input plus mid layers the bias table in shared memory holds.
constexpr int kMaxHiddenLayers = 16;
constexpr int kMaxBiases = kMaxHiddenLayers * kHidden + kHead + kColor + kHead;
// 40 + 2 * 232 registers of 128 threads fit the SM's 65,536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// Named barrier of both consumer groups (0 is __syncthreads).
constexpr int kTileBarrier = 1;

struct Layers {
  int input_layers;
  int mid_layers;
  int x_freqs;
  int d_freqs;
};

struct Smem {
  uint8_t ring[kStages][kStageBytes];       // weight stages (1024-aligned)
  uint8_t x_emb[2][kTileRows * kRowBytes];  // A tiles of the encodings, swizzled,
  uint8_t d_emb[2][kTileRows * kRowBytes];  //   double-buffered across tiles
                                            //   (d: 32 of 64 columns)
  float4 results[2][kTileRows];             // fused_render: per-row outputs,
                                            //   double-buffered across tiles
  float bias[kMaxBiases];                   // kernel_biases, copied once
  uint64_t full[kStages];                   // stage landed (1 arrival + bytes)
  uint64_t empty[kStages];                  // stage consumed (one per warp)
  uint64_t emb_full[2];                     // tile encoded (each encoder thread)
  uint64_t emb_empty[2];                    // encodings consumed (one per warp)
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + room to align to 1024
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
static_assert(sizeof(Smem::ring[0]) % 1024 == 0 && sizeof(Smem::x_emb[0]) % 1024 == 0,
              "swizzled tiles must stay 1024-byte aligned");

__device__ __forceinline__ Smem& shared_storage() {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_addr(smem_raw) & 1023u)) & 1023u;
  return *reinterpret_cast<Smem*>(smem_raw + pad);
}

// The barriers (one thread) and the bias table (every thread); the caller
// then syncs the block.
__device__ __forceinline__ void init_block(Smem& s, const float* __restrict__ b,
                                           const Layers& layers) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.emb_full[i], kEncoderThreads);
      mbar_init(&s.emb_empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  const int count = (layers.input_layers + layers.mid_layers) * kHidden + kHead + kColor + kHead;
  for (int i = threadIdx.x; i < count / 4; i += kThreads) {
    reinterpret_cast<float4*>(s.bias)[i] = reinterpret_cast<const float4*>(b)[i];
  }
}

// Bytes of one [k, n] matrix in the weight stream.
__host__ __device__ constexpr uint32_t matrix_bytes(int k, int n) {
  return static_cast<uint32_t>((k + kSliceK - 1) / kSliceK * n * kRowBytes);
}

// The producer thread: streams each tile's weights through the ring.
struct Producer {
  Smem& s;
  int stage = 0;
  uint32_t phase = 0;

  __device__ void load(const uint8_t*& w, uint32_t bytes) {
    for (uint32_t offset = 0; offset < bytes; offset += kStageBytes) {
      const uint32_t size = min(bytes - offset, static_cast<uint32_t>(kStageBytes));
      mbar_wait(&s.empty[stage], phase ^ 1);  // the first pass finds it free
      mbar_arrive_expect_tx(&s.full[stage], size);
      bulk_load(s.ring[stage], w + offset, size, &s.full[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    w += bytes;
  }

  __device__ void tile(const uint8_t* w, const Layers& layers) {
    load(w, matrix_bytes(kXFeatures, kHidden));
    for (int l = 1; l < layers.input_layers; ++l) load(w, matrix_bytes(kHidden, kHidden));
    load(w, matrix_bytes(kHidden, kHidden));
    load(w, matrix_bytes(kXFeatures, kHidden));
    for (int l = 1; l < layers.mid_layers; ++l) load(w, matrix_bytes(kHidden, kHidden));
    load(w, matrix_bytes(kHidden, kHead));
    load(w, matrix_bytes(kHidden, kColor));
    load(w, matrix_bytes(kDFeatures, kColor));
    load(w, matrix_bytes(kColor, kHead));
  }
};

// A consumer warpgroup's view of the ring (both groups take every stage).
struct Ring {
  Smem& s;
  int stage = 0;
  uint32_t phase = 0;

  // Waits for the current stage to land; returns its shared address.
  __device__ __forceinline__ uint32_t wait() {
    mbar_wait(&s.full[stage], phase);
    return smem_addr(s.ring[stage]);
  }
  __device__ __forceinline__ int take() {
    const int taken = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    return taken;
  }
  // After this warp's products on stage `i` have completed.
  __device__ __forceinline__ void release(int i) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&s.empty[i]);
  }
};

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// d (+)= A @ W over kSteps 16-deep steps for one [K, N] weight matrix of the
// stream.  issue(k, b_desc, scale_d) issues step k's wgmma.  One commit
// group per stage; a stage is released once the next one's group is in
// flight and its own has completed.  Returns with every product complete.
template <int N, int kSteps, typename Issue>
__device__ __forceinline__ void product(Ring& ring, bool accumulate, Issue issue) {
  constexpr int kSliceBytes = N * kRowBytes;
  constexpr int kSlices = (kSteps + 3) / 4;
  constexpr int kChunkSteps = 4 * cmin(kSlices, kStageBytes / kSliceBytes);
  wgmma_fence();
  int previous = -1;
#pragma unroll
  for (int k0 = 0; k0 < kSteps; k0 += kChunkSteps) {
    const uint32_t base = ring.wait();
#pragma unroll
    for (int k = k0; k < cmin(k0 + kChunkSteps, kSteps); ++k) {
      const int i = k - k0;
      issue(k, sw128_desc(base + (i / 4) * kSliceBytes + (i % 4) * 32),
            accumulate || k > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (previous >= 0) ring.release(previous);
    previous = ring.take();
  }
  wgmma_wait<0>();
  ring.release(previous);
}

// a = bf16(act(acc + bias)) as the A fragments of the next product.  In the
// m64nNk16 accumulator, lane (g, t) holds row g in acc[4j], acc[4j + 1] and
// row g + 8 in acc[4j + 2], acc[4j + 3], columns 8j + 2t and 8j + 2t + 1;
// the A fragment of 16-deep step s is (row g, columns 16s + 2t..), (row
// g + 8, same), (row g, columns 16s + 8 + 2t..), (row g + 8, same): the
// accumulator pairs 4s .. 4s + 3 in order.
template <int N>
__device__ __forceinline__ void to_fragments(const float (&acc)[N / 2], const float* bias,
                                             bool relu, uint32_t (&a)[N / 16][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * (i / 2) + 2 * t);
    float lo = acc[2 * i] + b.x;
    float hi = acc[2 * i + 1] + b.y;
    if (relu) {
      lo = fmaxf(lo, 0.f);
      hi = fmaxf(hi, 0.f);
    }
    a[i / 4][i % 4] = pack_bf16(lo, hi);
  }
}

// bf16(sinusoidal_features(coord(r), freqs)) of a tile's rows into the
// swizzled A tile `emb` of kColumns columns, zero past 6 * freqs and for
// rows where coord(r) is nullptr.  Per input dim: the freqs sines, then the
// freqs cosines (learn_nerf_tpu/ops/encoding.py).  Work units are half
// rows: unit u takes row u / 2 and every other frequency from u % 2, and
// one sincosf gives a sine column and its cosine column.  The calling
// thread takes units unit0, unit0 + kEncoderThreads, ...
template <int kColumns, typename Coord>
__device__ __forceinline__ void encode(Coord coord, int freqs, uint8_t* emb, int unit0) {
  for (int u = unit0; u < 2 * kTileRows; u += kEncoderThreads) {
    const int r = u / 2;
    const float* p = coord(r);
    uint8_t* row = emb + r * kRowBytes;
    auto put = [&](int c, float v) {
      *reinterpret_cast<__nv_bfloat16*>(row + (((c >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1)) =
          __float2bfloat16_rn(v);
    };
    for (int dim = 0; dim < 3; ++dim) {
      const float x = p != nullptr ? p[dim] : 0.f;
      for (int f = u & 1; f < freqs; f += 2) {
        float sine = 0.f, cosine = 0.f;
        if (p != nullptr) sincosf(ldexpf(x, f), &sine, &cosine);  // exact x * 2^f
        put(2 * freqs * dim + f, sine);
        put(2 * freqs * dim + freqs + f, cosine);
      }
    }
    for (int c = 6 * freqs + (u & 1); c < kColumns; c += 2) put(c, 0.f);
  }
}

// The first warpgroup's work for a whole kernel: thread 0 streams every
// tile's weights through the ring, warps 1-3 encode each tile's rows into
// the embedding buffer of its parity once the consumers have released it.
// rows.point(tile, r) / rows.dir(tile, r): row r's inputs, or nullptr.
template <typename Rows>
__device__ __forceinline__ void feed(Smem& s, const uint8_t* w, const Layers& layers,
                                     long long tiles, const Rows& rows) {
  if (threadIdx.x == 0) {
    Producer producer{s};
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) producer.tile(w, layers);
  } else if (threadIdx.x >= 32) {
    const int unit0 = threadIdx.x - 32;
    int it = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      const int b = it & 1;
      mbar_wait(&s.emb_empty[b], ((it >> 1) & 1) ^ 1);  // the first pass finds it free
      encode<kXFeatures>([&](int r) { return rows.point(tile, r); }, layers.x_freqs, s.x_emb[b],
                         unit0);
      encode<kDFeatures>([&](int r) { return rows.dir(tile, r); }, layers.d_freqs, s.d_emb[b],
                         unit0);
      fence_proxy_async();
      mbar_arrive(&s.emb_full[b]);
    }
  }
}

__device__ __forceinline__ float softplus(float v) {  // as jax.nn.softplus
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// (density, r, g, b) of rows g and g + 8 of the calling warp's 16 rows,
// valid in the lanes with lane % 4 == 0.
struct RowPair {
  float4 lo, hi;
};

// The network on this consumer warpgroup's 64 rows, whose encodings are in
// its swizzled tiles at shared addresses x_emb and d_emb (written, fenced
// for the async proxy and synced across the group); `bias` is the table in
// shared memory.
__device__ __forceinline__ RowPair mlp_rows(Ring& ring, uint32_t x_emb, uint32_t d_emb,
                                            const float* bias, const Layers& layers) {
  const uint64_t xd = sw128_desc(x_emb);
  const uint64_t dd = sw128_desc(d_emb);
  float acc[kHidden / 2];
  uint32_t a[kHidden / 16][4];
  auto hidden_rs = [&](int k, uint64_t b, int sd) { wgmma_n256_rs(acc, a[k], b, sd); };
  auto hidden_x = [&](int k, uint64_t b, int sd) { wgmma_n256_ss(acc, xd + 2 * k, b, sd); };

  // Input layers, ReLU.
  product<kHidden, kXFeatures / 16>(ring, false, hidden_x);
  fence_regs(acc);
  to_fragments<kHidden>(acc, bias, true, a);
  bias += kHidden;
  for (int l = 1; l < layers.input_layers; ++l) {
    product<kHidden, kHidden / 16>(ring, false, hidden_rs);
    fence_regs(acc);
    fence_regs(a);
    to_fragments<kHidden>(acc, bias, true, a);
    bias += kHidden;
  }
  // Skip layer over [z, x_emb], then the mid layers.  ReLU between them,
  // none after the last: its output z feeds both heads.
  product<kHidden, kHidden / 16>(ring, false, hidden_rs);
  product<kHidden, kXFeatures / 16>(ring, true, hidden_x);
  fence_regs(acc);
  fence_regs(a);
  to_fragments<kHidden>(acc, bias, layers.mid_layers > 1, a);
  bias += kHidden;
  for (int l = 1; l < layers.mid_layers; ++l) {
    product<kHidden, kHidden / 16>(ring, false, hidden_rs);
    fence_regs(acc);
    fence_regs(a);
    to_fragments<kHidden>(acc, bias, l + 1 < layers.mid_layers, a);
    bias += kHidden;
  }

  // Density head: column 0 of a 16-wide product (lanes t = 0).
  float head[8];
  product<kHead, kHidden / 16>(ring, false,
                               [&](int k, uint64_t b, int sd) { wgmma_n16_rs(head, a[k], b, sd); });
  fence_regs(head);
  const float density_bias = bias[0];
  const float sigma_lo = softplus(head[0] + density_bias);
  const float sigma_hi = softplus(head[2] + density_bias);
  bias += kHead;

  // Color layer over [z, d_emb], ReLU.
  float cacc[kColor / 2];
  uint32_t c[kColor / 16][4];
  product<kColor, kHidden / 16>(ring, false,
                                [&](int k, uint64_t b, int sd) { wgmma_n128_rs(cacc, a[k], b, sd); });
  product<kColor, kDFeatures / 16>(
      ring, true, [&](int k, uint64_t b, int sd) { wgmma_n128_ss(cacc, dd + 2 * k, b, sd); });
  fence_regs(cacc);
  fence_regs(a);
  to_fragments<kColor>(cacc, bias, true, c);
  bias += kColor;

  // rgb head, tanh: columns 0 and 1 in lanes t = 0, column 2 in lanes t = 1.
  product<kHead, kColor / 16>(ring, false,
                              [&](int k, uint64_t b, int sd) { wgmma_n16_rs(head, c[k], b, sd); });
  fence_regs(head);
  fence_regs(c);
  const float blue_lo = __shfl_down_sync(0xffffffffu, head[0], 1);
  const float blue_hi = __shfl_down_sync(0xffffffffu, head[2], 1);
  const float br = bias[0], bg = bias[1], bb = bias[2];
  RowPair out;
  out.lo = make_float4(sigma_lo, tanhf(head[0] + br), tanhf(head[1] + bg), tanhf(blue_lo + bb));
  out.hi = make_float4(sigma_hi, tanhf(head[2] + br), tanhf(head[3] + bg), tanhf(blue_hi + bb));
  return out;
}

}  // namespace nerf
