// Hopper (sm_90a) building blocks for the fused NeRF kernels, as inline
// PTX: mbarriers, the bulk copy from global to shared memory that signals
// one, thread block clusters and their distributed shared memory, named
// barriers, register reallocation between warpgroups, and the bf16 -> f32
// warpgroup matrix products (wgmma) the MLP core issues.
//
// Shared-memory operands of wgmma use the canonical K-major layout with the
// 128-byte swizzle: one 128-byte row (64 bf16 along K) per row of the
// operand (a sample row of A, an output column of B), 8-row groups 1024
// bytes apart, and within each row the 16-byte chunk c of row r stored at
// chunk c ^ (r % 8).  Every operand tile starts 1024-byte aligned; the k-th
// 16-deep step of a 64-deep slice starts 32 * k bytes into it.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace nerf {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and the bulk copy ---------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// asynchronous proxy (the bulk copies).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive, and expect `bytes` more to land (by complete_tx) in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Copies `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// --- thread block clusters and distributed shared memory ---------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: what a thread wrote before
// it is visible to all of them after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The shared::cluster address of this block's shared-memory address
// `addr` in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_shared_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_cluster_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Makes this thread's ordinary shared-memory stores visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void release_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void claim_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// --- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand tile with the
// 128-byte swizzle: start address >> 4, leading offset 1 (unused by this
// layout), stride 1024 bytes between 8-row groups, swizzle mode 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Orders the compiler's reads and writes of these registers after the
// preceding asm (a wgmma wait) and keeps them live until then: wgmma reads
// and writes its register operands asynchronously.
template <int n>
__device__ __forceinline__ void fence_regs(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int n>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[n][4]) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// Two f32 -> one register of two bf16 (round to nearest even), lo in the
// low half: the element order of a wgmma A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define NERF_F8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define NERF_F64(d)                                                                         \
  NERF_F8(d, 0), NERF_F8(d, 8), NERF_F8(d, 16), NERF_F8(d, 24), NERF_F8(d, 32), NERF_F8(d, 40), \
      NERF_F8(d, 48), NERF_F8(d, 56)
#define NERF_F128(d)                                                                           \
  NERF_F64(d), NERF_F8(d, 64), NERF_F8(d, 72), NERF_F8(d, 80), NERF_F8(d, 88), NERF_F8(d, 96), \
      NERF_F8(d, 104), NERF_F8(d, 112), NERF_F8(d, 120)

#define NERF_R64                                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define NERF_R128                                                                             \
  NERF_R64 ", "                                                                               \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "         \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d[64 x N] (+)= A[64 x 16] @ B[16 x N], bf16 operands, f32 sums, for the
// warpgroup: warp w holds rows 16w..16w+15; in lane (g = lane / 4, t =
// lane % 4) d[4j + e] is row g + 8 * (e / 2), column 8j + 2t + e % 2.
// "rs": A from registers (the fragment of one 16-deep step: rows g and
// g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9, as bf16 pairs); "ss": A from
// shared memory by descriptor.  B is K-major (no transpose).  scale_d = 0
// overwrites d, 1 accumulates.

__device__ __forceinline__ void wgmma_n256_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" NERF_R128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : NERF_F128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256_ss(float (&d)[128], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" NERF_R128
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : NERF_F128(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" NERF_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : NERF_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" NERF_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : NERF_F64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n16_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : NERF_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef NERF_F8
#undef NERF_F64
#undef NERF_F128
#undef NERF_R64
#undef NERF_R128

}  // namespace nerf
