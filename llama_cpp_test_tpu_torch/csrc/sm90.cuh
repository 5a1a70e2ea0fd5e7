// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tensor
// loads, the async-proxy fence, and the warpgroup MMA (wgmma) with its
// shared-memory matrix descriptors.
//
// A 128B-swizzled tile is a stack of 1024-byte atoms of 8 rows x 128 bytes
// (64 bf16); the 16-byte chunk c of row r sits at chunk c ^ (r % 8) of that
// row (CUTLASS's Swizzle<3,4,3>). Every atom must start 1024-byte aligned.
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is fetched from the driver)

#include "common.cuh"

// Byte offset of 16-byte chunk c of row r in a 128B-swizzled tile.
static __device__ __forceinline__ uint32_t swz128(int r, int c) {
  return (uint32_t)r * 128u + ((uint32_t)(c ^ (r & 7)) << 4);
}

// mbarrier: init (one thread), arm with the bytes a TMA will deliver, and
// wait for the phase of the given parity to complete.
static __device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// A wait that outlasts ~2^32 cycles (a lost transaction) traps rather than
// hanging the card.
static __device__ __forceinline__ void mbar_wait(uint32_t bar,
                                                 uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

// TMA: one box of a 2-, 3- or 4-D tensor map into shared memory (dst 128-byte
// aligned, 1024 for a 128B-swizzled map); completion counts bytes on bar.
// Elements outside the tensor arrive as zeros.
static __device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
static __device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

static __device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver the runtime already loaded (so
// the library links no libcuda of its own)
static EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess ||
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
#endif
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A TMA map of a row-major tensor: dims innermost first (elements),
// strides in bytes of dims 1.., box in elements. False if refused.
static bool tensor_map(CUtensorMap* m, CUtensorMapDataType type, int rank,
                       const void* ptr, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swz) {
  const EncodeTiled enc = encoder();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return enc != nullptr &&
         enc(m, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Make this thread's generic-proxy shared-memory writes (plain stores)
// visible to the async proxy that wgmma reads through; then a barrier
// hands them to the warpgroups.
static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor of a tile at shared address addr, lbo/sbo in
// bytes. 128B-swizzled (swz): lbo is the stride between 64-element atoms
// along the contiguous dimension (unused for K-major), sbo between 8-row
// groups along the other. Unswizzled K-major (the interleaved layout of
// 8-row x 16-byte core matrices, 128 contiguous bytes each): lbo is the
// stride between the two core matrices along K, sbo between 8-row groups.
static __device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr,
                                                      uint32_t lbo,
                                                      uint32_t sbo,
                                                      bool swz = true) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) |
         ((uint64_t)(swz ? 1 : 0) << 62);
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
static __device__ __forceinline__ void wgmma_fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_ACC16(i) WG_ACC4(i), WG_ACC4(i + 4), WG_ACC4(i + 8), WG_ACC4(i + 12)

// d[N/2] += A[64 x 16] . B[16 x N] (N = 128 or 256), bf16 in, f32
// accumulate: A K-major (x rows), B MN-major (trans-b = 1: N contiguous).
// d[i] holds row 16 * warp + lane / 4 + 8 * ((i / 2) % 2) and column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the warpgroup's 64 x N tile.
static __device__ __forceinline__ void wgmma_bf16(float (&d)[64],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : WG_ACC16(0), WG_ACC16(16), WG_ACC16(32), WG_ACC16(48)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

static __device__ __forceinline__ void wgmma_bf16(float (&d)[128],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : WG_ACC16(0), WG_ACC16(16), WG_ACC16(32), WG_ACC16(48),
        WG_ACC16(64), WG_ACC16(80), WG_ACC16(96), WG_ACC16(112)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[4] += A[64 x 16] . B[16 x 8] with B K-major (trans-b = 0: its 8 rows
// of 16 K values each contiguous, 128B-swizzled).
static __device__ __forceinline__ void wgmma_n8_kmajor(float (&d)[4],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC4(0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef WG_ACC16
#undef WG_ACC4
