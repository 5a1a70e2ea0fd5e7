// Shared helpers for the port's Hopper kernels (plain C launch interface,
// bound from Python with ctypes; see ops/_cuda.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PORT_API extern "C" __attribute__((visibility("default")))

static __device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum over the `width` consecutive lanes that share one row (width is a
// power of two dividing 32).
template <int WIDTH>
static __device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dot product of 32 float query values with 32 bf16 values at p
// (16-byte aligned).
static __device__ __forceinline__ float dot32(const float* q,
                                              const __nv_bfloat16* p) {
  float s = 0.f;
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    uint4 u = p4[v];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(h[e]);
      s = fmaf(q[v * 8 + 2 * e], f.x, s);
      s = fmaf(q[v * 8 + 2 * e + 1], f.y, s);
    }
  }
  return s;
}

// acc[0..31] += p * (32 bf16 values at ptr, 16-byte aligned).
static __device__ __forceinline__ void axpy32(float* acc, float p,
                                              const __nv_bfloat16* ptr) {
  const uint4* p4 = reinterpret_cast<const uint4*>(ptr);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    uint4 u = p4[v];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(h[e]);
      acc[v * 8 + 2 * e] = fmaf(p, f.x, acc[v * 8 + 2 * e]);
      acc[v * 8 + 2 * e + 1] = fmaf(p, f.y, acc[v * 8 + 2 * e + 1]);
    }
  }
}

static inline int launch_status() { return (int)cudaGetLastError(); }

static inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !full
static __device__ __forceinline__ void cp_async16(const void* dst,
                                                  const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
// 8 bytes global -> shared, asynchronously; zeros where !full (rows whose
// byte length is a multiple of 8 but not of 16: a bf16 row of D = 100)
static __device__ __forceinline__ void cp_async8(const void* dst,
                                                 const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 8 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronously; zeros where !full
static __device__ __forceinline__ void cp_async4(const void* dst,
                                                 const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
// BYTES (16, 8 or 4) global -> shared, asynchronously; zeros where !full
template <int BYTES>
static __device__ __forceinline__ void cp_async_n(const void* dst,
                                                  const void* src, bool full) {
  static_assert(BYTES == 16 || BYTES == 8 || BYTES == 4, "cp.async size");
  if constexpr (BYTES == 16)
    cp_async16(dst, src, full);
  else if constexpr (BYTES == 8)
    cp_async8(dst, src, full);
  else
    cp_async4(dst, src, full);
}
// the widest cp.async (16, 8 or 4 bytes) that a row of ROW_BYTES bytes
// divides into, so every copy of a row laid out at multiples of ROW_BYTES
// is aligned to its size
__host__ __device__ constexpr int copy_bytes(int row_bytes) {
  return row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : 4;
}
// a head dim padded to the 16 of an m16n8k16 k-step: the dim the kernels
// hold in registers and shared memory (D = 100 runs at 112, its padded
// lanes zero)
__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
