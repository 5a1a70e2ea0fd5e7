// The M = 8 dequant GEMV shared by the decode probes of tools/kbench.py
// (kernel_f, kernel_g, kernel_h; csrc/kbench.cu) and tools/pairprobe.py
// (_pairs_kernel; csrc/pairprobe.cu): y[8, N] = x[8, K] . w[K, N] with
//   w = bf16(bf16(q) * s[k / 32, n])   (q exact in bf16, one rounding)
// and f32 accumulation, over four byte layouts of the 4- and 8-bit q:
//   FMT_F      N-paired nibbles: byte (k, j) holds column j (low nibble) and
//              column j + N/2 (high); s [2, K/32, N/2]; y [8, 2, N/2]
//   FMT_G      signed int4 q - 8, two a byte: byte (k, j) holds column 2j
//              (low nibble) and 2j + 1 (high), each a 4-bit two's
//              complement; s [K/32, N]; y [8, N]
//   FMT_H      int8: byte (k, n); s [K/32, N]; y [8, N]
//   FMT_PAIRS  K-paired nibbles: byte (r, n) holds K-rows 2r (low nibble)
//              and 2r + 1 (high), q = 128 + nibble; s [K/32, N] and an f32
//              fold [K/32, N]: y = x . w - (per-group x-sums) . fold
//
// What bounds them on an H100: bytes (M = 8 rows do 16 flops per weight
// byte, far below the 295 the card needs to be compute-bound). Each lane
// streams CPL byte columns, one load a byte row, so a warp reads 32 * CPL
// contiguous bytes; it loads a whole 32-row group (16 byte rows for the
// pairs) before using any of it, which keeps 16-32 loads in flight a lane.
// The four warps of a block split its K slice and blocks split K further
// (gemv_k_split below, aimed at four blocks an SM, atomicAdd into
// a zeroed output), so even 44 column blocks fill all 132 SMs. The
// rounding of w is per element, as the TPU kernels round it, so the scale
// cannot be folded out of the group sum: each weight costs a multiply and
// two conversions besides its 8 FMAs. Simple first: no shared-memory
// staging of x, no tensor cores.
#pragma once

#include "common.cuh"

// The probes' split of K and their reduction (the GEMV design K1 and K4
// shared before they moved to qmm_gemv.cuh's staged body): GEMV_WARPS
// warps a block, K split across warps and blocks, atomicAdd into a zeroed
// output where blocks split K.
constexpr int GEMV_WARPS = 4;

template <int N>
static __device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  if constexpr (N == 4)
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  else
    return __ldg(reinterpret_cast<const uint16_t*>(p));
}

// Sum the GEMV_WARPS warps' partial sums acc[MT][NO] (each warp walked its
// own K slice) through shared memory red (GEMV_WARPS * MT * NO * 32
// floats), then one store per output, or one atomicAdd when K is split
// across blocks (ny > 1: the caller zeroed `out`). Output o of lane l, row
// m < M, lands at out + m * row_stride + col(o, l).
template <int MT, int NO, class Col>
static __device__ __forceinline__ void gemv_reduce_store(
    const float (&acc)[MT][NO], float* red, int M, float* __restrict__ out,
    size_t row_stride, Col col, int ny) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int o = 0; o < NO; ++o)
      red[((warp * MT + m) * NO + o) * 32 + lane] = acc[m][o];
  __syncthreads();
  for (int idx = threadIdx.x; idx < MT * NO * 32; idx += 32 * GEMV_WARPS) {
    const int mo = idx >> 5, l = idx & 31;
    const int m = mo / NO, o = mo % NO;
    if (m >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_WARPS; ++w) s += red[(w * MT * NO + mo) * 32 + l];
    float* dst = out + m * row_stride + col(o, l);
    if (ny == 1)
      *dst = s;
    else
      atomicAdd(dst, s);
  }
}

// Split K so that about twice as many blocks as the card has SMs run; each
// warp takes a whole number of groups. Returns gridDim.y; *rows_per_warp
// is the K rows each warp walks.
static inline int gemv_k_split(int K, int group, int nbx, int sms,
                               int* rows_per_warp) {
  const int groups = K / group;
  int ky = (2 * sms + nbx - 1) / nbx;
  ky = max(1, min(ky, (groups + GEMV_WARPS - 1) / GEMV_WARPS));
  const int gpw = (groups + GEMV_WARPS * ky - 1) / (GEMV_WARPS * ky);
  *rows_per_warp = gpw * group;
  return (groups + GEMV_WARPS * gpw - 1) / (GEMV_WARPS * gpw);
}

constexpr int FMT_F = 0, FMT_G = 1, FMT_H = 2, FMT_PAIRS = 3;
constexpr int PROBE_M = 8, PROBE_GROUP = 32;

// values a byte holds, outputs a lane holds per row
__host__ __device__ constexpr int probe_vals(int fmt) { return fmt == FMT_H ? 1 : 2; }
__host__ __device__ constexpr int probe_outs(int fmt, int cpl) {
  return fmt == FMT_PAIRS ? cpl : cpl * probe_vals(fmt);
}

// N bytes at p (N = 2, 4 or 8) as 32-bit words
template <int N>
static __device__ __forceinline__ void load_probe_bytes(const uint8_t* p,
                                                        uint32_t* w) {
  if constexpr (N == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = load_bytes<N>(p);
  }
}

// sub-value v of byte b as the exact float q of the format
template <int FMT>
static __device__ __forceinline__ float probe_value(uint32_t b, int v) {
  if constexpr (FMT == FMT_F) {
    return (float)((b >> (4 * v)) & 0xfu);
  } else if constexpr (FMT == FMT_G) {
    return (float)((int32_t)(b << (28 - 4 * v)) >> 28);
  } else if constexpr (FMT == FMT_H) {
    return (float)(int8_t)b;
  } else {
    return 128.f + (float)((b >> (4 * v)) & 0xfu);
  }
}

// slot of byte column c's sub-value v among a lane's outputs (FMT_F keeps
// the nibble plane h = v outermost, as its output does)
template <int FMT, int CPL>
static __device__ __forceinline__ int probe_slot(int c, int v) {
  if constexpr (FMT == FMT_F) return v * CPL + c;
  else if constexpr (FMT == FMT_G) return 2 * c + v;
  else return c;
}

// x [8, K] bf16; qs [K / (1 or 2), nbc] bytes; sc, fold as above; out as
// above (zeroed by the launcher when gridDim.y > 1).
template <int FMT, int CPL>
__global__ void __launch_bounds__(32 * GEMV_WARPS)
probe_gemv_kernel(const __nv_bfloat16* __restrict__ x, int K,
                  const uint8_t* __restrict__ qs, int nbc,
                  const __nv_bfloat16* __restrict__ sc,
                  const float* __restrict__ fold, float* __restrict__ out,
                  int rows_per_warp) {
  constexpr int V = probe_vals(FMT), NO = probe_outs(FMT, CPL);
  constexpr int KPB = FMT == FMT_PAIRS ? 2 : 1;   // K rows a byte row holds
  constexpr int BR = PROBE_GROUP / KPB;            // byte rows a group
  constexpr int M = PROBE_M;
  __shared__ float red[GEMV_WARPS * M * NO * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bx = blockIdx.x;
  const int c0 = (bx * 32 + lane) * CPL;           // first byte column
  const int G = K / PROBE_GROUP;
  const int n_s = FMT == FMT_G ? 2 * nbc : nbc;    // scale row length
  const int k_begin = (blockIdx.y * GEMV_WARPS + warp) * rows_per_warp;
  const int k_end = min(K, k_begin + rows_per_warp);

  float acc[M][NO];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int o = 0; o < NO; ++o) acc[m][o] = 0.f;

  for (int kg = k_begin; kg < k_end; kg += PROBE_GROUP) {
    const int g = kg / PROBE_GROUP;
    float s[NO], f[FMT == FMT_PAIRS ? NO : 1];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int v = 0; v < (FMT == FMT_PAIRS ? 1 : V); ++v) {
        const int o = probe_slot<FMT, CPL>(c, v);
        size_t idx;
        if constexpr (FMT == FMT_F) idx = ((size_t)v * G + g) * nbc + c0 + c;
        else if constexpr (FMT == FMT_G) idx = (size_t)g * n_s + 2 * c0 + o;
        else idx = (size_t)g * n_s + c0 + c;
        s[o] = bf2f(sc[idx]);
        if constexpr (FMT == FMT_PAIRS) f[o] = __ldg(fold + idx);
      }
    float xs[M];
#pragma unroll
    for (int m = 0; m < M; ++m) xs[m] = 0.f;
    // the group's bytes first: BR independent loads in flight a lane
    uint32_t wg[BR][(CPL + 3) / 4];
#pragma unroll
    for (int i = 0; i < BR; ++i)
      load_probe_bytes<CPL>(qs + (size_t)(kg / KPB + i) * nbc + c0, wg[i]);
#pragma unroll
    for (int i = 0; i < BR; ++i) {
      const int br = kg / KPB + i;
      const uint32_t* wb = wg[i];
      float xv[M][KPB];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int kk = 0; kk < KPB; ++kk) {
          xv[m][kk] = bf2f(x[(size_t)m * K + br * KPB + kk]);
          if constexpr (FMT == FMT_PAIRS) xs[m] += xv[m][kk];
        }
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const uint32_t b = (wb[c >> 2] >> (8 * (c & 3))) & 0xffu;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int o = probe_slot<FMT, CPL>(c, v);
          const float w =
              __bfloat162float(__float2bfloat16_rn(probe_value<FMT>(b, v) * s[o]));
          const int kk = FMT == FMT_PAIRS ? v : 0;
#pragma unroll
          for (int m = 0; m < M; ++m) acc[m][o] = fmaf(xv[m][kk], w, acc[m][o]);
        }
      }
    }
    if constexpr (FMT == FMT_PAIRS) {
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int o = 0; o < NO; ++o) acc[m][o] = fmaf(-xs[m], f[o], acc[m][o]);
    }
  }

  const size_t row = FMT == FMT_F || FMT == FMT_G ? 2 * (size_t)nbc : nbc;
  gemv_reduce_store<M, NO>(acc, red, M, out, row,
                           [&](int o, int l) -> size_t {
                             const int cl = (bx * 32 + l) * CPL;
                             if constexpr (FMT == FMT_F)
                               return (size_t)(o / CPL) * nbc + cl + o % CPL;
                             else if constexpr (FMT == FMT_G)
                               return 2 * (size_t)cl + o;
                             else
                               return (size_t)cl + o;
                           },
                           gridDim.y);
}

// Launch over K split by gemv_k_split at 32-row groups; K a multiple of
// 32, nbc a multiple of 32 * CPL. Returns cudaGetLastError().
template <int FMT, int CPL>
static int launch_probe_gemv(const void* x, int K, const void* qs, int nbc,
                             const void* sc, const void* fold, void* out,
                             void* stream) {
  if (K <= 0 || K % PROBE_GROUP || nbc <= 0 || nbc % (32 * CPL))
    return (int)cudaErrorInvalidValue;
  const int nbx = nbc / (32 * CPL);
  int rpw = 0;
  // about four blocks (16 warps) an SM, twice K1's GEMV: these columns
  // are few (44 blocks of them for kernel_f)
  const int ky = gemv_k_split(K, PROBE_GROUP, nbx, 2 * num_sms(), &rpw);
  cudaStream_t st = (cudaStream_t)stream;
  if (ky > 1) {
    const size_t n_out = FMT == FMT_F || FMT == FMT_G ? 2 * (size_t)nbc : nbc;
    cudaMemsetAsync(out, 0, PROBE_M * n_out * sizeof(float), st);
  }
  probe_gemv_kernel<FMT, CPL><<<dim3(nbx, ky), 32 * GEMV_WARPS, 0, st>>>(
      (const __nv_bfloat16*)x, K, (const uint8_t*)qs, nbc,
      (const __nv_bfloat16*)sc, (const float*)fold, (float*)out, rpw);
  return launch_status();
}
