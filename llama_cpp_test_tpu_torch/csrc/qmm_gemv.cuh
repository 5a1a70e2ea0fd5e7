// The decode (few-row) body of K1's GEMV, shared by qmm.cu (K1) and gmm.cu
// (K4, where each row tile first offsets the planes to its expert), and the
// plane-kind helpers every dequantizing kernel uses.
//
// One block of 32 * GEMV_WARPS threads computes gemv_block_cols<KIND>()
// packed columns (column block bx) over slice by of K (ny slices; ny > 1
// means the caller zeroed `out` and the slices meet by atomicAdd). The
// caller maps its grid onto (bx, by, ny). Each lane streams 4 packed
// columns (2 for the crumb kinds, whose bytes carry 4 values each, so a
// lane always holds 4 or 8 outputs per row) with one load per row, keeps
// per-group partial sums in registers and applies the bf16 group scale
// once per group; an affine min folds exactly as (per-group x-sum) * min,
// never expanded per element.
#pragma once

#include "common.cuh"

constexpr int GEMV_WARPS = 4;

// Plane kinds (ops/qmatmul._KIND_ID): 0 int8, 1 u4 (nibbles), 2 u2
// (crumbs), 3 u4lut (nibble codes into a 16-entry LUT), 4 u2lut (crumb
// codes into a 4-entry LUT). Sub-value h of byte b is bits
// [h*bits, (h+1)*bits) and belongs to output column h*NPK + j. K4 adds
// KIND_DENSE: a bf16 [K, N] weight, with no scale, min or LUT.
constexpr int KIND_DENSE = 5;
__host__ __device__ constexpr int kind_pack(int kind) {
  return kind == 0 || kind == KIND_DENSE ? 1
         : (kind == 1 || kind == 3)      ? 2
                                         : 4;
}
__host__ __device__ constexpr bool kind_lut(int kind) {
  return kind == 3 || kind == 4;
}
__host__ __device__ constexpr int kind_nlut(int kind) {
  return kind_lut(kind) ? 1 << (8 / kind_pack(kind)) : 0;
}

// Sub-value h of plane byte `byte` as a float: the int8 value, the
// unsigned code, or the code's LUT entry (lut in shared memory).
template <int KIND>
static __device__ __forceinline__ float plane_value(uint32_t byte, int h,
                                                    const float* lut) {
  if constexpr (KIND == 0) {
    return (float)(int8_t)byte;
  } else {
    constexpr int BITS = 8 / kind_pack(KIND);
    const uint32_t q = (byte >> (BITS * h)) & ((1u << BITS) - 1u);
    if constexpr (kind_lut(KIND))
      return lut[q];
    else
      return (float)q;
  }
}

// Copy a kind's LUT (n_lut f32 entries in device memory) into shared
// memory; every thread of the block must call it.
template <int KIND>
static __device__ __forceinline__ void load_lut(float* lut_s,
                                                const float* __restrict__ lut) {
  if constexpr (kind_lut(KIND)) {
    if (threadIdx.x < kind_nlut(KIND)) lut_s[threadIdx.x] = lut[threadIdx.x];
    __syncthreads();
  }
}

// packed columns one lane streams, and one GEMV block covers
template <int KIND>
__host__ __device__ constexpr int gemv_lane_cols() {
  return kind_pack(KIND) == 4 ? 2 : 4;
}
template <int KIND>
__host__ __device__ constexpr int gemv_block_cols() {
  return 32 * gemv_lane_cols<KIND>();
}

// floats of shared memory qmm_gemv_tile<KIND, MT, ...> needs for its
// cross-warp reduction (at most 4 * 8 * 8 * 32 floats = 32 KB)
template <int KIND, int MT>
__host__ __device__ constexpr int gemv_red_floats() {
  return GEMV_WARPS * MT * gemv_lane_cols<KIND>() * kind_pack(KIND) * 32;
}

template <int N>
static __device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  if constexpr (N == 4)
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  else
    return __ldg(reinterpret_cast<const uint16_t*>(p));
}

// N consecutive bf16 (N = 2 or 4) as floats
template <int N>
static __device__ __forceinline__ void load_bf16(const __nv_bfloat16* p,
                                                 float* f) {
  if constexpr (N == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
    float2 a = __bfloat1622float2(b[0]), c = __bfloat1622float2(b[1]);
    f[0] = a.x; f[1] = a.y; f[2] = c.x; f[3] = c.y;
  } else {
    const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(p));
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    f[0] = a.x; f[1] = a.y;
  }
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

// x [M, K] bf16 (M <= MT rows), qs [K, npk] plane of kind KIND,
// scale/min [pack, K/group, npk] bf16, lut the kind's LUT in shared memory
// (LUT kinds only); out [M, pack, npk] f32.
template <int KIND, int MT, bool HAS_MIN>
static __device__ __forceinline__ void qmm_gemv_tile(
    const __nv_bfloat16* __restrict__ x, int M, int K,
    const uint8_t* __restrict__ qs, int npk,
    const __nv_bfloat16* __restrict__ scale,
    const __nv_bfloat16* __restrict__ minp, const float* lut, int group,
    float* __restrict__ out, int rows_per_warp, float* red, int bx, int by,
    int ny) {
  constexpr int PACK = kind_pack(KIND);
  constexpr int CPL = gemv_lane_cols<KIND>();
  constexpr int NO = CPL * PACK;  // outputs per thread per row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = (bx * 32 + lane) * CPL;  // first packed column
  const int G = K / group;
  const int k_begin = (by * GEMV_WARPS + warp) * rows_per_warp;
  const int k_end = min(K, k_begin + rows_per_warp);

  const __nv_bfloat16* xr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) xr[m] = x + (size_t)min(m, M - 1) * K;

  float acc[MT][NO];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int o = 0; o < NO; ++o) acc[m][o] = 0.f;

  for (int kg = k_begin; kg < k_end; kg += group) {
    const int g = kg / group;
    float part[MT][NO];
    float xs[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xs[m] = 0.f;
#pragma unroll
      for (int o = 0; o < NO; ++o) part[m][o] = 0.f;
    }
#pragma unroll 4
    for (int k = kg; k < kg + group; ++k) {
      const uint32_t w = load_bytes<CPL>(qs + (size_t)k * npk + j0);
      float qv[NO];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const uint32_t byte = (w >> (8 * c)) & 0xffu;
#pragma unroll
        for (int h = 0; h < PACK; ++h)
          qv[h * CPL + c] = plane_value<KIND>(byte, h, lut);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = bf2f(xr[m][k]);
        if constexpr (HAS_MIN) xs[m] += xv;
#pragma unroll
        for (int o = 0; o < NO; ++o) part[m][o] = fmaf(xv, qv[o], part[m][o]);
      }
    }
    float sv[NO], mv[NO];
#pragma unroll
    for (int h = 0; h < PACK; ++h) {
      const size_t off = ((size_t)h * G + g) * npk + j0;
      load_bf16<CPL>(scale + off, sv + h * CPL);
      if constexpr (HAS_MIN) load_bf16<CPL>(minp + off, mv + h * CPL);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        acc[m][o] = fmaf(sv[o], part[m][o], acc[m][o]);
        if constexpr (HAS_MIN) acc[m][o] = fmaf(-mv[o], xs[m], acc[m][o]);
      }
  }

  gemv_reduce_store<MT, NO>(acc, red, M, out, (size_t)PACK * npk,
                            [&](int o, int l) {
                              return (size_t)(o / CPL) * npk +
                                     (bx * 32 + l) * CPL + o % CPL;
                            },
                            ny);
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
