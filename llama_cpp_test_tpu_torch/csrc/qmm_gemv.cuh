// The decode (few-row) body of K1's GEMV, shared by qmm.cu (K1) and gmm.cu
// (K4, where each row tile first offsets the planes to its expert).
//
// One block of 32 * GEMV_WARPS threads computes 128 packed columns (column
// block bx) over slice by of K (ny slices; ny > 1 means the caller zeroed
// `out` and the slices meet by atomicAdd). The caller maps its grid onto
// (bx, by, ny). Each lane streams
// 4 packed columns with 4-byte loads, keeps per-group partial sums in
// registers and applies the bf16 group scale once per group; an affine min
// folds exactly as (per-group x-sum) * min, never expanded per element.
#pragma once

#include "common.cuh"

constexpr int GEMV_WARPS = 4;

// floats of shared memory qmm_gemv_tile<KIND, MT, ...> needs for its
// cross-warp reduction
template <int KIND, int MT>
__host__ __device__ constexpr int gemv_red_floats() {
  return GEMV_WARPS * MT * 4 * (KIND == 1 ? 2 : 1) * 32;
}

// x [M, K] bf16 (M <= MT rows), qs [K, npk] int8 (KIND 0) or u4 nibbles
// (KIND 1), scale/min [pack, K/group, npk] bf16; out [M, pack, npk] f32.
template <int KIND, int MT, bool HAS_MIN>
static __device__ __forceinline__ void qmm_gemv_tile(
    const __nv_bfloat16* __restrict__ x, int M, int K,
    const uint8_t* __restrict__ qs, int npk,
    const __nv_bfloat16* __restrict__ scale,
    const __nv_bfloat16* __restrict__ minp, int group,
    float* __restrict__ out, int rows_per_warp, float* red, int bx, int by,
    int ny) {
  constexpr int PACK = KIND == 1 ? 2 : 1;
  constexpr int NO = 4 * PACK;  // outputs per thread per row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = (bx * 32 + lane) * 4;  // first packed column
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
      const uint32_t w =
          __ldg(reinterpret_cast<const uint32_t*>(qs + (size_t)k * npk + j0));
      float qv[NO];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t byte = (w >> (8 * c)) & 0xffu;
        if constexpr (KIND == 0) {
          qv[c] = (float)(int8_t)byte;
        } else {
          qv[c] = (float)(byte & 0xfu);
          qv[4 + c] = (float)(byte >> 4);
        }
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
      const uint2 su = __ldg(reinterpret_cast<const uint2*>(scale + off));
      const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&su);
      float2 a = __bfloat1622float2(s2[0]), b = __bfloat1622float2(s2[1]);
      sv[h * 4 + 0] = a.x; sv[h * 4 + 1] = a.y;
      sv[h * 4 + 2] = b.x; sv[h * 4 + 3] = b.y;
      if constexpr (HAS_MIN) {
        const uint2 mu = __ldg(reinterpret_cast<const uint2*>(minp + off));
        const __nv_bfloat162* m2 = reinterpret_cast<const __nv_bfloat162*>(&mu);
        a = __bfloat1622float2(m2[0]);
        b = __bfloat1622float2(m2[1]);
        mv[h * 4 + 0] = a.x; mv[h * 4 + 1] = a.y;
        mv[h * 4 + 2] = b.x; mv[h * 4 + 3] = b.y;
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        acc[m][o] = fmaf(sv[o], part[m][o], acc[m][o]);
        if constexpr (HAS_MIN) acc[m][o] = fmaf(-mv[o], xs[m], acc[m][o]);
      }
  }

  // reduce the warps' partial sums, then one add (or atomicAdd when K is
  // split across blocks) per output
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
    const int h = o / 4, c = o % 4;
    float* dst = out + ((size_t)m * PACK + h) * npk + (bx * 32 + l) * 4 + c;
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
