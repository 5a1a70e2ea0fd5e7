// K4: grouped expert matmul over stacked expert planes (MoE FFN).
//
// Replaces the TPU kernel _gmm_kernel (llama_cpp_test_tpu/ops/gmm.py:118,
// launched by _gmm_call :200). ops/gmm.route_tokens sorts the routed
// (token, expert) rows into a scratch batch xs [Rp, K] whose row tile t
// (tile_m rows) belongs to one expert, tile_expert[t]; tile_rows[t] counts
// the tile's live rows (0 for the dead tail tiles). Computes
//   out[Rp, pack, npk] f32 = xs . W[tile_expert[t]] per tile,
// with zeros in the rows that carry no assignment, over the stacked planes
//   qs    [E, K, npk]  a plane of kind 0 int8, 1 u4, 2 u2, 3 u4lut, 4 u2lut
//                      (qmm_gemv.cuh's kinds), or kind 5: dense bf16 [E, K, N]
//   scale [E, pack, K/group, npk] bf16, min (or null) the same: w = s*q - m,
//                      or w = s*lut[q] for the LUT kinds (lut: 16 or 4 f32);
//                      a dense stack has neither.
// Each block reads its tile's expert id from device memory and offsets the
// plane pointers by it, so nothing goes back to the host and a decode step
// reads only the routed experts' planes.
//
// What bounds it on an H100. Decode (tile_m 8, R = B * top_k rows, most
// tiles hold one or two): bytes. A token reads top_k of E experts'
// planes (0.56 B a weight for Q4_K, 0.5 for Q2_K, ~0.3 for IQ1_S, 2 for a
// bf16 stack); gmm_gemv runs K1's GEMV body (qmm_gemv.cuh) on each live
// tile at the tile's own row count (1, 2, 4 or 8 rows of FMAs, chosen per
// block from tile_rows), and a dead tile's blocks exit at once. A dense
// stack takes the same shape of GEMV over 4 bf16 columns a lane. Tiles of
// one expert read the same planes; K is split across blocks as in K1, so
// tiles of one expert run side by side and the second read of a plane
// mostly hits L2. Prefill (tile_m 64): operations. gmm_gemm dequantizes a
// 32 x 128 weight tile per k-step into shared memory as the TPU kernel
// rounds it, bf16(s*q) or bf16(s*lut[q]), or copies a dense tile
// unchanged, and multiplies on the tensor cores with wmma (mma.sync
// 16x16x16 bf16, f32 accumulate). The min folds exactly, as _gmm_kernel
// folds it (xsum . min in f32, never expanded per element): each group's
// sums of the x rows (f32, from the x chunks the threads stage) split into
// bf16 hi + lo in two K slots of a fold tile, against -min (exact in bf16)
// in two rows of a fold B tile; once 8 groups fill the 16 slots, one more
// k16 product adds -(hi + lo) . min (about 2^-16 relative error on the
// min term, as K1's GEMM): 2 / group more products than the main loop
// (a fold every step cost 1.7x the time at group 32).
// The next k-step's x, plane, scale and min loads are issued into
// registers before the current product, so the global latency overlaps
// the MMAs. Every kind keeps the same thread roles: 8 threads a k-row,
// each with 128 / pack / 8 packed columns (16 bytes of int8, 8 of nibbles,
// 4 of crumbs, 32 of bf16). No cp.async/TMA ring, no wgmma: later work.
#include <mma.h>

#include "qmm_gemv.cuh"

using namespace nvcuda;

namespace {

constexpr int KIND_DENSE = 5;   // a bf16 [E, K, N] stack (no scale, no min)
constexpr int GEMV_TILE = 8;    // tile_m of the decode variant
constexpr int GM_BM = 64;       // tile_m of the prefill variant
constexpr int GM_BN = 128;      // logical output columns per block
constexpr int GM_BK = 32;
constexpr int GM_FOLD = 16;     // K slots of the min fold (8 groups)
constexpr int GM_THREADS = 256;
constexpr int DENSE_CPL = 4;    // bf16 columns a lane of the dense GEMV takes

__host__ __device__ constexpr int gmm_pack(int kind) {
  return kind == KIND_DENSE ? 1 : kind_pack(kind);
}

template <int KIND>
__device__ __forceinline__ size_t plane_elems(int K, int group, int npk) {
  return (size_t)kind_pack(KIND) * (K / group) * npk;
}

// NW 32-bit words from global memory (16-byte loads where NW allows)
template <int NW>
__device__ __forceinline__ void ldg_words(const void* p, uint32_t* r) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 v = __ldg(static_cast<const uint4*>(p) + i);
      r[4 * i] = v.x; r[4 * i + 1] = v.y; r[4 * i + 2] = v.z; r[4 * i + 3] = v.w;
    }
  } else if constexpr (NW == 2) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    r[0] = v.x; r[1] = v.y;
  } else {
    static_assert(NW == 1, "words per load");
    r[0] = __ldg(static_cast<const uint32_t*>(p));
  }
}

template <int NW>
__device__ __forceinline__ void st_words(void* p, const uint32_t* r) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i)
      static_cast<uint4*>(p)[i] =
          make_uint4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
  } else {
    static_assert(NW == 2, "words per store");
    *static_cast<uint2*>(p) = make_uint2(r[0], r[1]);
  }
}

// ---------------------------------------------------------------------------
// decode: tile_m 8, K1's GEMV body per live tile

// x [M, K] bf16 (M <= MT), w [K, n] bf16; out [M, n] f32. Lanes take
// DENSE_CPL columns each, warps and blocks split K as in qmm_gemv_tile.
template <int MT>
__device__ __forceinline__ void dense_gemv_tile(
    const __nv_bfloat16* __restrict__ x, int M, int K,
    const __nv_bfloat16* __restrict__ w, int n, float* __restrict__ out,
    int rows_per_warp, float* red, int bx, int by, int ny) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = (bx * 32 + lane) * DENSE_CPL;
  const int k_begin = (by * GEMV_WARPS + warp) * rows_per_warp;
  const int k_end = min(K, k_begin + rows_per_warp);
  const __nv_bfloat16* xr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) xr[m] = x + (size_t)min(m, M - 1) * K;
  float acc[MT][DENSE_CPL];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < DENSE_CPL; ++c) acc[m][c] = 0.f;
#pragma unroll 4
  for (int k = k_begin; k < k_end; ++k) {
    float wv[DENSE_CPL];
    load_bf16<DENSE_CPL>(w + (size_t)k * n + j0, wv);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float xv = bf2f(xr[m][k]);
#pragma unroll
      for (int c = 0; c < DENSE_CPL; ++c) acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
    }
  }
  gemv_reduce_store<MT, DENSE_CPL>(
      acc, red, M, out, (size_t)n,
      [&](int c, int l) { return (size_t)(bx * 32 + l) * DENSE_CPL + c; }, ny);
}

template <int KIND, bool HAS_MIN>
__global__ void __launch_bounds__(32 * GEMV_WARPS)
gmm_gemv_kernel(const __nv_bfloat16* __restrict__ xs, int K,
                const void* __restrict__ qs_v, int npk,
                const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ minp,
                const float* __restrict__ lut, int group,
                const int* __restrict__ tile_expert,
                const int* __restrict__ tile_rows, int n_expert,
                float* __restrict__ out, int rows_per_warp) {
  constexpr int PACK = gmm_pack(KIND);
  // tiles vary fastest: the blocks of consecutive tiles of one expert on
  // one column block and K slice run side by side and share its planes
  const int t = blockIdx.x, bx = blockIdx.y, by = blockIdx.z;
  const int rows = min(tile_rows[t], GEMV_TILE);
  if (rows <= 0) return;  // dead tile: the launcher zeroed its rows
  const int e = min(max(tile_expert[t], 0), n_expert - 1);
  xs += (size_t)t * GEMV_TILE * K;
  out += (size_t)t * GEMV_TILE * PACK * npk;
  if constexpr (KIND == KIND_DENSE) {
    const __nv_bfloat16* w =
        static_cast<const __nv_bfloat16*>(qs_v) + (size_t)e * K * npk;
    __shared__ float red[GEMV_WARPS * GEMV_TILE * DENSE_CPL * 32];
    if (rows == 1)
      dense_gemv_tile<1>(xs, 1, K, w, npk, out, rows_per_warp, red, bx, by,
                         gridDim.z);
    else if (rows <= 2)
      dense_gemv_tile<2>(xs, rows, K, w, npk, out, rows_per_warp, red, bx, by,
                         gridDim.z);
    else if (rows <= 4)
      dense_gemv_tile<4>(xs, rows, K, w, npk, out, rows_per_warp, red, bx, by,
                         gridDim.z);
    else
      dense_gemv_tile<8>(xs, rows, K, w, npk, out, rows_per_warp, red, bx, by,
                         gridDim.z);
  } else {
    const size_t pe = plane_elems<KIND>(K, group, npk);
    const uint8_t* qs = static_cast<const uint8_t*>(qs_v) + (size_t)e * K * npk;
    scale += e * pe;
    if constexpr (HAS_MIN) minp += e * pe;
    __shared__ float red[gemv_red_floats<KIND, GEMV_TILE>()];
    __shared__ float lut_s[16];
    load_lut<KIND>(lut_s, lut);
    if (rows == 1)
      qmm_gemv_tile<KIND, 1, HAS_MIN>(xs, 1, K, qs, npk, scale, minp, lut_s,
                                      group, out, rows_per_warp, red, bx, by,
                                      gridDim.z);
    else if (rows <= 2)
      qmm_gemv_tile<KIND, 2, HAS_MIN>(xs, rows, K, qs, npk, scale, minp, lut_s,
                                      group, out, rows_per_warp, red, bx, by,
                                      gridDim.z);
    else if (rows <= 4)
      qmm_gemv_tile<KIND, 4, HAS_MIN>(xs, rows, K, qs, npk, scale, minp, lut_s,
                                      group, out, rows_per_warp, red, bx, by,
                                      gridDim.z);
    else
      qmm_gemv_tile<KIND, 8, HAS_MIN>(xs, rows, K, qs, npk, scale, minp, lut_s,
                                      group, out, rows_per_warp, red, bx, by,
                                      gridDim.z);
  }
}

// ---------------------------------------------------------------------------
// prefill: tile_m 64, wmma over a dequantized bf16 shared-memory tile

template <int KIND, bool HAS_MIN>
__global__ void __launch_bounds__(GM_THREADS)
gmm_gemm_kernel(const __nv_bfloat16* __restrict__ xs, int K,
                const void* __restrict__ qs_v, int npk,
                const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ minp,
                const float* __restrict__ lut, int group,
                const int* __restrict__ tile_expert,
                const int* __restrict__ tile_rows, int n_expert,
                float* __restrict__ out) {
  constexpr bool DENSE = KIND == KIND_DENSE;
  constexpr int PACK = gmm_pack(KIND);
  constexpr int BNP = GM_BN / PACK;                // packed columns per block
  constexpr int CPT = BNP * GM_BK / GM_THREADS;    // packed columns per thread
  constexpr int QW = CPT * (DENSE ? 2 : 1) / 4;    // plane words per thread
  constexpr int SW = CPT / 2;                      // scale words per h
  constexpr int LDA = GM_BK + 8;                   // bf16 elements
  constexpr int LDB = GM_BN + 8;
  constexpr int LDF = GM_FOLD + 8;
  static_assert(CPT == 4 || CPT == 8 || CPT == 16, "packed columns a thread");
  static_assert(BNP / CPT == 8, "8 threads a k-row");
  __shared__ __align__(128) __nv_bfloat16 As[GM_BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[GM_BK * LDB];
  // the min fold: x-sum hi/lo per (row, K slot) and -min per (K slot,
  // column); slots 2 (g % 8) and 2 (g % 8) + 1 hold group g
  __shared__ __align__(128) __nv_bfloat16 Af[HAS_MIN ? GM_BM * LDF : 8];
  __shared__ __align__(128) __nv_bfloat16 Bf[HAS_MIN ? GM_FOLD * LDB : 8];
  __shared__ float lut_s[16];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int t = blockIdx.y, jb = blockIdx.x * BNP;
  const int rows = min(tile_rows[t], GM_BM);
  float* out_t = out + (size_t)t * GM_BM * PACK * npk;
  if (rows <= 0) {  // dead tile: zeros, so combine's weight 0 meets no NaN
    for (int i = tid; i < GM_BM * GM_BN; i += GM_THREADS) {
      const int r = i / GM_BN, n = i % GM_BN;
      out_t[((size_t)r * PACK + n / BNP) * npk + jb + n % BNP] = 0.f;
    }
    return;
  }
  if constexpr (!DENSE) load_lut<KIND>(lut_s, lut);
  const int e = min(max(tile_expert[t], 0), n_expert - 1);
  const char* qs = static_cast<const char*>(qs_v) +
                   (size_t)e * K * npk * (DENSE ? 2 : 1);
  if constexpr (!DENSE) {
    const size_t pe = plane_elems<KIND>(K, group, npk);
    scale += e * pe;
    if constexpr (HAS_MIN) minp += e * pe;
  }
  xs += (size_t)t * GM_BM * K;
  const int G = K / group;

  // fixed per-thread roles: x chunk (row xr, 8 columns at xc) and plane
  // chunk (k-row wr, CPT packed columns at wc)
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr = tid >> 3, wc = (tid & 7) * CPT;
  if constexpr (HAS_MIN) {
    // the fold's unused K slots stay zero in Af and Bf
    for (int i = tid; i < GM_BM * LDF; i += GM_THREADS)
      Af[i] = __float2bfloat16_rn(0.f);
    for (int i = tid; i < GM_FOLD * LDB; i += GM_THREADS)
      Bf[i] = __float2bfloat16_rn(0.f);
    __syncthreads();
  }
  float xrun = 0.f;  // x-sum of a group longer than one step, so far
  // with a min the group is a power of two (fold_group): shifts, not
  // divisions, on the step's critical path
  [[maybe_unused]] const int lg = 31 - __clz(group), gtail = G & 7;

  uint4 x_reg;
  uint32_t q_reg[QW];
  uint32_t s_reg[DENSE ? 1 : PACK * SW], m_reg[HAS_MIN ? PACK * SW : 1];

  auto load = [&](int k0) {
    x_reg = make_uint4(0, 0, 0, 0);
    if (xr < rows)
      x_reg = *reinterpret_cast<const uint4*>(xs + (size_t)xr * K + k0 + xc);
    const int k = k0 + wr;
    ldg_words<QW>(qs + ((size_t)k * npk + jb + wc) * (DENSE ? 2 : 1), q_reg);
    if constexpr (!DENSE) {
      const int g = k / group;
#pragma unroll
      for (int h = 0; h < PACK; ++h) {
        const size_t off = ((size_t)h * G + g) * npk + jb + wc;
        ldg_words<SW>(scale + off, s_reg + h * SW);
        if constexpr (HAS_MIN) ldg_words<SW>(minp + off, m_reg + h * SW);
      }
    }
  };

  // stage step k0: the x chunk, the dequantized tile and, with a min, the
  // fold's x-sums and -min rows; true if the fold is due after it
  auto store = [&](int k0) {
    *reinterpret_cast<uint4*>(As + xr * LDA + xc) = x_reg;
    if constexpr (DENSE) {
      st_words<QW>(Bs + wr * LDB + wc, q_reg);
    } else {
#pragma unroll
      for (int h = 0; h < PACK; ++h) {
        const __nv_bfloat16* sb =
            reinterpret_cast<const __nv_bfloat16*>(s_reg + h * SW);
        __align__(16) __nv_bfloat16 wv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const uint32_t byte = (q_reg[c >> 2] >> (8 * (c & 3))) & 0xffu;
          // the TPU kernel's rounding: bf16(s*q) or bf16(s*lut[q]), once
          wv[c] = __float2bfloat16_rn(
              __fmul_rn(plane_value<KIND>(byte, h, lut_s), bf2f(sb[c])));
        }
        st_words<CPT / 2>(Bs + wr * LDB + h * BNP + wc,
                          reinterpret_cast<const uint32_t*>(wv));
      }
    }
    if constexpr (!HAS_MIN) {
      return false;
    } else {
      // a window of 8 groups fills the fold's 16 K slots: group g's -min
      // in fold rows 2 (g % 8) and 2 (g % 8) + 1, written by the threads
      // of the group's first k-row in this step
      const int gs = min(group, GM_BK);  // k-rows of one group in a step
      if ((wr & (gs - 1)) == 0) {
        const int slot = 2 * (((k0 + wr) >> lg) & 7);
#pragma unroll
        for (int h = 0; h < PACK; ++h) {
          uint32_t neg[SW];
#pragma unroll
          for (int i = 0; i < SW; ++i) neg[i] = m_reg[h * SW + i] ^ 0x80008000u;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            st_words<SW>(Bf + (slot + j) * LDB + h * BNP + wc, neg);
        }
      }
      // the x-sum of the thread's 8 staged x values, summed over the lanes
      // of one group (lanes 4i..4i+3 hold one row's 32 columns) and, for a
      // group longer than a step, over its steps
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&x_reg);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(xv[i]);
        part += f.x + f.y;
      }
      const int lanes = gs / 8;  // 1, 2 or 4
      if (lanes > 1) part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (lanes > 2) part += __shfl_xor_sync(0xffffffffu, part, 2);
      const bool ends = ((k0 + GM_BK) & (group - 1)) == 0;  // a group ends
      if (group > GM_BK) {
        xrun += part;
        part = xrun;
        if (ends) xrun = 0.f;
      }
      if (ends && (tid & (lanes - 1)) == 0) {
        const int slot = 2 * (((k0 + xc) >> lg) & 7);
        const __nv_bfloat16 hi = __float2bfloat16_rn(part);
        *reinterpret_cast<__nv_bfloat162*>(Af + xr * LDF + slot) =
            __halves2bfloat162(hi, __float2bfloat16_rn(part - bf2f(hi)));
      }
      // the last window holds G % 8 groups: its other slots, written by
      // the window before, must add nothing
      const bool last = k0 + GM_BK >= K;
      if (last && gtail != 0 && (tid & 3) == 0)
        for (int c = 2 * gtail; c < GM_FOLD; ++c)
          Af[xr * LDF + c] = __float2bfloat16_rn(0.f);
      // fold when a window's 8 groups are complete, or at the end of K
      return ends && ((((k0 + GM_BK) >> lg) & 7) == 0 || last);
    }
  };

  const int wm = warp & 3, wn = warp >> 2;   // 16 rows x 64 columns per warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);

  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  // acc += A[16 rows, 16 K at a, lda] . B[16 K at b, 64 columns, LDB]
  auto mma16 = [&](const __nv_bfloat16* a_p, int lda, const __nv_bfloat16* b_p) {
    FragA a;
    wmma::load_matrix_sync(a, a_p, lda);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      FragB b;
      wmma::load_matrix_sync(b, b_p + f * 16, LDB);
      wmma::mma_sync(acc[f], a, b, acc[f]);
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    [[maybe_unused]] const bool fold = store(k0);
    __syncthreads();
    if (k0 + GM_BK < K) load(k0 + GM_BK);
#pragma unroll
    for (int kk = 0; kk < GM_BK; kk += 16)
      mma16(As + (16 * wm) * LDA + kk, LDA, Bs + kk * LDB + wn * 64);
    if constexpr (HAS_MIN) {
      if (fold) mma16(Af + (16 * wm) * LDF, LDF, Bf + wn * 64);
    }
    __syncthreads();
  }

  // rows past `rows` had zero x, so every stored row is finite; a 16-column
  // fragment never straddles two sub-value planes (BNP >= 32)
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int n0 = wn * 64 + f * 16;
    float* dst = out_t + ((size_t)(16 * wm) * PACK + n0 / BNP) * npk + jb + n0 % BNP;
    wmma::store_matrix_sync(dst, acc[f], PACK * npk, wmma::mem_row_major);
  }
}

struct Args {
  const __nv_bfloat16* xs; int T, K; const void* qs; int npk;
  const __nv_bfloat16 *scale, *minp; const float* lut; int group;
  const int *tile_expert, *tile_rows; int n_expert; float* out;
  cudaStream_t st;
};

template <int KIND, bool HAS_MIN>
struct GemvLaunch {
  static void run(const Args& a) {
    const int cols = KIND == KIND_DENSE ? 32 * DENSE_CPL : gemv_block_cols<KIND>();
    const int nbx = a.npk / cols;
    int rpw = 0;
    // a dense stack splits K at 32-row granules (it has no groups)
    const int ky = gemv_k_split(a.K, KIND == KIND_DENSE ? 32 : a.group, nbx,
                                num_sms(), &rpw);
    dim3 grid(a.T, nbx, ky);
    gmm_gemv_kernel<KIND, HAS_MIN><<<grid, 32 * GEMV_WARPS, 0, a.st>>>(
        a.xs, a.K, a.qs, a.npk, a.scale, a.minp, a.lut, a.group,
        a.tile_expert, a.tile_rows, a.n_expert, a.out, rpw);
  }
};

template <int KIND, bool HAS_MIN>
struct GemmLaunch {
  static void run(const Args& a) {
    dim3 grid(a.npk / (GM_BN / gmm_pack(KIND)), a.T);
    gmm_gemm_kernel<KIND, HAS_MIN><<<grid, GM_THREADS, 0, a.st>>>(
        a.xs, a.K, a.qs, a.npk, a.scale, a.minp, a.lut, a.group,
        a.tile_expert, a.tile_rows, a.n_expert, a.out);
  }
};

// The LUT kinds and dense stacks carry no min (no GGML type gives them
// one), so they are instantiated without it.
template <template <int, bool> class L>
int dispatch(int kind, const Args& a) {
  const bool mn = a.minp != nullptr;
  switch (kind) {
    case 0: mn ? L<0, true>::run(a) : L<0, false>::run(a); break;
    case 1: mn ? L<1, true>::run(a) : L<1, false>::run(a); break;
    case 2: mn ? L<2, true>::run(a) : L<2, false>::run(a); break;
    case 3: L<3, false>::run(a); break;
    case 4: L<4, false>::run(a); break;
    case KIND_DENSE: L<KIND_DENSE, false>::run(a); break;
  }
  return launch_status();
}

// operands both entry points take; false if the kernels do not take them
bool valid(int T, int K, int kind, const void* scale, const void* minp,
           const void* lut, int group, int n_expert) {
  if (T < 1 || n_expert < 1 || kind < 0 || kind > KIND_DENSE || group <= 0 ||
      K % group || K % GM_BK)
    return false;
  if (kind == KIND_DENSE)
    return scale == nullptr && minp == nullptr && lut == nullptr;
  return scale != nullptr && (lut != nullptr) == kind_lut(kind) &&
         !(kind_lut(kind) && minp != nullptr);
}

// groups gmm_gemm folds a min over: powers of two from 8 (whole 8-column
// chunks, and whole groups in a 32-deep step or whole steps in a group)
bool fold_group(int group) {
  return group >= 8 && (group & (group - 1)) == 0;
}

Args make_args(const void* xs, int T, int K, const void* qs, int npk,
               const void* scale, const void* minp, const void* lut, int group,
               const void* tile_expert, const void* tile_rows, int n_expert,
               void* out, void* stream) {
  return Args{(const __nv_bfloat16*)xs, T, K, qs, npk,
              (const __nv_bfloat16*)scale, (const __nv_bfloat16*)minp,
              (const float*)lut, group, (const int*)tile_expert,
              (const int*)tile_rows, n_expert, (float*)out,
              (cudaStream_t)stream};
}

}  // namespace

// xs [T*8, K] bf16; qs [E, K, npk] (kinds 0-4; kind 5: bf16 [E, K, npk]);
// scale/min [E, pack, K/group, npk] bf16 (min may be null; both null for
// kind 5); lut [16] or [4] f32 for kinds 3/4, else null; tile_expert /
// tile_rows [T] int32 on the device; out [T*8, pack, npk] float32.
// K a multiple of 32 and of group; npk a multiple of 128.
PORT_API int gmm_gemv(const void* xs, int T, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      const void* lut, int group, const void* tile_expert,
                      const void* tile_rows, int n_expert, void* out,
                      void* stream) {
  if (!valid(T, K, kind, scale, minp, lut, group, n_expert) || npk % 128)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(xs, T, K, qs, npk, scale, minp, lut, group,
                           tile_expert, tile_rows, n_expert, out, stream);
  // pad rows and dead tiles stay zero; K-split blocks atomicAdd into it
  cudaMemsetAsync(out, 0,
                  (size_t)T * GEMV_TILE * gmm_pack(kind) * npk * sizeof(float),
                  a.st);
  return dispatch<GemvLaunch>(kind, a);
}

// Same operands with 64-row tiles: xs [T*64, K], out [T*64, pack, npk].
// K a multiple of 32 and of group; npk a multiple of 128 / pack; with a
// min, group a power of two from 8.
PORT_API int gmm_gemm(const void* xs, int T, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      const void* lut, int group, const void* tile_expert,
                      const void* tile_rows, int n_expert, void* out,
                      void* stream) {
  if (!valid(T, K, kind, scale, minp, lut, group, n_expert) ||
      npk % (GM_BN / gmm_pack(kind)) || (minp && !fold_group(group)))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(xs, T, K, qs, npk, scale, minp, lut, group,
                           tile_expert, tile_rows, n_expert, out, stream);
  return dispatch<GemmLaunch>(kind, a);
}
