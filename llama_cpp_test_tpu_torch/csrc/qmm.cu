// K1: fused dequant-matmul over packed layout-'t' weight planes.
//
// Replaces the TPU kernel _qmm_t_kernel (llama_cpp_test_tpu/ops/qmatmul.py:145,
// launched by _qmm_t_call). Computes y[M, pack, NPK] = x[M, K] . dequant(W):
//   qs    [K, NPK]  int8 (kind 0) or uint8 nibbles (kind 1, u4: sub-value h
//                   of byte b is (b >> 4h) & 15, output column h*NPK + j)
//   scale [pack, K/group, NPK] bf16 per-group scale
//   min   [pack, K/group, NPK] bf16 or null: w = scale*q - min. The min is
//         never expanded per element: it folds as (per-group x-sums) @ min,
//         as the TPU kernel does (the bsums trick).
// Accumulation is float32; the output is float32.
//
// What bounds it on an H100: decode (M <= 8) reads every weight byte once
// and does ~2 flops per weight per row, far below the 295 flop/byte the
// card needs to be compute-bound, so it is bound by bytes (0.56 B per
// weight for Q4_K planes). The GEMV kernel streams the planes with 4-byte
// coalesced loads per lane, keeps the per-group partial sums in registers
// and applies scale and min once per group; K is split across the four warps
// of a block and across blocks (atomicAdd into a zeroed output) so a narrow
// projection still spreads over all 132 SMs. Prefill (M > 8) is bound by
// operations once M reaches a few hundred rows; the GEMM kernel dequantizes
// a 32 x 64 packed tile into shared memory as bf16 (the same bf16 rounding
// of scale*q as the TPU kernel) and runs the product on the tensor cores
// with wmma (mma.sync, 16x16x16 bf16). It is a simple kernel: no
// cp.async/TMA pipelining, no wgmma; those are later work.
#include <mma.h>

#include "qmm_gemv.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------------------
// GEMV (decode, M <= 8): the body lives in qmm_gemv.cuh (K4 shares it)

template <int KIND, int MT, bool HAS_MIN>
__global__ void __launch_bounds__(32 * GEMV_WARPS)
qmm_gemv_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                const uint8_t* __restrict__ qs, int npk,
                const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ minp, int group,
                float* __restrict__ out, int rows_per_warp) {
  __shared__ float red[gemv_red_floats<KIND, MT>()];
  qmm_gemv_tile<KIND, MT, HAS_MIN>(x, M, K, qs, npk, scale, minp, group, out,
                                   rows_per_warp, red, blockIdx.x, blockIdx.y,
                                   gridDim.y);
}

// ---------------------------------------------------------------------------
// GEMM (prefill, M > 8): wmma bf16 tiles, min folded in registers

constexpr int BM = 64, BNP = 64, BK = 32, GEMM_THREADS = 128;

template <int KIND, bool HAS_MIN>
__global__ void __launch_bounds__(GEMM_THREADS)
qmm_gemm_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                const uint8_t* __restrict__ qs, int npk,
                const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ minp, int group,
                float* __restrict__ out) {
  constexpr int PACK = KIND == 1 ? 2 : 1;
  constexpr int BN = BNP * PACK;       // logical output columns per block
  constexpr int LDA = BK + 8;          // bf16 elements
  constexpr int LDB = BN + 8;
  constexpr int LDC = BN + 4;          // float elements
  constexpr int NCT = BN / 16;         // column tiles per warp
  constexpr int PER_T = BM * BN / GEMM_THREADS;
  constexpr int AB_BYTES = (BM * LDA + BK * LDB) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float xs_s[BM][2];        // per-group x sums (group >= 16)
  __shared__ float mn_s[2][BN];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, jb = blockIdx.x * BNP;
  const int G = K / group;
  const int ng = BK / group;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[NCT];
#pragma unroll
  for (int ct = 0; ct < NCT; ++ct) wmma::fill_fragment(c[ct], 0.f);
  float acc_min[HAS_MIN ? PER_T : 1];
#pragma unroll
  for (int i = 0; i < (HAS_MIN ? PER_T : 1); ++i) acc_min[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile [BM, BK] bf16, zero rows past M
    for (int i = tid; i < BM * BK / 8; i += GEMM_THREADS) {
      const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c8);
      *reinterpret_cast<uint4*>(As + r * LDA + c8) = v;
    }
    // weight tile: 16 packed columns of one row per thread, dequantized to
    // bf16(q * scale) for each sub-value plane h
    for (int i = tid; i < BK * BNP / 16; i += GEMM_THREADS) {
      const int r = i / (BNP / 16), c16 = (i % (BNP / 16)) * 16;
      const int k = k0 + r, g = k / group;
      const uint4 qv = __ldg(reinterpret_cast<const uint4*>(
          qs + (size_t)k * npk + jb + c16));
      const uint8_t* qb = reinterpret_cast<const uint8_t*>(&qv);
#pragma unroll
      for (int h = 0; h < PACK; ++h) {
        const uint4* sp = reinterpret_cast<const uint4*>(
            scale + ((size_t)h * G + g) * npk + jb + c16);
        uint4 su[2] = {__ldg(sp), __ldg(sp + 1)};
        const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(su);
        __align__(16) __nv_bfloat16 wv[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          float q;
          if constexpr (KIND == 0)
            q = (float)(int8_t)qb[e];
          else
            q = (float)(h == 0 ? (qb[e] & 0xf) : (qb[e] >> 4));
          wv[e] = __float2bfloat16_rn(q * bf2f(sb[e]));
        }
        uint4* dst = reinterpret_cast<uint4*>(Bs + r * LDB + h * BNP + c16);
        dst[0] = reinterpret_cast<const uint4*>(wv)[0];
        dst[1] = reinterpret_cast<const uint4*>(wv)[1];
      }
    }
    if constexpr (HAS_MIN) {
      for (int i = tid; i < ng * BN; i += GEMM_THREADS) {
        const int gg = i / BN, n = i % BN;
        const int h = n / BNP, jj = n % BNP;
        const int g = k0 / group + gg;
        mn_s[gg][n] = bf2f(minp[((size_t)h * G + g) * npk + jb + jj]);
      }
    }
    __syncthreads();
    if constexpr (HAS_MIN) {
      for (int i = tid; i < BM * ng; i += GEMM_THREADS) {
        const int r = i % BM, gg = i / BM;
        float s = 0.f;
        for (int e = 0; e < group; ++e) s += bf2f(As[r * LDA + gg * group + e]);
        xs_s[r][gg] = s;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + (16 * warp) * LDA + kk, LDA);
#pragma unroll
      for (int ct = 0; ct < NCT; ++ct) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * LDB + ct * 16, LDB);
        wmma::mma_sync(c[ct], a, b, c[ct]);
      }
    }
    if constexpr (HAS_MIN) {
      __syncthreads();  // xs_s complete
#pragma unroll
      for (int i = 0; i < PER_T; ++i) {
        const int e = tid + GEMM_THREADS * i;
        const int r = e / BN, n = e % BN;
        for (int gg = 0; gg < ng; ++gg)
          acc_min[i] = fmaf(xs_s[r][gg], mn_s[gg][n], acc_min[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int ct = 0; ct < NCT; ++ct)
    wmma::store_matrix_sync(Cs + (16 * warp) * LDC + ct * 16, c[ct], LDC,
                            wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int e = tid + GEMM_THREADS * i;
    const int r = e / BN, n = e % BN;
    const int m = m0 + r;
    if (m >= M) continue;
    const int h = n / BNP, jj = n % BNP;
    float v = Cs[r * LDC + n];
    if constexpr (HAS_MIN) v -= acc_min[i];
    out[((size_t)m * PACK + h) * npk + jb + jj] = v;
  }
}

template <int KIND, int MT>
void launch_gemv_mt(dim3 grid, const __nv_bfloat16* x, int M, int K,
                    const uint8_t* qs, int npk, const __nv_bfloat16* sc,
                    const __nv_bfloat16* mn, int group, float* out, int rpw,
                    cudaStream_t st) {
  if (mn)
    qmm_gemv_kernel<KIND, MT, true><<<grid, 32 * GEMV_WARPS, 0, st>>>(
        x, M, K, qs, npk, sc, mn, group, out, rpw);
  else
    qmm_gemv_kernel<KIND, MT, false><<<grid, 32 * GEMV_WARPS, 0, st>>>(
        x, M, K, qs, npk, sc, mn, group, out, rpw);
}

template <int KIND>
void launch_gemv(dim3 grid, const __nv_bfloat16* x, int M, int K,
                 const uint8_t* qs, int npk, const __nv_bfloat16* sc,
                 const __nv_bfloat16* mn, int group, float* out, int rpw,
                 cudaStream_t st) {
  if (M <= 1)
    launch_gemv_mt<KIND, 1>(grid, x, M, K, qs, npk, sc, mn, group, out, rpw, st);
  else if (M <= 2)
    launch_gemv_mt<KIND, 2>(grid, x, M, K, qs, npk, sc, mn, group, out, rpw, st);
  else if (M <= 4)
    launch_gemv_mt<KIND, 4>(grid, x, M, K, qs, npk, sc, mn, group, out, rpw, st);
  else
    launch_gemv_mt<KIND, 8>(grid, x, M, K, qs, npk, sc, mn, group, out, rpw, st);
}

}  // namespace

// x [M, K] bf16; qs [K, npk]; scale/min [pack, K/group, npk] bf16 (min may
// be null); out [M, pack, npk] float32. kind 0 = int8, 1 = u4. M <= 8.
PORT_API int qmm_gemv(const void* x, int M, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      int group, void* out, void* stream) {
  if (M < 1 || M > 8 || (kind != 0 && kind != 1) || group <= 0 ||
      K % group || npk % 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int pack = kind == 1 ? 2 : 1;
  const int nbx = npk / 128;
  int rpw = 0;
  const int ky = gemv_k_split(K, group, nbx, num_sms(), &rpw);
  if (ky > 1)
    cudaMemsetAsync(out, 0, (size_t)M * pack * npk * sizeof(float), st);
  dim3 grid(nbx, ky);
  auto xb = (const __nv_bfloat16*)x;
  auto sc = (const __nv_bfloat16*)scale;
  auto mn = (const __nv_bfloat16*)minp;
  if (kind == 0)
    launch_gemv<0>(grid, xb, M, K, (const uint8_t*)qs, npk, sc, mn, group,
                   (float*)out, rpw, st);
  else
    launch_gemv<1>(grid, xb, M, K, (const uint8_t*)qs, npk, sc, mn, group,
                   (float*)out, rpw, st);
  return launch_status();
}

// Same operands as qmm_gemv, any M; group must divide 32.
PORT_API int qmm_gemm(const void* x, int M, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      int group, void* out, void* stream) {
  if (M < 1 || (kind != 0 && kind != 1) || group <= 0 || BK % group ||
      K % BK || npk % BNP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(npk / BNP, (M + BM - 1) / BM);
  auto xb = (const __nv_bfloat16*)x;
  auto q = (const uint8_t*)qs;
  auto sc = (const __nv_bfloat16*)scale;
  auto mn = (const __nv_bfloat16*)minp;
  float* o = (float*)out;
  if (kind == 0) {
    if (mn)
      qmm_gemm_kernel<0, true><<<grid, GEMM_THREADS, 0, st>>>(xb, M, K, q, npk, sc, mn, group, o);
    else
      qmm_gemm_kernel<0, false><<<grid, GEMM_THREADS, 0, st>>>(xb, M, K, q, npk, sc, mn, group, o);
  } else {
    if (mn)
      qmm_gemm_kernel<1, true><<<grid, GEMM_THREADS, 0, st>>>(xb, M, K, q, npk, sc, mn, group, o);
    else
      qmm_gemm_kernel<1, false><<<grid, GEMM_THREADS, 0, st>>>(xb, M, K, q, npk, sc, mn, group, o);
  }
  return launch_status();
}
