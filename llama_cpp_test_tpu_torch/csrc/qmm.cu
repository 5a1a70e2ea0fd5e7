// K1: fused dequant-matmul over packed layout-'t' weight planes.
//
// Replaces the TPU kernel _qmm_t_kernel (llama_cpp_test_tpu/ops/qmatmul.py:145,
// launched by _qmm_t_call). Computes y[M, pack, NPK] = x[M, K] . dequant(W):
//   qs    [K, NPK]  plane of kind 0 int8, 1 u4 (nibbles), 2 u2 (crumbs),
//                   3 u4lut, 4 u2lut (codes into a 16- or 4-entry f32 LUT);
//                   sub-value h of byte b is bits [h*bits, (h+1)*bits) and
//                   feeds output column h*NPK + j
//   scale [pack, K/group, NPK] bf16 per-group scale
//   min   [pack, K/group, NPK] bf16 or null: w = scale*q - min. The min is
//         never expanded per element: it folds as (per-group x-sums) @ min,
//         as the TPU kernel does (the bsums trick).
//   lut   [16] or [4] f32 for the LUT kinds: w = scale*lut[q].
// Accumulation is float32; the output is float32.
//
// What bounds it on an H100: decode (M <= 8) reads every weight byte once
// and does ~2 flops per weight per row, far below the 295 flop/byte the
// card needs to be compute-bound, so it is bound by bytes (0.56 B per
// weight for Q4_K and IQ4_XS planes, 0.5 for Q2_K, ~0.3 for IQ1_S). The
// GEMV kernel streams the planes with coalesced loads, keeps the per-group
// partial sums in registers and applies scale and min once per group; K is
// split across the four warps of a block and across blocks (atomicAdd into
// a zeroed output) so a narrow projection still spreads over all 132 SMs.
// Prefill (M > 8) is bound by operations once M reaches a few hundred
// rows; the GEMM kernel dequantizes a 32-row packed tile (128 logical
// columns for the packed kinds) into shared memory as bf16 (the same bf16
// rounding of scale*q, or of scale*lut[q], as the TPU kernel) and runs the
// product on the tensor cores with wmma (mma.sync, 16x16x16 bf16). The LUT
// of a LUT kind is copied into shared memory once per block. It is a
// simple kernel: no cp.async/TMA pipelining, no wgmma; those are later
// work.
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
                const __nv_bfloat16* __restrict__ minp,
                const float* __restrict__ lut, int group,
                float* __restrict__ out, int rows_per_warp) {
  __shared__ float red[gemv_red_floats<KIND, MT>()];
  __shared__ float lut_s[16];
  load_lut<KIND>(lut_s, lut);
  qmm_gemv_tile<KIND, MT, HAS_MIN>(x, M, K, qs, npk, scale, minp, lut_s,
                                   group, out, rows_per_warp, red, blockIdx.x,
                                   blockIdx.y, gridDim.y);
}

// ---------------------------------------------------------------------------
// GEMM (prefill, M > 8): wmma bf16 tiles, min folded in registers

constexpr int BM = 64, BK = 32, GEMM_THREADS = 128;

// packed columns per GEMM block: 64 logical columns for int8, 128 for the
// packed kinds (a wider tile would not fit the C tile in static shared
// memory, nor its accumulators in registers)
__host__ __device__ constexpr int gemm_bnp(int kind) {
  return kind_pack(kind) == 1 ? 64 : 128 / kind_pack(kind);
}

template <int KIND, bool HAS_MIN>
__global__ void __launch_bounds__(GEMM_THREADS)
qmm_gemm_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                const uint8_t* __restrict__ qs, int npk,
                const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ minp,
                const float* __restrict__ lut, int group,
                float* __restrict__ out) {
  constexpr int PACK = kind_pack(KIND);
  constexpr int BNP = gemm_bnp(KIND);  // packed columns per block
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
  __shared__ float lut_s[16];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);
  load_lut<KIND>(lut_s, lut);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, jb = blockIdx.x * BNP;
  const int G = K / group;
  const int ng = HAS_MIN ? BK / group : 0;

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
    // bf16(scale * value) for each sub-value plane h
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
        for (int e = 0; e < 16; ++e)
          wv[e] = __float2bfloat16_rn(plane_value<KIND>(qb[e], h, lut_s) *
                                      bf2f(sb[e]));
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

struct Args {
  const __nv_bfloat16* x; int M, K; const uint8_t* qs; int npk;
  const __nv_bfloat16 *scale, *minp; const float* lut; int group;
  float* out; cudaStream_t st;
};

template <int KIND, int MT, bool HAS_MIN>
void launch_gemv_mt(const Args& a, dim3 grid, int rpw) {
  qmm_gemv_kernel<KIND, MT, HAS_MIN><<<grid, 32 * GEMV_WARPS, 0, a.st>>>(
      a.x, a.M, a.K, a.qs, a.npk, a.scale, a.minp, a.lut, a.group, a.out, rpw);
}

template <int KIND, bool HAS_MIN>
struct GemvLaunch {
  static void run(const Args& a) {
    const int nbx = a.npk / gemv_block_cols<KIND>();
    int rpw = 0;
    const int ky = gemv_k_split(a.K, a.group, nbx, num_sms(), &rpw);
    if (ky > 1)
      cudaMemsetAsync(a.out, 0,
                      (size_t)a.M * kind_pack(KIND) * a.npk * sizeof(float),
                      a.st);
    dim3 grid(nbx, ky);
    if (a.M <= 1)
      launch_gemv_mt<KIND, 1, HAS_MIN>(a, grid, rpw);
    else if (a.M <= 2)
      launch_gemv_mt<KIND, 2, HAS_MIN>(a, grid, rpw);
    else if (a.M <= 4)
      launch_gemv_mt<KIND, 4, HAS_MIN>(a, grid, rpw);
    else
      launch_gemv_mt<KIND, 8, HAS_MIN>(a, grid, rpw);
  }
};

template <int KIND, bool HAS_MIN>
struct GemmLaunch {
  static void run(const Args& a) {
    dim3 grid(a.npk / gemm_bnp(KIND), (a.M + BM - 1) / BM);
    qmm_gemm_kernel<KIND, HAS_MIN><<<grid, GEMM_THREADS, 0, a.st>>>(
        a.x, a.M, a.K, a.qs, a.npk, a.scale, a.minp, a.lut, a.group, a.out);
  }
};

// The LUT kinds carry no min (no GGML type gives them one), so they are
// instantiated without it.
template <template <int, bool> class L>
int dispatch(int kind, const Args& a) {
  const bool mn = a.minp != nullptr;
  switch (kind) {
    case 0: mn ? L<0, true>::run(a) : L<0, false>::run(a); break;
    case 1: mn ? L<1, true>::run(a) : L<1, false>::run(a); break;
    case 2: mn ? L<2, true>::run(a) : L<2, false>::run(a); break;
    case 3: L<3, false>::run(a); break;
    case 4: L<4, false>::run(a); break;
  }
  return launch_status();
}

// operands shared by both entry points; false if the kernels do not take
// them
bool valid(int M, int K, int kind, const void* minp, const void* lut,
           int group) {
  return M >= 1 && kind >= 0 && kind <= 4 && group > 0 && K % group == 0 &&
         (lut != nullptr) == kind_lut(kind) &&
         !(kind_lut(kind) && minp != nullptr);
}

}  // namespace

// x [M, K] bf16; qs [K, npk]; scale/min [pack, K/group, npk] bf16 (min may
// be null); lut [16] or [4] f32 for kinds 3/4, else null; out
// [M, pack, npk] float32. M <= 8; npk a multiple of 128.
PORT_API int qmm_gemv(const void* x, int M, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      const void* lut, int group, void* out, void* stream) {
  if (!valid(M, K, kind, minp, lut, group) || M > 8 || npk % 128)
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)x, M, K, (const uint8_t*)qs, npk,
               (const __nv_bfloat16*)scale, (const __nv_bfloat16*)minp,
               (const float*)lut, group, (float*)out, (cudaStream_t)stream};
  return dispatch<GemvLaunch>(kind, a);
}

// Same operands as qmm_gemv, any M; K a multiple of 32; with a min, group
// must divide 32 (any group dividing K without one).
PORT_API int qmm_gemm(const void* x, int M, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      const void* lut, int group, void* out, void* stream) {
  if (!valid(M, K, kind, minp, lut, group) || K % BK ||
      (minp && BK % group) || npk % gemm_bnp(kind))
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)x, M, K, (const uint8_t*)qs, npk,
               (const __nv_bfloat16*)scale, (const __nv_bfloat16*)minp,
               (const float*)lut, group, (float*)out, (cudaStream_t)stream};
  return dispatch<GemmLaunch>(kind, a);
}
