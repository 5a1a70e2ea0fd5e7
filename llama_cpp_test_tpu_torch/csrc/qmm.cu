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
// Prefill (M > 8) is bound by operations at a few hundred rows (2*M*K*N
// flops at 989 TFLOP/s bf16). What keeps a dequantizing GEMM from that
// bound is the work beside the products: every weight rebuilt as bf16 once
// per row tile, x re-read from L2 once per column tile (with the planes,
// 0.7 GB of L2 reads for a Llama-3-8B gate|up at M = 512 and 128 x 256
// tiles), the per-group x-sums of the min, and the barriers between them.
// The GEMM is the Hopper main loop of qmm_tile.cuh (TMA ring, dequantized
// 128B-swizzled tiles, wgmma, the min folded on the tensor cores), here at
// 64 x 128 tiles of one warpgroup for few rows (M <= 64, or too few 128 x
// 256 tiles to fill half the SMs), else 128 x 256 tiles of two.
#include "qmm_gemv.cuh"
#include "qmm_tile.cuh"

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
// GEMM (prefill, M > 8): qmm_tile.cuh's main loop at 64 x 128 (WG = 1) or
// 128 x 256 (WG = 2) tiles

template <int KIND, bool HAS_MIN, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
qmm_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_s,
                const __grid_constant__ CUtensorMap tm_m, int M, int K,
                int npk, const float* lut, int group, int rb,
                gemm::Routing rt, float* out) {
  gemm::tile<KIND, HAS_MIN, WG, 1, 128 * WG>(&tm_x, &tm_q, &tm_s, &tm_m, M, K,
                                             npk, lut, group, rb, rt, out);
}

using gemm::Args;

template <int KIND, int MT, bool HAS_MIN>
void launch_gemv_mt(const Args& a, dim3 grid, int rpw) {
  qmm_gemv_kernel<KIND, MT, HAS_MIN><<<grid, 32 * GEMV_WARPS, 0, a.st>>>(
      a.x, a.M, a.K, a.qs, a.npk, a.scale, a.minp, a.lut, a.group, a.out, rpw);
}

template <int KIND, bool HAS_MIN>
struct GemvLaunch {
  static int run(const Args& a) {
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
    return 0;
  }
};

// One warpgroup (64 x 128 tiles) up to M = 64, and where two-warpgroup
// tiles (128 x 256) would give fewer than half as many blocks as the card
// has SMs; two above.
template <int KIND, bool HAS_MIN>
struct GemmLaunch {
  static int run(const Args& a) {
    const int bnp2 = gemm::Plan<KIND, HAS_MIN, 2, 1, 256>::BNP;
    const int tiles2 = (a.M + 127) / 128 * ((a.npk + bnp2 - 1) / bnp2);
    if (a.M <= 64 || 2 * tiles2 < num_sms())
      return gemm::launch<gemm::Plan<KIND, HAS_MIN, 1, 1, 128>>(
          qmm_gemm_kernel<KIND, HAS_MIN, 1>, a);
    return gemm::launch<gemm::Plan<KIND, HAS_MIN, 2, 1, 256>>(
        qmm_gemm_kernel<KIND, HAS_MIN, 2>, a);
  }
};

}  // namespace

// x [M, K] bf16; qs [K, npk]; scale/min [pack, K/group, npk] bf16 (min may
// be null); lut [16] or [4] f32 for kinds 3/4, else null; out
// [M, pack, npk] float32. M <= 8; npk a multiple of 128.
PORT_API int qmm_gemv(const void* x, int M, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      const void* lut, int group, void* out, void* stream) {
  if (!gemm::valid(M, K, kind, minp, lut, group) || M > 8 || npk % 128)
    return (int)cudaErrorInvalidValue;
  return gemm::dispatch<GemvLaunch>(
      kind, gemm::make_args(x, M, K, qs, npk, scale, minp, lut, group, out,
                            stream));
}

// Same operands as qmm_gemv, any M; K a multiple of 32; group a multiple
// of 8, and with a min one of 8, 16, 32, 64 (one step's groups fill at most
// the fold's 16 K slots); npk a multiple of 128.
PORT_API int qmm_gemm(const void* x, int M, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      const void* lut, int group, void* out, void* stream) {
  if (!gemm::valid_tiles(M, K, npk, kind, minp, lut, group))
    return (int)cudaErrorInvalidValue;
  return gemm::dispatch<GemmLaunch>(
      kind, gemm::make_args(x, M, K, qs, npk, scale, minp, lut, group, out,
                            stream));
}
