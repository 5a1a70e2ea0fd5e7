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
// GEMV is qmm_gemv.cuh's body: a producer warp keeps a ring of plane tiles
// (with their scale and min rows) in flight by bulk copies, x is staged in
// shared memory once per block, and K splits across a cluster of at most 8
// CTAs that sum through distributed shared memory (no memset, no atomics).
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
// GEMV (decode, M <= 8): the body lives in qmm_gemv.cuh (K4 shares it); grid
// (splits, column blocks), clusters of `splits` CTAs along K

template <int KIND, int MT, bool HAS_MIN>
__global__ void __launch_bounds__(GEMV_THREADS, 1)
qmm_gemv_kernel(const __grid_constant__ GemvMaps maps, const GemvArgs a,
                const GemvPlan p) {
  extern __shared__ __align__(128) uint8_t smem[];
  gemv_block<KIND, MT, HAS_MIN>(maps, a.x, a.M, a.K, 0, a.npk, a.lut, a.group,
                                a.out, a.M, p, smem, blockIdx.x, blockIdx.y);
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

template <int KIND, bool HAS_MIN>
struct GemvLaunch {
  template <int MT>
  static int go(const GemvArgs& g, const GemvPlan& p, cudaStream_t st) {
    constexpr int NO = gemv_no(MT);
    return gemv_launch(qmm_gemv_kernel<KIND, MT, HAS_MIN>, KIND, NO, g, p, 1,
                       1, gemv_smem(KIND, HAS_MIN, MT, NO, p, g.group).total,
                       st);
  }
  static int run(const GemvArgs& g, const GemvPlan& p, cudaStream_t st) {
    if (g.M <= 1) return go<1>(g, p, st);
    if (g.M <= 2) return go<2>(g, p, st);
    if (g.M <= 4) return go<4>(g, p, st);
    return go<8>(g, p, st);
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
// [M, pack, npk] float32. M <= 8; npk a multiple of 128; the launch plan
// of ops/qmatmul.gemv_plan (col_blocks ... x_rows), which gemv_plan_ok must
// accept. One launch: no memset, no atomics.
PORT_API int qmm_gemv(const void* x, int M, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      const void* lut, int group, void* out, void* stream,
                      int col_blocks, int splits, int rows_per_split,
                      int row_groups, int stage_rows, int stages,
                      int x_rows, int mma) {
  const GemvPlan p{col_blocks, splits, rows_per_split, row_groups,
                   stage_rows, stages, x_rows, mma};
  const int mt = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
  if (!gemm::valid(M, K, kind, minp, lut, group) || M > 8 || npk % 128 ||
      !gemv_plan_ok(kind, gemv_no(mt), K, group, npk, p))
    return (int)cudaErrorInvalidValue;
  const GemvArgs g{(const __nv_bfloat16*)x, M, K, qs, npk,
                   (const __nv_bfloat16*)scale, (const __nv_bfloat16*)minp,
                   (const float*)lut, group, (float*)out, nullptr, nullptr, 1};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool mn = minp != nullptr;
  switch (kind) {
    case 0: return mn ? GemvLaunch<0, true>::run(g, p, st)
                      : GemvLaunch<0, false>::run(g, p, st);
    case 1: return mn ? GemvLaunch<1, true>::run(g, p, st)
                      : GemvLaunch<1, false>::run(g, p, st);
    case 2: return mn ? GemvLaunch<2, true>::run(g, p, st)
                      : GemvLaunch<2, false>::run(g, p, st);
    case 3: return GemvLaunch<3, false>::run(g, p, st);
    default: return GemvLaunch<4, false>::run(g, p, st);
  }
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
