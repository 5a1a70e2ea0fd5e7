// K5: weight-strip-cached prefill dequant-matmul.
//
// Replaces the TPU kernel _qmm_t_cache_kernel
// (llama_cpp_test_tpu/ops/qmatmul.py:276, launched by _qmm_t_cache_call).
// Computes the same function as K1 (qmm.cu): y[M, pack, NPK] =
// x[M, K] . dequant(W) over the same planes (qs [K, NPK] of kind 0-4,
// scale/min [pack, K/group, NPK] bf16, lut f32 for the LUT kinds), each
// weight rounded once as bf16(s*q) or bf16(s*lut[q]) and the min folded
// exactly: the per-group x-sums come from the staged x tile on the tensor
// cores inside the kernel, and -(xsum . min) joins the accumulators as two
// extra K slots a step (qmm_tile.cuh).
//
// What the TPU kernel is built around: each full-K weight strip is
// dequantized once into VMEM and serves every row tile of the prefill.
// What bounds it on an H100: at M = 512 the products are bound by
// operations (2*M*K*N flops; 989 TFLOP/s bf16); what keeps a dequantizing
// GEMM from that bound is rebuilding each weight as bf16 (once per row
// tile) and streaming x from L2 (once per column tile), beside the
// barriers of each step. Design: qmm_tile.cuh's Hopper main loop (TMA ring
// with mbarriers, the dequantized 128B-swizzled MN-major B tile fenced to
// the async proxy, wgmma, membership x-sums, the hi/lo fold against -min)
// at a tall tile: one block of two warpgroups takes 256 rows x 128
// columns, each warpgroup two 64-row slices, so every dequantized 64 x 128
// tile serves 256 rows (all rows up to M = 256; K1 serves 128), and a
// Llama-3-8B prefill of 512 rows dequantizes each weight twice. The strip
// is streamed in 64-deep steps rather than held whole: shared memory holds
// 227 KB, and a ring keeps the loads ahead of the products. A cluster of
// CTAs sharing one dequantized tile through distributed shared memory
// would reach 512 rows; this tile needs no cluster synchronisation, at the
// cost of reading x from L2 twice as often as K1 (128 columns a block).
#include "qmm_gemv.cuh"
#include "qmm_tile.cuh"

namespace {

constexpr int MAX_K = 4096;  // the reference's cache route (K <= 4096)
constexpr int CACHE_WG = 2, CACHE_RH = 2, CACHE_BN = 128;

template <int KIND, bool HAS_MIN>
using CachePlan = gemm::Plan<KIND, HAS_MIN, CACHE_WG, CACHE_RH, CACHE_BN>;

template <int KIND, bool HAS_MIN>
__global__ void __launch_bounds__(128 * CACHE_WG, 1)
qmm_cache_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_s,
                 const __grid_constant__ CUtensorMap tm_m, int M, int K,
                 int npk, const float* lut, int group, int rb,
                 gemm::Routing rt, float* out) {
  gemm::tile<KIND, HAS_MIN, CACHE_WG, CACHE_RH, CACHE_BN>(
      &tm_x, &tm_q, &tm_s, &tm_m, M, K, npk, lut, group, rb, rt, out);
}

template <int KIND, bool HAS_MIN>
struct CacheLaunch {
  static int run(const gemm::Args& a) {
    return gemm::launch<CachePlan<KIND, HAS_MIN>>(
        qmm_cache_kernel<KIND, HAS_MIN>, a);
  }
};

}  // namespace

// x [M, K] bf16; qs [K, npk] plane of kind 0-4; scale/min [pack, K/group,
// npk] bf16 (min may be null); lut [16] or [4] f32 for kinds 3/4, else
// null; out [M, pack, npk] float32. K <= 4096 and a multiple of 128; group
// a multiple of 8, with a min one of 8, 16, 32, 64; npk a multiple of 128.
// The LUT kinds carry no min.
PORT_API int qmm_cache(const void* x, int M, int K, const void* qs, int npk,
                       int kind, const void* scale, const void* minp,
                       const void* lut, int group, void* out, void* stream) {
  if (!gemm::valid_tiles(M, K, npk, kind, minp, lut, group) || K > MAX_K ||
      K % 128)
    return (int)cudaErrorInvalidValue;
  return gemm::dispatch<CacheLaunch>(
      kind, gemm::make_args(x, M, K, qs, npk, scale, minp, lut, group, out,
                            stream));
}
