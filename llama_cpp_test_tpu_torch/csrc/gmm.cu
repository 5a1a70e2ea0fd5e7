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
//                      (qmm_gemv.cuh's kinds), or KIND_DENSE: bf16 [E, K, N]
//   scale [E, pack, K/group, npk] bf16, min (or null) the same: w = s*q - m,
//                      or w = s*lut[q] for the LUT kinds (lut: 16 or 4 f32);
//                      a dense stack has neither.
// Each block reads its tile's expert id from device memory and takes the
// planes of that expert, so nothing goes back to the host and a decode step
// reads only the routed experts' planes.
//
// What bounds it on an H100. Decode (tile_m 8, R = B * top_k rows, most
// tiles hold one or two): bytes. A token reads top_k of E experts'
// planes (0.56 B a weight for Q4_K, 0.5 for Q2_K, ~0.3 for IQ1_S, 2 for a
// bf16 stack); gmm_gemv runs qmm_gemv.cuh's body (K1's) on each live tile
// at the tile's own row count (1, 2, 4 or 8 rows, chosen per block from
// tile_rows), dense stacks included; a dead tile's CTAs write its zeros
// and exit, and a live tile's pad rows are stored as zeros, so the output
// needs no memset. Tiles of one expert read the same planes; K splits
// across a cluster of CTAs as in K1, so tiles of one expert run side by
// side and the second read of a plane
// mostly hits L2. Prefill (tile_m 64): operations (2 * R * K * N flops at
// 989 TFLOP/s bf16). gmm_gemm is K1's Hopper main loop (qmm_tile.cuh) at
// K1's 128 x 256 tiles of two warpgroups, each 64-row half one routing
// tile: a TMA ring with an mbarrier a stage,
// each weight dequantized once per tile into a 128B-swizzled bf16 B tile
// as the TPU kernel rounds it, bf16(s*q) or bf16(s*lut[q]) (a dense
// stack's tile lands swizzled from the TMA as it is), wgmma m64n128k16,
// and the min folded exactly on the tensor cores (x-sums from a product
// with the group-membership tile, split bf16 hi + lo against -min, as
// _gmm_kernel folds xsum . min in f32). A block takes two consecutive
// routing tiles of one expert's run (qmm_tile.cuh's routed_rows, from
// tile_expert and tile_rows on the device), so each dequantized tile
// serves 128 rows, and 256 columns, so each staged x tile serves 256: at
// 64 x 128 a dense stack, which skips the dequantization and the fold,
// ran 1.4-1.8x faster than the quantized kinds, and at 128 x 128 one
// block an SM lost to the 64-row blocks on the gate/up shape, with half
// the products behind each step's barriers and proxy fence. The expert is
// the outer coordinate of the plane and scale
// tensor maps; row blocks run fastest, so the blocks of one expert run side
// by side and share their plane reads in L2, as the reference orders its
// grid (n, row tiles). Dead tiles are written as zeros with no load, and a
// live tile's rows past its live count as zeros.
#include "qmm_gemv.cuh"
#include "qmm_tile.cuh"

namespace {

constexpr int GEMV_TILE = 8;    // tile_m of the decode variant
constexpr int GEMM_TILE = 64;   // tile_m of the prefill variant

// ---------------------------------------------------------------------------
// decode: tile_m 8, qmm_gemv.cuh's body per live tile at the tile's own row
// count; grid (splits, column blocks, tiles), clusters of `splits` CTAs

// MT_MAX: the most rows a live tile holds (2: the few-row variant, whose
// bodies are the FMA pipe's only; 8: every body)
template <int KIND, bool HAS_MIN, int MT_MAX>
__global__ void __launch_bounds__(GEMV_THREADS, 1)
gmm_gemv_kernel(const __grid_constant__ GemvMaps maps, const GemvArgs a,
                const GemvPlan p) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int PACK = kind_pack(KIND);
  // the CTAs of a cluster share a tile, a column block and the plan, so
  // they all leave here or all reach the cluster barriers together
  const int split = blockIdx.x, bx = blockIdx.y, t = blockIdx.z;
  constexpr int NO = gemv_no(MT_MAX);
  const int K = a.K, npk = a.npk;
  const int rows = a.tile_rows[t];
  if (rows > MT_MAX) __trap();  // the launcher was told fewer rows a tile
  float* out = a.out + (size_t)t * GEMV_TILE * PACK * npk;
  if (rows <= 0) {  // a dead tile: this CTA's slice of its zeros, no load
    const int cols = GEMV_CONSUMERS / p.row_groups * gemv_lane_cols(KIND, NO);
    const int j0 = bx * cols, ncols = min(cols, npk - j0);
    const int total = GEMV_TILE * PACK * ncols;
    for (int i = total * split / p.splits + threadIdx.x;
         i < total * (split + 1) / p.splits; i += GEMV_THREADS) {
      const int m = i / (PACK * ncols), h = (i / ncols) % PACK;
      out[((size_t)m * PACK + h) * npk + j0 + i % ncols] = 0.f;
    }
    return;
  }
  const int e = min(max(a.tile_expert[t], 0), a.n_expert - 1);
  const __nv_bfloat16* xs = a.x + (size_t)t * GEMV_TILE * K;
  auto body = [&](auto mt) {  // the tile's own row count, MT <= MT_MAX
    gemv_block<KIND, decltype(mt)::value, HAS_MIN, NO>(
        maps, xs, rows, K, e, npk, a.lut, a.group, out, GEMV_TILE, p, smem,
        split, bx);
  };
  if (rows == 1)
    body(std::integral_constant<int, 1>{});
  else if (MT_MAX <= 2 || rows <= 2)
    body(std::integral_constant<int, 2>{});
  else if constexpr (MT_MAX > 2) {
    if (rows <= 4)
      body(std::integral_constant<int, 4>{});
    else
      body(std::integral_constant<int, 8>{});
  }
}

// ---------------------------------------------------------------------------
// prefill: tile_m 64, qmm_tile.cuh's main loop at 128 x 256 tiles

template <int KIND, bool HAS_MIN>
using GemmPlan = gemm::Plan<KIND, HAS_MIN, 2, 1, 256>;
static_assert(GemmPlan<1, true>::BM == 2 * GEMM_TILE, "two routing tiles");

template <int KIND, bool HAS_MIN>
__global__ void __launch_bounds__(256, 1)
gmm_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_s,
                const __grid_constant__ CUtensorMap tm_m, int M, int K,
                int npk, const float* lut, int group, int rb,
                gemm::Routing rt, float* out) {
  gemm::tile<KIND, HAS_MIN, 2, 1, 256>(&tm_x, &tm_q, &tm_s, &tm_m, M, K, npk,
                                       lut, group, rb, rt, out);
}

using gemm::Args;

template <int KIND, bool HAS_MIN>
int gemv_run(const GemvArgs& g, const GemvPlan& p, int T, int max_rows,
             cudaStream_t st) {
  if (max_rows <= 2)
    return gemv_launch(gmm_gemv_kernel<KIND, HAS_MIN, 2>, KIND, gemv_no(2), g,
                       p, g.n_expert, T,
                       gemv_smem(KIND, HAS_MIN, 2, gemv_no(2), p, g.group)
                           .total,
                       st);
  return gemv_launch(gmm_gemv_kernel<KIND, HAS_MIN, 8>, KIND, gemv_no(8), g, p,
                     g.n_expert, T,
                     gemv_smem(KIND, HAS_MIN, 8, gemv_no(8), p, g.group).total,
                     st);
}

template <int KIND, bool HAS_MIN>
struct GemmLaunch {
  static int run(const Args& a) {
    return gemm::launch<GemmPlan<KIND, HAS_MIN>>(
        gmm_gemm_kernel<KIND, HAS_MIN>, a);
  }
};

// The LUT kinds and dense stacks carry no min (no GGML type gives them
// one), so they are instantiated without it.
template <template <int, bool> class L>
int dispatch_kinds(int kind, const Args& a) {
  const bool mn = a.minp != nullptr;
  int rc = 0;
  switch (kind) {
    case 0: rc = mn ? L<0, true>::run(a) : L<0, false>::run(a); break;
    case 1: rc = mn ? L<1, true>::run(a) : L<1, false>::run(a); break;
    case 2: rc = mn ? L<2, true>::run(a) : L<2, false>::run(a); break;
    case 3: rc = L<3, false>::run(a); break;
    case 4: rc = L<4, false>::run(a); break;
    case KIND_DENSE: rc = L<KIND_DENSE, false>::run(a); break;
  }
  return rc ? rc : launch_status();
}

// operands both entry points take; false if the kernels do not take them
bool valid(int T, int K, int kind, const void* scale, const void* minp,
           const void* lut, int group, int n_expert) {
  if (T < 1 || n_expert < 1 || kind < 0 || kind > KIND_DENSE || group <= 0 ||
      K % group || K % 32)
    return false;
  if (kind == KIND_DENSE)
    return scale == nullptr && minp == nullptr && lut == nullptr;
  return scale != nullptr && (lut != nullptr) == kind_lut(kind) &&
         !(kind_lut(kind) && minp != nullptr);
}

Args make_args(const void* xs, int rows, int K, const void* qs, int npk,
               const void* scale, const void* minp, const void* lut, int group,
               const void* tile_expert, const void* tile_rows, int n_expert,
               void* out, void* stream) {
  Args a = gemm::make_args(xs, rows, K, qs, npk, scale, minp, lut, group, out,
                           stream);
  a.n_expert = n_expert;
  a.tile_expert = (const int*)tile_expert;
  a.tile_rows = (const int*)tile_rows;
  return a;
}

}  // namespace

// xs [T*8, K] bf16; qs [E, K, npk] (kinds 0-4; KIND_DENSE: bf16 [E, K,
// npk]); scale/min [E, pack, K/group, npk] bf16 (min may be null; both null
// for a dense stack, whose `group` only cuts K into split granules);
// lut [16] or [4] f32 for kinds 3/4, else null; tile_expert / tile_rows
// [T] int32 on the device; out [T*8, pack, npk] float32, every row written
// (zeros for dead tiles and pad rows). K a multiple of 32 and of group;
// npk a multiple of 128; the launch plan of ops/qmatmul.gemv_plan, which
// gemv_plan_ok must accept; max_rows the most rows a live tile holds (up
// to 2: the few-row kernel; a tile past it traps). One launch: no memset,
// no atomics.
PORT_API int gmm_gemv(const void* xs, int T, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      const void* lut, int group, const void* tile_expert,
                      const void* tile_rows, int n_expert, void* out,
                      void* stream, int col_blocks, int splits,
                      int rows_per_split, int row_groups, int stage_rows,
                      int stages, int x_rows, int mma, int max_rows) {
  const GemvPlan p{col_blocks, splits, rows_per_split, row_groups,
                   stage_rows, stages, x_rows, mma};
  if (!valid(T, K, kind, scale, minp, lut, group, n_expert) || npk % 128 ||
      max_rows < 1 || max_rows > GEMV_TILE ||
      !gemv_plan_ok(kind, gemv_no(max_rows <= 2 ? 2 : 8), K, group, npk, p))
    return (int)cudaErrorInvalidValue;
  const GemvArgs g{(const __nv_bfloat16*)xs, T * GEMV_TILE, K, qs, npk,
                   (const __nv_bfloat16*)scale, (const __nv_bfloat16*)minp,
                   (const float*)lut, group, (float*)out,
                   (const int*)tile_expert, (const int*)tile_rows, n_expert};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool mn = minp != nullptr;
  switch (kind) {
    case 0: return mn ? gemv_run<0, true>(g, p, T, max_rows, st)
                      : gemv_run<0, false>(g, p, T, max_rows, st);
    case 1: return mn ? gemv_run<1, true>(g, p, T, max_rows, st)
                      : gemv_run<1, false>(g, p, T, max_rows, st);
    case 2: return mn ? gemv_run<2, true>(g, p, T, max_rows, st)
                      : gemv_run<2, false>(g, p, T, max_rows, st);
    case 3: return gemv_run<3, false>(g, p, T, max_rows, st);
    case 4: return gemv_run<4, false>(g, p, T, max_rows, st);
    default: return gemv_run<KIND_DENSE, false>(g, p, T, max_rows, st);
  }
}

// Same operands with 64-row tiles: xs [T*64, K], out [T*64, pack, npk].
// K a multiple of 32 and of group; npk a multiple of 128 / pack; a group
// that is a multiple of 8 (every GGML type's) and, with a min, one of 8,
// 16, 32, 64 (one 64-deep step's groups fill at most the fold's 16 K
// slots: every GGML type with a min has 16 or 32).
PORT_API int gmm_gemm(const void* xs, int T, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      const void* lut, int group, const void* tile_expert,
                      const void* tile_rows, int n_expert, void* out,
                      void* stream) {
  if (!valid(T, K, kind, scale, minp, lut, group, n_expert) ||
      npk % (128 / kind_pack(kind)) ||
      (kind != KIND_DENSE && group % 8) || (minp && gemm::BK % group))
    return (int)cudaErrorInvalidValue;
  return dispatch_kinds<GemmLaunch>(
      kind, make_args(xs, T * GEMM_TILE, K, qs, npk, scale, minp, lut, group,
                      tile_expert, tile_rows, n_expert, out, stream));
}
