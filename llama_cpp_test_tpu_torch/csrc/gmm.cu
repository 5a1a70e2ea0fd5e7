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
// bf16 stack); gmm_gemv runs K1's GEMV body (qmm_gemv.cuh) on each live
// tile at the tile's own row count (1, 2, 4 or 8 rows of FMAs, chosen per
// block from tile_rows), and a dead tile's blocks exit at once. A dense
// stack takes the same shape of GEMV over 4 bf16 columns a lane. Tiles of
// one expert read the same planes; K is split across blocks as in K1, so
// tiles of one expert run side by side and the second read of a plane
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
constexpr int DENSE_CPL = 4;    // bf16 columns a lane of the dense GEMV takes

template <int KIND>
__device__ __forceinline__ size_t plane_elems(int K, int group, int npk) {
  return (size_t)kind_pack(KIND) * (K / group) * npk;
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
  constexpr int PACK = kind_pack(KIND);
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
struct GemvLaunch {
  static int run(const Args& a) {
    const int cols = KIND == KIND_DENSE ? 32 * DENSE_CPL : gemv_block_cols<KIND>();
    const int nbx = a.npk / cols;
    int rpw = 0;
    // a dense stack splits K at 32-row granules (it has no groups)
    const int ky = gemv_k_split(a.K, KIND == KIND_DENSE ? 32 : a.group, nbx,
                                num_sms(), &rpw);
    dim3 grid(a.M / GEMV_TILE, nbx, ky);
    gmm_gemv_kernel<KIND, HAS_MIN><<<grid, 32 * GEMV_WARPS, 0, a.st>>>(
        a.x, a.K, a.qs, a.npk, a.scale, a.minp, a.lut, a.group,
        a.tile_expert, a.tile_rows, a.n_expert, a.out, rpw);
    return 0;
  }
};

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
// for a dense stack); lut [16] or [4] f32 for kinds 3/4, else null;
// tile_expert / tile_rows [T] int32 on the device; out [T*8, pack, npk]
// float32. K a multiple of 32 and of group; npk a multiple of 128.
PORT_API int gmm_gemv(const void* xs, int T, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      const void* lut, int group, const void* tile_expert,
                      const void* tile_rows, int n_expert, void* out,
                      void* stream) {
  if (!valid(T, K, kind, scale, minp, lut, group, n_expert) || npk % 128)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(xs, T * GEMV_TILE, K, qs, npk, scale, minp, lut,
                           group, tile_expert, tile_rows, n_expert, out,
                           stream);
  // pad rows and dead tiles stay zero; K-split blocks atomicAdd into it
  cudaMemsetAsync(out, 0,
                  (size_t)T * GEMV_TILE * kind_pack(kind) * npk * sizeof(float),
                  a.st);
  return dispatch_kinds<GemvLaunch>(kind, a);
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
