// K4: grouped expert matmul over stacked expert planes (MoE FFN).
//
// Replaces the TPU kernel _gmm_kernel (llama_cpp_test_tpu/ops/gmm.py:118,
// launched by _gmm_call :200). ops/gmm.route_tokens sorts the routed
// (token, expert) rows into a scratch batch xs [Rp, K] whose row tile t
// (tile_m rows) belongs to one expert, tile_expert[t]; tile_rows[t] counts
// the tile's live rows (0 for the dead tail tiles). Computes
//   out[Rp, pack, npk] f32 = xs . dequant(W[tile_expert[t]]) per tile,
// with zeros in the rows that carry no assignment, over the stacked planes
//   qs    [E, K, npk]          int8 (kind 0) or u4 nibbles (kind 1)
//   scale [E, pack, K/group, npk] bf16, min (or null) the same: w = s*q - m.
// Each block reads its tile's expert id from device memory and offsets the
// plane pointers by it, so nothing goes back to the host and a decode step
// reads only the routed experts' planes.
//
// What bounds it on an H100. Decode (tile_m 8, R = B * top_k rows, most
// tiles hold one or two): bytes. A token reads top_k of E experts'
// planes, about 0.56 B per weight for Q4_K; gmm_gemv runs K1's GEMV body
// (qmm_gemv.cuh) on each live tile at the tile's own row count (1, 2, 4
// or 8 rows of FMAs, chosen per block from tile_rows), and a dead tile's
// blocks exit at once. Tiles of one expert read the same planes; K is
// split across blocks as in K1, so tiles of one expert run side by side
// and the second read of a plane mostly hits L2. Prefill (tile_m 64):
// operations. gmm_gemm dequantizes a 32 x 128 weight tile per k-step to
// bf16(s*q - m) in shared memory (no per-group min fold: that fold made
// K1's u4 GEMM 8x slower than its int8 one) and multiplies on the tensor
// cores with wmma (mma.sync 16x16x16 bf16, f32 accumulate); the next
// k-step's x, plane, scale and min loads are issued into registers before
// the current product, so the global latency overlaps the MMAs. No
// cp.async/TMA ring, no wgmma: later work.
#include <mma.h>

#include "qmm_gemv.cuh"

using namespace nvcuda;

namespace {

constexpr int GEMV_TILE = 8;    // tile_m of the decode variant
constexpr int GM_BM = 64;       // tile_m of the prefill variant
constexpr int GM_BN = 128;      // logical output columns per block
constexpr int GM_BK = 32;
constexpr int GM_THREADS = 256;

template <int KIND>
__device__ __forceinline__ size_t plane_elems(int K, int group, int npk) {
  return (size_t)(KIND == 1 ? 2 : 1) * (K / group) * npk;
}

// ---------------------------------------------------------------------------
// decode: tile_m 8, K1's GEMV body per live tile

template <int KIND, bool HAS_MIN>
__global__ void __launch_bounds__(32 * GEMV_WARPS)
gmm_gemv_kernel(const __nv_bfloat16* __restrict__ xs, int K,
                const uint8_t* __restrict__ qs, int npk,
                const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ minp, int group,
                const int* __restrict__ tile_expert,
                const int* __restrict__ tile_rows, int n_expert,
                float* __restrict__ out, int rows_per_warp) {
  constexpr int PACK = KIND == 1 ? 2 : 1;
  // tiles vary fastest: the blocks of consecutive tiles of one expert on
  // one column block and K slice run side by side and share its planes
  const int t = blockIdx.x, bx = blockIdx.y, by = blockIdx.z;
  const int rows = min(tile_rows[t], GEMV_TILE);
  if (rows <= 0) return;  // dead tile: the launcher zeroed its rows
  const int e = min(max(tile_expert[t], 0), n_expert - 1);
  const size_t pe = plane_elems<KIND>(K, group, npk);
  qs += (size_t)e * K * npk;
  scale += e * pe;
  if constexpr (HAS_MIN) minp += e * pe;
  xs += (size_t)t * GEMV_TILE * K;
  out += (size_t)t * GEMV_TILE * PACK * npk;
  __shared__ float red[gemv_red_floats<KIND, GEMV_TILE>()];
  if (rows == 1)
    qmm_gemv_tile<KIND, 1, HAS_MIN>(xs, 1, K, qs, npk, scale, minp,
                                    nullptr, group, out, rows_per_warp, red,
                                    bx, by, gridDim.z);
  else if (rows <= 2)
    qmm_gemv_tile<KIND, 2, HAS_MIN>(xs, rows, K, qs, npk, scale, minp,
                                    nullptr, group, out, rows_per_warp, red,
                                    bx, by, gridDim.z);
  else if (rows <= 4)
    qmm_gemv_tile<KIND, 4, HAS_MIN>(xs, rows, K, qs, npk, scale, minp,
                                    nullptr, group, out, rows_per_warp, red,
                                    bx, by, gridDim.z);
  else
    qmm_gemv_tile<KIND, 8, HAS_MIN>(xs, rows, K, qs, npk, scale, minp,
                                    nullptr, group, out, rows_per_warp, red,
                                    bx, by, gridDim.z);
}

// ---------------------------------------------------------------------------
// prefill: tile_m 64, wmma over a bf16(s*q - m) shared-memory tile

template <int KIND, bool HAS_MIN>
__global__ void __launch_bounds__(GM_THREADS)
gmm_gemm_kernel(const __nv_bfloat16* __restrict__ xs, int K,
                const uint8_t* __restrict__ qs, int npk,
                const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ minp, int group,
                const int* __restrict__ tile_expert,
                const int* __restrict__ tile_rows, int n_expert,
                float* __restrict__ out) {
  constexpr int PACK = KIND == 1 ? 2 : 1;
  constexpr int BNP = GM_BN / PACK;                // packed columns per block
  constexpr int BPT = BNP * GM_BK / GM_THREADS;    // plane bytes per thread
  constexpr int SV = BPT / 8;                      // uint4 of scales per h
  constexpr int LDA = GM_BK + 8;                   // bf16 elements
  constexpr int LDB = GM_BN + 8;
  static_assert(BPT == 8 || BPT == 16, "plane bytes per thread");
  __shared__ __align__(128) __nv_bfloat16 As[GM_BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[GM_BK * LDB];

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
  const int e = min(max(tile_expert[t], 0), n_expert - 1);
  const size_t pe = plane_elems<KIND>(K, group, npk);
  qs += (size_t)e * K * npk;
  scale += e * pe;
  if constexpr (HAS_MIN) minp += e * pe;
  xs += (size_t)t * GM_BM * K;
  const int G = K / group;

  // fixed per-thread roles: x chunk (row xr, 8 columns at xc) and plane
  // chunk (k-row wr, BPT packed columns at wc)
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr = tid >> 3, wc = (tid & 7) * BPT;

  uint4 x_reg;
  uint32_t q_reg[BPT / 4];
  uint4 s_reg[PACK * SV], m_reg[HAS_MIN ? PACK * SV : 1];

  auto load = [&](int k0) {
    x_reg = make_uint4(0, 0, 0, 0);
    if (xr < rows)
      x_reg = *reinterpret_cast<const uint4*>(xs + (size_t)xr * K + k0 + xc);
    const int k = k0 + wr, g = k / group;
    const uint8_t* qp = qs + (size_t)k * npk + jb + wc;
    if constexpr (BPT == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(qp));
      q_reg[0] = v.x; q_reg[1] = v.y;
    } else {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(qp));
      q_reg[0] = v.x; q_reg[1] = v.y; q_reg[2] = v.z; q_reg[3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < PACK; ++h) {
      const size_t off = ((size_t)h * G + g) * npk + jb + wc;
#pragma unroll
      for (int v = 0; v < SV; ++v) {
        s_reg[h * SV + v] = __ldg(reinterpret_cast<const uint4*>(scale + off) + v);
        if constexpr (HAS_MIN)
          m_reg[h * SV + v] = __ldg(reinterpret_cast<const uint4*>(minp + off) + v);
      }
    }
  };

  auto store = [&]() {
    *reinterpret_cast<uint4*>(As + xr * LDA + xc) = x_reg;
#pragma unroll
    for (int h = 0; h < PACK; ++h) {
      const __nv_bfloat16* sb =
          reinterpret_cast<const __nv_bfloat16*>(&s_reg[h * SV]);
      const __nv_bfloat16* mb =
          reinterpret_cast<const __nv_bfloat16*>(&m_reg[HAS_MIN ? h * SV : 0]);
      __align__(16) __nv_bfloat16 wv[BPT];
#pragma unroll
      for (int c = 0; c < BPT; ++c) {
        const uint32_t byte = (q_reg[c >> 2] >> (8 * (c & 3))) & 0xffu;
        float q;
        if constexpr (KIND == 0)
          q = (float)(int8_t)byte;
        else
          q = (float)(h == 0 ? (byte & 0xfu) : (byte >> 4));
        // the plain version's rounding: bf16(s*q - m), two f32 roundings
        float w = __fmul_rn(q, bf2f(sb[c]));
        if constexpr (HAS_MIN) w = __fsub_rn(w, bf2f(mb[c]));
        wv[c] = __float2bfloat16_rn(w);
      }
      uint4* dst = reinterpret_cast<uint4*>(Bs + wr * LDB + h * BNP + wc);
#pragma unroll
      for (int v = 0; v < BPT / 8; ++v)
        dst[v] = reinterpret_cast<const uint4*>(wv)[v];
    }
  };

  const int wm = warp & 3, wn = warp >> 2;   // 16 rows x 64 columns per warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);

  load(0);
  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    store();
    __syncthreads();
    if (k0 + GM_BK < K) load(k0 + GM_BK);
#pragma unroll
    for (int kk = 0; kk < GM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + (16 * wm) * LDA + kk, LDA);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * LDB + wn * 64 + f * 16, LDB);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();
  }

  // rows past `rows` had zero x, so every stored row is finite
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int n0 = wn * 64 + f * 16;
    float* dst = out_t + ((size_t)(16 * wm) * PACK + n0 / BNP) * npk + jb + n0 % BNP;
    wmma::store_matrix_sync(dst, acc[f], PACK * npk, wmma::mem_row_major);
  }
}

template <template <int, bool> class L, typename... A>
void dispatch(int kind, bool has_min, A... args) {
  if (kind == 0) {
    if (has_min) L<0, true>::run(args...); else L<0, false>::run(args...);
  } else {
    if (has_min) L<1, true>::run(args...); else L<1, false>::run(args...);
  }
}

struct Args {
  const __nv_bfloat16* xs; int T, K; const uint8_t* qs; int npk;
  const __nv_bfloat16 *scale, *minp; int group;
  const int *tile_expert, *tile_rows; int n_expert; float* out;
  cudaStream_t st;
};

template <int KIND, bool HAS_MIN>
struct GemvLaunch {
  static void run(const Args& a) {
    const int nbx = a.npk / 128;
    int rpw = 0;
    const int ky = gemv_k_split(a.K, a.group, nbx, num_sms(), &rpw);
    dim3 grid(a.T, nbx, ky);
    gmm_gemv_kernel<KIND, HAS_MIN><<<grid, 32 * GEMV_WARPS, 0, a.st>>>(
        a.xs, a.K, a.qs, a.npk, a.scale, a.minp, a.group, a.tile_expert,
        a.tile_rows, a.n_expert, a.out, rpw);
  }
};

template <int KIND, bool HAS_MIN>
struct GemmLaunch {
  static void run(const Args& a) {
    constexpr int BNP = GM_BN / (KIND == 1 ? 2 : 1);
    dim3 grid(a.npk / BNP, a.T);
    gmm_gemm_kernel<KIND, HAS_MIN><<<grid, GM_THREADS, 0, a.st>>>(
        a.xs, a.K, a.qs, a.npk, a.scale, a.minp, a.group, a.tile_expert,
        a.tile_rows, a.n_expert, a.out);
  }
};

Args make_args(const void* xs, int T, int K, const void* qs, int npk,
               const void* scale, const void* minp, int group,
               const void* tile_expert, const void* tile_rows, int n_expert,
               void* out, void* stream) {
  return Args{(const __nv_bfloat16*)xs, T, K, (const uint8_t*)qs, npk,
              (const __nv_bfloat16*)scale, (const __nv_bfloat16*)minp, group,
              (const int*)tile_expert, (const int*)tile_rows, n_expert,
              (float*)out, (cudaStream_t)stream};
}

}  // namespace

// xs [T*8, K] bf16; qs [E, K, npk]; scale/min [E, pack, K/group, npk] bf16
// (min may be null); tile_expert/tile_rows [T] int32 on the device;
// out [T*8, pack, npk] float32. kind 0 = int8, 1 = u4.
PORT_API int gmm_gemv(const void* xs, int T, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      int group, const void* tile_expert,
                      const void* tile_rows, int n_expert, void* out,
                      void* stream) {
  if (T < 1 || n_expert < 1 || (kind != 0 && kind != 1) || group <= 0 ||
      K % group || npk % 128)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(xs, T, K, qs, npk, scale, minp, group, tile_expert,
                           tile_rows, n_expert, out, stream);
  const int pack = kind == 1 ? 2 : 1;
  // pad rows and dead tiles stay zero; K-split blocks atomicAdd into it
  cudaMemsetAsync(out, 0, (size_t)T * GEMV_TILE * pack * npk * sizeof(float),
                  a.st);
  dispatch<GemvLaunch>(kind, minp != nullptr, a);
  return launch_status();
}

// Same operands with 64-row tiles: xs [T*64, K], out [T*64, pack, npk].
// K a multiple of 32, group dividing 32, npk a multiple of 128 / pack.
PORT_API int gmm_gemm(const void* xs, int T, int K, const void* qs, int npk,
                      int kind, const void* scale, const void* minp,
                      int group, const void* tile_expert,
                      const void* tile_rows, int n_expert, void* out,
                      void* stream) {
  if (T < 1 || n_expert < 1 || (kind != 0 && kind != 1) || group <= 0 ||
      GM_BK % group || K % GM_BK || npk % (GM_BN / (kind == 1 ? 2 : 1)))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(xs, T, K, qs, npk, scale, minp, group, tile_expert,
                           tile_rows, n_expert, out, stream);
  dispatch<GemmLaunch>(kind, minp != nullptr, a);
  return launch_status();
}
