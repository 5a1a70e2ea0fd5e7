// The prefill main loop shared by K1's GEMM (qmm.cu), K5 (qmm_cache.cu) and
// K4's GEMM (gmm.cu): y[M, pack, NPK] = x[M, K] . dequant(W) over packed
// layout-'t' planes (qmm_gemv.cuh's kinds), f32 out, on Hopper:
//   - products on the tensor cores with wgmma (bf16 in, f32 out). A block
//     of WG warpgroups covers BM = 64 * WG * RH rows and BN logical
//     columns: warpgroup w takes rows [64 (w RH + r), +64) for r < RH, each
//     64-row slice one m64nBNk16 product against the whole B tile. A is
//     the x tile (K-major), B the dequantized tile (N contiguous: trans-b),
//     both 128B-swizzled in shared memory; a tile of PACK sub-planes of
//     BN / PACK packed columns is written back to columns h * NPK + j;
//   - a ring of 3-4 stages filled by TMA (one thread, an mbarrier per
//     stage), each holding one 64-deep K step's x tile, plane bytes, scale
//     rows and min rows, so loads run 2-3 steps ahead; each step's B tile
//     is dequantized while the wgmma of the step before runs (two B
//     tiles), then fenced to the async proxy (fence.proxy.async). Every
//     dequantized tile serves all BM rows of the block;
//   - dequantization per 8-column unit: one 16-byte scale load per (group,
//     8 columns) and 8 plane bytes a unit, each weight rounded once as
//     bf16(scale*q) (u4/u2: one bf16x2 fma over a 128 + q exponent trick)
//     or bf16(scale*lut[q]) (LUT in shared memory), as the TPU kernels;
//   - the min on the tensor cores: each step's per-group x-sums come from a
//     product of the staged x tile with a 0/1 group-membership tile
//     (m64n8k16, f32), as the TPU kernels' dot; each splits into bf16 hi +
//     lo, two extra K slots of A against -min (exact in bf16) in two extra
//     rows of B, so one more k16 product a step folds (hi + lo) . min into
//     the accumulators (+25% of the products, about 2^-16 relative error
//     on the min term).
// Rows past M, K past its end and columns past NPK arrive as zeros from the
// TMA. Groups are a multiple of 8; with a min 8, 16, 32 or 64.
// Planes are expert-stacked: qs [E, K, NPK], scale/min [E, pack, K/group,
// NPK] (E = 1 for K1 and K5), read through 3-D and 4-D tensor maps whose
// outer coordinate is the block's expert. K4 passes its routing (row tiles
// of 64, tile t of expert tile_expert[t] with tile_rows[t] live rows, read
// on the device): a block takes BM / 64 consecutive tiles of one expert
// (routed_rows), so they share every dequantized B tile, and writes zeros
// past their live rows (a block of dead tiles writes zeros and loads
// nothing). K4's dense bf16 stacks (KIND_DENSE) skip dequantization: TMA
// lands each 64-column box of the weight 128B-swizzled in its ring stage,
// where wgmma reads it as B.
#pragma once

#include "qmm_gemv.cuh"
#include "sm90.cuh"

namespace gemm {

constexpr int BK = 64;       // K rows per pipeline step
constexpr int FOLD = 16;     // K slots of the min fold per step (one k16)
constexpr int SR = 8;        // scale (and min) rows staged per step
constexpr int SMEM_MAX = 232448;  // shared memory one block may hold

// Shared-memory plan of one block of WG warpgroups, RH 64-row slices each
// (BM = 64 * WG * RH rows), BN_ logical columns: a ring of STAGES steps (x
// tile, plane bytes, scale rows, min rows), two dequantized B tiles and,
// with a min, two A tiles of the fold's x-sum columns. Every swizzled tile
// starts 1024-byte aligned.
template <int KIND, bool HAS_MIN, int WG, int RH, int BN_>
struct Plan {
  static constexpr bool DENSE = KIND == KIND_DENSE;  // B tile as loaded
  static constexpr int PACK = kind_pack(KIND);
  static constexpr int BM = 64 * WG * RH;       // rows per block
  static constexpr int BN = BN_;                // logical columns per block
  static constexpr int BNP = BN / PACK;         // packed columns per block
  static constexpr int T = 128 * WG;            // threads
  static constexpr int KB = BK + (HAS_MIN ? FOLD : 0);  // B tile rows
  static constexpr int X = BM * BK * 2;         // x tile, 128B-swizzled
  // plane bytes, row-major; dense: the bf16 B tile, BN / 64 swizzled atoms
  static constexpr int Q = BK * BNP * (DENSE ? 2 : 1);
  static constexpr int S = DENSE ? 0 : PACK * SR * BNP * 2;  // [pack][SR][BNP]
  static constexpr int STAGE = X + Q + S * (HAS_MIN ? 2 : 1);
  // the dequantized B tiles, BN / 64 swizzled atoms (dense: in the stage)
  static constexpr int B = DENSE ? 0 : KB * BN * 2;
  static constexpr int F = HAS_MIN ? BM * FOLD * 2 : 0;  // interleaved
  static constexpr int MEMB = HAS_MIN ? 1024 : 0;  // group membership tile
  static constexpr int FIXED = 2 * B + 2 * F + MEMB + 128 + 1024;
  // 4 stages where they fit, else 3
  static constexpr int STAGES = 4 * STAGE + FIXED <= SMEM_MAX ? 4 : 3;
  static constexpr int LUT = STAGES * STAGE + 2 * B + 2 * F + MEMB;
  static constexpr int BYTES = LUT + 128 + 1024;  // + alignment slack
  static_assert(BN == 128 || BN == 256, "wgmma width");
  static_assert(!(DENSE && HAS_MIN), "a dense stack has no min");
  static_assert(RH * BN / 2 <= 128, "accumulators a thread");
  static_assert(X % 1024 == 0 && Q % 1024 == 0 && S % 1024 == 0 &&
                B % 1024 == 0 && BYTES <= SMEM_MAX, "shared-memory plan");
};

// Four floats as four bf16 (round to nearest even), in order.
static __device__ __forceinline__ uint2 pack_bf16x4(const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                    *reinterpret_cast<const uint32_t*>(&b));
}

// Four sub-values h of the plane word w (bytes e = 0..3, one column each)
// times their scales, rounded once to bf16 as the TPU kernels round them:
// bf16(s * q) or bf16(s * lut[q]). s2 holds the four scales as two bf16
// pairs, ns2 their products with -128, s their f32 values.
template <int KIND>
static __device__ __forceinline__ uint2 dequant4(uint32_t w, int h,
                                                 const __nv_bfloat162* s2,
                                                 const __nv_bfloat162* ns2,
                                                 const float* s,
                                                 const float* lut) {
  uint2 r;
  if constexpr (KIND == 0) {
    // int8: q + 128 as the low byte of 2^23's mantissa, exact in f32
    const uint32_t u = w ^ 0x80808080u;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) -
              8388736.f) * s[e];
    r = pack_bf16x4(v);
  } else {
    constexpr int BITS = 8 / kind_pack(KIND);
    constexpr uint32_t MASK = BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u;
    const uint32_t u = (w >> (BITS * h)) & MASK;
    if constexpr (kind_lut(KIND)) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = lut[(u >> (8 * e)) & 0xFFu] * s[e];
      r = pack_bf16x4(v);
    } else {
      // bf16 128 + q (q < 16) is exact; one fma per pair gives
      // bf16((128 + q) * s - 128 * s) = bf16(q * s), rounded once
      const uint32_t m01 = __byte_perm(u, 0x43u, 0x4140);
      const uint32_t m23 = __byte_perm(u, 0x43u, 0x4342);
      const __nv_bfloat162 a =
          __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&m01), s2[0],
                  ns2[0]);
      const __nv_bfloat162 b =
          __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&m23), s2[1],
                  ns2[1]);
      r.x = *reinterpret_cast<const uint32_t*>(&a);
      r.y = *reinterpret_cast<const uint32_t*>(&b);
    }
  }
  return r;
}

// Byte offset of K slot col (0..15) of row r in the fold's A tile: 8-row x
// 16-byte core matrices, the two K halves 128 bytes apart, 8-row groups
// 256 bytes apart (wgmma's unswizzled K-major layout).
static __device__ __forceinline__ uint32_t fold_a(int r, int col) {
  return (uint32_t)(r >> 3) * 256u + (uint32_t)(col >> 3) * 128u +
         (uint32_t)(r & 7) * 16u + (uint32_t)(col & 7) * 2u;
}

// K4's routing (ops/gmm.route_tokens): row tile t (64 rows) of the
// routed batch belongs to expert tile_expert[t] and holds tile_rows[t]
// live rows. Live tiles come first, each expert's in one run, every tile
// but a run's last full; dead tiles (0 rows) fill the tail. K1 and K5 pass
// none (tile_rows null).
struct Routing {
  const int* tile_expert;
  const int* tile_rows;
  int n_expert;
};

// Blocks of G routing tiles over T tiles and E experts: each expert's run
// of n live tiles takes ceil(n / G) blocks, then the dead tail G tiles a
// block; at most (T + (G - 1) (min(E, T) + 1)) / G of them.
static inline int routed_blocks(int T, int E, int G) {
  return (T + (G - 1) * (min(E, T) + 1) + G - 1) / G;
}

// The tiles block p takes, G consecutive routing tiles at a time within
// one expert's run (so they share its planes), found by warp 0 walking
// the routing 32 tiles a step: a group starts at each live tile whose
// distance from its run's first tile is a multiple of G; block p takes the
// p-th group, and blocks past the last group take G dead tiles each.
// Returns (first tile, tiles, expert, live rows) to every thread.
template <int G>
static __device__ __forceinline__ int4 routed_rows(const Routing& rt, int T,
                                                   int p) {
  __shared__ int4 s_rows;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int seg = 0, groups = 0, nlive = 0, prev_e = -1;
    int4 r = make_int4(-1, 0, 0, 0);
    for (int t0 = 0; t0 < T && r.x < 0; t0 += 32) {
      const int t = t0 + lane;
      const int rows = t < T ? rt.tile_rows[t] : 0;
      const int e = t < T ? rt.tile_expert[t] : -1;
      const int e_up = __shfl_up_sync(0xffffffffu, e, 1);
      const bool live = rows > 0;
      const bool run0 = live && e != (lane == 0 ? prev_e : e_up);
      const unsigned runs = __ballot_sync(0xffffffffu, run0);
      const unsigned upto = runs & (0xffffffffu >> (31 - lane));
      const int first = upto ? t0 + 31 - __clz(upto) : seg;
      const bool start = live && (t - first) % G == 0;
      const unsigned starts = __ballot_sync(0xffffffffu, start);
      const int rank = groups + __popc(starts & ((1u << lane) - 1u));
      const unsigned hit = __ballot_sync(0xffffffffu, start && rank == p);
      if (start && rank == p) {
        int n = 1, last = rows;
        for (; n < G && t + n < T; ++n) {
          const int rn = rt.tile_rows[t + n];
          if (rn <= 0 || rt.tile_expert[t + n] != e) break;
          last = rn;
        }
        r = make_int4(t, n, min(max(e, 0), rt.n_expert - 1),
                      64 * (n - 1) + min(last, 64));
      }
      if (hit) {
        const int src = __ffs(hit) - 1;
        r = make_int4(__shfl_sync(0xffffffffu, r.x, src),
                      __shfl_sync(0xffffffffu, r.y, src),
                      __shfl_sync(0xffffffffu, r.z, src),
                      __shfl_sync(0xffffffffu, r.w, src));
      }
      if (runs) seg = t0 + 31 - __clz(runs);
      prev_e = __shfl_sync(0xffffffffu, e, 31);
      groups += __popc(starts);
      nlive += __popc(__ballot_sync(0xffffffffu, live));
    }
    if (r.x < 0) {  // past the last group: G dead tiles (or none)
      const int first = nlive + G * (p - groups);
      r = make_int4(first, max(0, min(G, T - first)), 0, 0);
    }
    if (lane == 0) s_rows = r;
  }
  __syncthreads();
  return s_rows;
}

// The block body: one BM x BN output tile at row tile blockIdx.x (K4: the
// routed tiles of routed_rows), column tile blockIdx.y. The four tensor
// maps are the caller's __grid_constant__ kernel parameters.
template <int KIND, bool HAS_MIN, int WG, int RH, int BN_>
__device__ __forceinline__ void tile(const CUtensorMap* px,
                                     const CUtensorMap* pq,
                                     const CUtensorMap* ps,
                                     const CUtensorMap* pm, int M, int K,
                                     int npk, const float* __restrict__ lut,
                                     int group, int rb, Routing rt,
                                     float* __restrict__ out) {
  using P = Plan<KIND, HAS_MIN, WG, RH, BN_>;
  constexpr int PACK = P::PACK, BNP = P::BNP, BM = P::BM, BN = P::BN;
  constexpr int T = P::T, KB = P::KB, STAGES = P::STAGES;
  constexpr int OPR = BNP / 8;             // 8-column units per plane row
  constexpr int UPT = BK * OPR / T;        // plane rows per thread per step
  static_assert(UPT >= 1 && UPT <= 8 && 8 % UPT == 0, "thread roles");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t base_s = (raw_s + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (base_s - raw_s);
  auto stage_at = [&](int step) { return (step % STAGES) * P::STAGE; };
  const int b_off = STAGES * P::STAGE, f_off = b_off + 2 * P::B;
  const int m_off = f_off + 2 * P::F;
  float* lut_s = reinterpret_cast<float*>(base + P::LUT);
  const uint32_t bar_s = base_s + P::LUT + 64;  // STAGES mbarriers (8 B)

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int jb = blockIdx.y * BNP;
  const int G = K / group, nk = (K + BK - 1) / BK;
  auto slice = [&](int r) { return (wg * RH + r) * 64; };  // first row

  // the block's first row, expert, the rows it computes (live) and the
  // rows it writes (stored): K1 and K5 rows m0.. of x up to M; K4 the
  // routed tiles of routed_rows, zeros past their live rows
  int m0 = blockIdx.x * BM, expert = 0, live = M - m0, stored = M - m0;
  if (rt.tile_rows != nullptr) {
    static_assert(BM % 64 == 0, "whole routing tiles");
    const int4 r = routed_rows<BM / 64>(rt, M / 64, blockIdx.x);
    m0 = 64 * r.x;
    stored = 64 * r.y;
    expert = r.z;
    live = r.w;
  }
  if (live <= 0) {  // a dead tile: zeros over its rows, and no load
    for (int i = tid; i < BM * BN; i += T) {
      const int row = i / BN, h = (i % BN) / BNP, jj = i % BNP;
      if (row < stored && jb + jj < npk)
        out[((size_t)(m0 + row) * PACK + h) * npk + jb + jj] = 0.f;
    }
    return;
  }

  if (kind_lut(KIND) && tid < kind_nlut(KIND)) lut_s[tid] = lut[tid];
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bar_s + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (HAS_MIN) {
    // the fold's unused K slots stay zero in A and in B
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < 2 * P::F / 16; i += T)
      reinterpret_cast<uint4*>(base + f_off)[i] = z;
    for (int i = tid; i < 2 * FOLD * BN / 8; i += T) {
      const int buf = i / (FOLD * BN / 8), rem = i % (FOLD * BN / 8);
      const int a = rem / (FOLD * 8), row = BK + (rem / 8) % FOLD;
      *reinterpret_cast<uint4*>(base + b_off + buf * P::B + a * KB * 128 +
                                swz128(row, rem % 8)) = z;
    }
    // membership tile [8 groups x 64 K] (K-major, swizzled): 1 where K
    // slot k of a step lies in its group gg (group % 8 == 0: whole chunks)
    if (tid < 64) {
      const int gg = tid >> 3, c = tid & 7;
      const uint32_t one = gg < BK / group && c * 8 / group == gg
                               ? 0x3F803F80u : 0u;
      *reinterpret_cast<uint4*>(base + m_off + swz128(gg, c)) =
          make_uint4(one, one, one, one);
    }
  }

  // one thread loads a step into its ring slot with TMA (x tile, the
  // expert's plane rows, the rb scale and min rows from the step's first
  // group; dense: the B tile's 64-column boxes); rows past M or K and
  // columns past npk arrive as zeros
  const uint32_t s_bytes = P::DENSE ? 0 : PACK * rb * BNP * 2;
  auto load = [&](int step) {
    if (tid == 0 && step < nk) {
      const uint32_t st = base_s + stage_at(step), bar = bar_s + 8 * (step % STAGES);
      const int k0 = step * BK, g_lo = k0 / group;
      mbar_expect_tx(bar, P::X + P::Q + s_bytes * (HAS_MIN ? 2 : 1));
      tma_load_2d(st, px, bar, k0, m0);
      if constexpr (P::DENSE) {
#pragma unroll
        for (int a = 0; a < BN / 64; ++a)
          tma_load_3d(st + P::X + a * BK * 128, pq, bar, jb + 64 * a, k0,
                      expert);
      } else {
        tma_load_3d(st + P::X, pq, bar, jb, k0, expert);
        tma_load_4d(st + P::X + P::Q, ps, bar, jb, g_lo, 0, expert);
        if constexpr (HAS_MIN)
          tma_load_4d(st + P::X + P::Q + P::S, pm, bar, jb, g_lo, 0,
                      expert);
      }
    }
  };
  auto wait_loaded = [&](int step) {
    mbar_wait(bar_s + 8 * (step % STAGES), (step / STAGES) & 1);
  };

  // plane bytes and scales of one step -> the bf16 B tile (and the fold's
  // -min rows)
  auto dequant = [&](int step, int buf) {
    const unsigned char* st = base + stage_at(step);
    unsigned char* bt = base + b_off + buf * P::B;
    const int k0 = step * BK, g_lo = k0 / group;
    const int o = tid % OPR, kr0 = (tid / OPR) * UPT;
    // UPT divides 8 and group % 8 == 0: the thread's rows share one group
    const int sr = (k0 + kr0) / group - g_lo;
    if (k0 + kr0 < K) {
      __nv_bfloat162 s2[PACK][4], ns2[PACK][4];
      float sf[PACK][8];
#pragma unroll
      for (int h = 0; h < PACK; ++h) {
        const uint4 sv = *reinterpret_cast<const uint4*>(
            st + P::X + P::Q + ((h * rb + sr) * BNP + o * 8) * 2);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s2[h][e] = p[e];
          ns2[h][e] = __hmul2(p[e], __floats2bfloat162_rn(-128.f, -128.f));
          const float2 f = __bfloat1622float2(p[e]);
          sf[h][2 * e] = f.x;
          sf[h][2 * e + 1] = f.y;
        }
      }
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        const int k = kr0 + i;
        const uint2 w = *reinterpret_cast<const uint2*>(st + P::X + k * BNP + o * 8);
#pragma unroll
        for (int h = 0; h < PACK; ++h) {
          const uint2 lo = dequant4<KIND>(w.x, h, &s2[h][0], &ns2[h][0],
                                          &sf[h][0], lut_s);
          const uint2 hi = dequant4<KIND>(w.y, h, &s2[h][2], &ns2[h][2],
                                          &sf[h][4], lut_s);
          const int n8 = h * OPR + o;
          *reinterpret_cast<uint4*>(bt + (n8 >> 3) * KB * 128 +
                                    swz128(k, n8 & 7)) =
              make_uint4(lo.x, lo.y, hi.x, hi.y);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < UPT; ++i)
#pragma unroll
        for (int h = 0; h < PACK; ++h) {
          const int n8 = h * OPR + o;
          *reinterpret_cast<uint4*>(bt + (n8 >> 3) * KB * 128 +
                                    swz128(kr0 + i, n8 & 7)) =
              make_uint4(0, 0, 0, 0);
        }
    }
    if constexpr (HAS_MIN) {
      // -min (exact in bf16) for the step's groups gg, in rows 2 gg and
      // 2 gg + 1 of B's fold, against the x-sums' hi and lo halves in K
      // slots 2 gg and 2 gg + 1 of A's (store_xsums)
      const int ng = BK / group;
      for (int i = tid; i < ng * (BN / 8); i += T) {
        const int gg = i / (BN / 8), n8 = i % (BN / 8);
        const int h = n8 / OPR, c = n8 % OPR;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (g_lo + gg < G) {
          v = *reinterpret_cast<const uint4*>(
              st + P::X + P::Q + P::S + ((h * rb + gg) * BNP + c * 8) * 2);
          v.x ^= 0x80008000u; v.y ^= 0x80008000u;
          v.z ^= 0x80008000u; v.w ^= 0x80008000u;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<uint4*>(bt + (n8 >> 3) * KB * 128 +
                                    swz128(BK + 2 * gg + j, n8 & 7)) = v;
      }
    }
  };

  // The min, exactly, on the tensor cores: each 64-row slice's per-group
  // x-sums of a step (f32, as a product with the membership tile, the TPU
  // kernels' dot with a 0/1 matrix) split into bf16 hi + lo, stored in K
  // slots 2 gg and 2 gg + 1 of the fold's A tile; against -min in B's
  // fold rows, one more k16 product adds -(hi + lo) . min.
  float xs[RH][4];
  auto issue_xsums = [&](int step) {
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const uint32_t a_s = base_s + stage_at(step) + slice(r) * 128;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n8_kmajor(xs[r], wgmma_desc(a_s + kk * 32, 16, 1024),
                        wgmma_desc(base_s + m_off + kk * 32, 16, 1024), kk > 0);
    }
  };
  auto fence_xsums = [&]() {
#pragma unroll
    for (int r = 0; r < RH; ++r) wgmma_fence_acc(xs[r]);
  };
  auto store_xsums = [&](int buf) {
    unsigned char* ft = base + f_off + buf * P::F;
#pragma unroll
    for (int r = 0; r < RH; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = slice(r) + warp * 16 + (lane >> 2) + 8 * (i >> 1);
        const int gg = 2 * (lane & 3) + (i & 1);
        const __nv_bfloat16 hi = __float2bfloat16_rn(xs[r][i]);
        *reinterpret_cast<__nv_bfloat162*>(ft + fold_a(row, 2 * gg)) =
            __halves2bfloat162(hi, __float2bfloat16_rn(xs[r][i] - bf2f(hi)));
      }
  };

  float acc[RH][BN / 2];
#pragma unroll
  for (int r = 0; r < RH; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;
  auto fence_acc = [&]() {
#pragma unroll
    for (int r = 0; r < RH; ++r) wgmma_fence_acc(acc[r]);
  };

  __syncthreads();  // barriers initialised, fold tiles zeroed
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  wait_loaded(0);
  if constexpr (HAS_MIN) {
    fence_proxy_async();  // the membership tile
    __syncthreads();
    wgmma_fence();
    issue_xsums(0);
    wgmma_commit();
  }
  if constexpr (!P::DENSE) dequant(0, 0);
  if constexpr (HAS_MIN) {
    wgmma_wait<0>();
    fence_xsums();
    store_xsums(0);
  }
  fence_proxy_async();
  __syncthreads();

  for (int s = 0; s < nk; ++s) {
    load(s + STAGES - 1);
    // this warpgroup's RH slices of step s: four k16 products each and
    // the fold
    const uint32_t b_s = P::DENSE ? base_s + stage_at(s) + P::X
                                  : base_s + b_off + (s & 1) * P::B;
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const uint32_t a_s = base_s + stage_at(s) + slice(r) * 128;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_bf16(acc[r], wgmma_desc(a_s + kk * 32, 16, 1024),
                   wgmma_desc(b_s + kk * 2048, KB * 128, 1024));
      if constexpr (HAS_MIN)
        wgmma_bf16(acc[r],
                   wgmma_desc(base_s + f_off + (s & 1) * P::F +
                                  fold_a(slice(r), 0),
                              128, 256, false),
                   wgmma_desc(b_s + BK / 8 * 1024, KB * 128, 1024));
    }
    wgmma_commit();
    fence_acc();
    // while the tensor cores run step s, dequantize step s + 1 (and sum
    // its x rows on them)
    if (s + 1 < nk) {
      wait_loaded(s + 1);
      if constexpr (HAS_MIN) {
        fence_xsums();
        issue_xsums(s + 1);
        wgmma_commit();
        fence_xsums();
      }
      if constexpr (!P::DENSE) dequant(s + 1, (s + 1) & 1);
    }
    wgmma_wait<0>();
    fence_acc();
    if constexpr (HAS_MIN) {
      fence_xsums();
      if (s + 1 < nk) store_xsums((s + 1) & 1);
    }
    fence_proxy_async();
    __syncthreads();
  }

  // epilogue: tile column n = h * BNP + jj is output column h * npk + jb +
  // jj; rows from `live` to `stored` are written as zeros
#pragma unroll
  for (int r = 0; r < RH; ++r)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * (lane & 3);
      const int h = n / BNP, jj = n % BNP;
      if (jb + jj >= npk) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = slice(r) + warp * 16 + (lane >> 2) + 8 * half;
        if (row >= stored) continue;
        const bool ok = row < live;
        *reinterpret_cast<float2*>(
            out + ((size_t)(m0 + row) * PACK + h) * npk + jb + jj) =
            make_float2(ok ? acc[r][4 * j + 2 * half] : 0.f,
                        ok ? acc[r][4 * j + 2 * half + 1] : 0.f);
      }
    }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch

// qs is a byte plane, or bf16 for KIND_DENSE; the planes hold n_expert
// stacked experts; tile_expert and tile_rows are K4's routing (else null)
struct Args {
  const __nv_bfloat16* x; int M, K; const uint8_t* qs; int npk;
  const __nv_bfloat16 *scale, *minp; const float* lut; int group;
  float* out; cudaStream_t st;
  int n_expert = 1;
  const int* tile_expert = nullptr;
  const int* tile_rows = nullptr;
};

// Scale rows one K step reaches: 64 / group where the group divides 64, one
// where 64 divides the group, else at most 64 / group + 2.
static int step_rows(int group) {
  return BK % group == 0 ? BK / group : group % BK == 0 ? 1 : BK / group + 2;
}

using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                        int, int, int, const float*, int, int, Routing,
                        float*);

// Encode the maps of plan P (x [M, K]; the planes [E, K, npk] and the
// scales and mins [E, pack, K/group, npk], expert outermost; a dense stack
// has no scale or min) and launch kern (a __global__ wrapper of tile<...>
// with that plan) over every row and column tile.
template <class P>
static int launch(Kernel kern, const Args& a) {
  const int G = a.K / a.group, rb = step_rows(a.group);
  const cuuint64_t E = a.n_expert, npk = a.npk, K = a.K;
  constexpr int EB = P::DENSE ? 2 : 1;  // bytes a plane element
  CUtensorMap mx, mq, ms{}, mm{};
  const cuuint64_t dx[2] = {K, (cuuint64_t)a.M};
  const cuuint64_t sx[1] = {K * 2};
  const cuuint32_t bx[2] = {BK, P::BM};
  const cuuint64_t dq[3] = {npk, K, E};
  const cuuint64_t sq[2] = {npk * EB, K * npk * EB};
  const cuuint32_t bq[3] = {P::DENSE ? 64u : (cuuint32_t)P::BNP, BK, 1};
  const cuuint64_t ds[4] = {npk, (cuuint64_t)G, P::PACK, E};
  const cuuint64_t ss[3] = {npk * 2, G * npk * 2, P::PACK * G * npk * 2};
  const cuuint32_t bs[4] = {P::BNP, (cuuint32_t)rb, P::PACK, 1};
  bool ok = tensor_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, dx, sx,
                       bx, CU_TENSOR_MAP_SWIZZLE_128B) &&
            tensor_map(&mq,
                       P::DENSE ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                       3, a.qs, dq, sq, bq,
                       P::DENSE ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_NONE);
  if constexpr (!P::DENSE)
    ok = ok &&
         tensor_map(&ms, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.scale, ds, ss,
                    bs, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         tensor_map(&mm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                    a.minp ? a.minp : a.scale, ds, ss, bs,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  // set on every launch (microseconds of host time), so no flag can stand
  // for another kernel: a set-once static here was shared by every kernel
  // of a plan and, with external linkage, by every library the process
  // loads, and K4's quantized GEMMs once launched without it. A refused
  // attribute leaves the launch to fail, and launch_status() to report it
  (void)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::BYTES);
  const int row_blocks =
      a.tile_rows ? routed_blocks(a.M / 64, a.n_expert, P::BM / 64)
                  : (a.M + P::BM - 1) / P::BM;
  const dim3 grid(row_blocks, (a.npk + P::BNP - 1) / P::BNP);
  kern<<<grid, P::T, P::BYTES, a.st>>>(
      mx, mq, ms, mm, a.M, a.K, a.npk, a.lut, a.group, rb,
      Routing{a.tile_expert, a.tile_rows, a.n_expert}, a.out);
  return 0;
}

// The LUT kinds carry no min (no GGML type gives them one), so they are
// instantiated without it. L<KIND, HAS_MIN>::run(a) launches.
template <template <int, bool> class L>
static int dispatch(int kind, const Args& a) {
  const bool mn = a.minp != nullptr;
  int rc = 0;
  switch (kind) {
    case 0: rc = mn ? L<0, true>::run(a) : L<0, false>::run(a); break;
    case 1: rc = mn ? L<1, true>::run(a) : L<1, false>::run(a); break;
    case 2: rc = mn ? L<2, true>::run(a) : L<2, false>::run(a); break;
    case 3: rc = L<3, false>::run(a); break;
    case 4: rc = L<4, false>::run(a); break;
  }
  return rc ? rc : launch_status();
}

// operands every qmm entry point takes; false if the kernels do not
static bool valid(int M, int K, int kind, const void* minp, const void* lut,
                  int group) {
  return M >= 1 && kind >= 0 && kind <= 4 && group > 0 && K % group == 0 &&
         (lut != nullptr) == kind_lut(kind) &&
         !(kind_lut(kind) && minp != nullptr);
}

// the main loop's operands: K a multiple of 32, group a multiple of 8 and,
// with a min, one of 8, 16, 32, 64 (one step's groups fill at most the
// fold's 16 K slots), npk a multiple of 128
static bool valid_tiles(int M, int K, int npk, int kind, const void* minp,
                        const void* lut, int group) {
  return valid(M, K, kind, minp, lut, group) && K % 32 == 0 &&
         group % 8 == 0 && !(minp && BK % group) && npk % 128 == 0;
}

static Args make_args(const void* x, int M, int K, const void* qs, int npk,
                      const void* scale, const void* minp, const void* lut,
                      int group, void* out, void* stream) {
  return Args{(const __nv_bfloat16*)x, M, K, (const uint8_t*)qs, npk,
              (const __nv_bfloat16*)scale, (const __nv_bfloat16*)minp,
              (const float*)lut, group, (float*)out, (cudaStream_t)stream};
}

}  // namespace gemm
