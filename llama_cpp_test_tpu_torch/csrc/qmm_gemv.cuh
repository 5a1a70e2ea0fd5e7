// The decode (few-row) body shared by K1's GEMV (qmm.cu) and K4's GEMV
// (gmm.cu, where each live row tile reads its expert's planes through the
// expert coordinate of the TMA maps), and the plane-kind helpers every
// dequantizing kernel uses.
//
// y[M, pack, npk] = x[M, K] . dequant(W) for M <= 8: codes exact, partial
// sums in f32 per group, the bf16 group scale applied once per group, an
// affine min folded as (per-group x-sum) * min, LUT kinds as s * lut[q],
// dense bf16 stacks (K4) with neither.
//
// What bounds it on an H100: bytes (every plane, scale and min byte is read
// once; 2 * M flops a weight). What kept the first body at 8-54% of that
// bound was too few bytes in flight (one 2- or 4-byte load a lane and row,
// about two blocks an SM), x read as scalar global loads in the inner loop,
// and a memset launch plus atomics wherever K was split. This body:
//
//   - A ring of plane tiles in shared memory. Warp 4 of each block is the
//     producer: for each stage of `stage_rows` K rows, one TMA box of the
//     block's column tile of plane rows, one of the scale rows of the
//     groups the stage holds and one of the min's (tensor maps of 8-byte
//     elements, gemv_encode), all completing on the stage's mbarrier;
//     `stages` stages (about 48 KB) in flight a block, three blocks an SM.
//   - x staged once per block: the block's K range of all M rows (in
//     chunks of `x_rows` rows where it does not fit), with the per-segment
//     x-sums the min needs, in shared memory. The inner loop reads no
//     global memory.
//   - Warps 0-3 consume: `row_groups` groups of 128 / row_groups threads,
//     group r taking the stages r, r + row_groups, ... (`stages` a
//     multiple of row_groups, so a ring slot serves one row group only:
//     a slot's mbarrier waited by parity would pass two phases early if
//     the slot's previous stage were another group's and not yet landed).
//     Up to 2 rows, each
//     thread holds 8 outputs a row and multiplies on the FMA pipe (codes
//     to floats by a byte permute against 2^23, no int-to-float
//     conversion). Blocks of 3-8 rows (the MT 4 and 8 kernels, 4 outputs a
//     thread) run on mma.sync m16n8k16 where a segment (one group's rows
//     in a stage) is a multiple of 16 rows, the FMA pipe elsewhere.
//   - K split across a thread-block cluster along K (gridDim.x = splits,
//     at most 8 CTAs): each CTA leaves its sums in its own shared memory,
//     and after a cluster barrier CTA rank q sums a slice of the outputs
//     over every CTA through distributed shared memory, in a fixed order,
//     and stores it once. No memset, no atomics: two calls give the same
//     bits.
//
// The launch plan (column blocks, splits, rows a split, row groups, stage
// rows, stages, x rows, the rows from which mma runs) comes from
// ops/qmatmul.gemv_plan; gemv_plan_ok checks it and the kernel takes any
// plan it accepts.
#pragma once

#include <utility>

#include "common.cuh"
#include "sm90.cuh"

// Plane kinds (ops/qmatmul._KIND_ID): 0 int8, 1 u4 (nibbles), 2 u2
// (crumbs), 3 u4lut (nibble codes into a 16-entry LUT), 4 u2lut (crumb
// codes into a 4-entry LUT). Sub-value h of byte b is bits
// [h*bits, (h+1)*bits) and belongs to output column h*NPK + j. K4 adds
// KIND_DENSE: a bf16 [K, N] weight, with no scale, min or LUT.
constexpr int KIND_DENSE = 5;
__host__ __device__ constexpr int kind_pack(int kind) {
  return kind == 0 || kind == KIND_DENSE ? 1
         : (kind == 1 || kind == 3)      ? 2
                                         : 4;
}
__host__ __device__ constexpr bool kind_lut(int kind) {
  return kind == 3 || kind == 4;
}
__host__ __device__ constexpr int kind_nlut(int kind) {
  return kind_lut(kind) ? 1 << (8 / kind_pack(kind)) : 0;
}

constexpr int GEMV_CONSUMERS = 128;                 // warps 0-3
constexpr int GEMV_THREADS = GEMV_CONSUMERS + 32;   // + the producer warp
constexpr int GEMV_MAX_SPLITS = 8;  // the portable cluster size
// the row instantiations with a tensor-core path (M >= 3); fewer rows run
// on the FMA pipe only
constexpr int GEMV_MMA_MIN_MT = 4;

// Outputs a consumer thread holds a row (NO): 8 in the kernels built for
// at most 2 rows, 4 in those built for up to 8, whose tensor-core body
// would otherwise hold 128 f32 sums a thread; the plane bytes a thread
// reads a K row and the packed columns they hold follow
// (ops/qmatmul.gemv_plan mirrors all three).
__host__ __device__ constexpr int gemv_no(int mt) { return mt <= 2 ? 8 : 4; }
__host__ __device__ constexpr int gemv_lane_cols(int kind, int no) {
  return kind == KIND_DENSE ? no : no / kind_pack(kind);
}
__host__ __device__ constexpr int gemv_lane_bytes(int kind, int no) {
  return gemv_lane_cols(kind, no) * (kind == KIND_DENSE ? 2 : 1);
}

// The launch plan (ops/qmatmul.gemv_plan).
struct GemvPlan {
  int col_blocks, splits, rows_per_split, row_groups, stage_rows, stages,
      x_rows;
  int mma;  // rows from which a block's products run on mma.sync (0: never)
};

// Operands of one GEMV launch. K4 adds the routing (tile_m rows a tile).
struct GemvArgs {
  const __nv_bfloat16* x; int M, K; const void* qs; int npk;
  const __nv_bfloat16 *scale, *minp; const float* lut; int group;
  float* out;
  const int* tile_expert; const int* tile_rows; int n_expert;
};

// Byte offsets of a block's dynamic shared memory: the stage ring (reused
// for the partial sums once the ring is drained), staged x, the x-sums of
// each segment (a group's rows within one stage), the mbarriers, the LUT.
struct GemvSmem {
  int plane, scale, stage, ring, x, xsum, bars, lut, total;
};

// groups whose scale rows one stage brings
__host__ __device__ inline int gemv_stage_groups(int kt, int group) {
  return kt > group ? kt / group : 1;
}

// Every region starts 128-byte aligned (TMA destinations).
__host__ __device__ inline GemvSmem gemv_smem(int kind, bool has_min, int mt,
                                              int no, const GemvPlan& p,
                                              int group) {
  const int ct = GEMV_CONSUMERS / p.row_groups;
  const int kt = p.stage_rows, seg = group < kt ? group : kt;
  auto up = [](int b) { return (b + 127) & ~127; };
  GemvSmem s;
  s.plane = up(kt * ct * gemv_lane_bytes(kind, no));
  s.scale = kind == KIND_DENSE
                ? 0
                : up(gemv_stage_groups(kt, group) * kind_pack(kind) * ct *
                     gemv_lane_cols(kind, no) * 2);
  s.stage = s.plane + s.scale * (has_min ? 2 : 1);
  const int red = mt * no * GEMV_CONSUMERS * 4;
  s.ring = p.stages * s.stage > red ? p.stages * s.stage : red;
  s.x = s.ring;
  s.xsum = s.x + up(mt * p.x_rows * 2);
  s.bars = s.xsum + (has_min ? mt * (p.x_rows / seg) * 4 : 0);
  s.bars = (s.bars + 15) & ~15;
  s.lut = s.bars + 2 * p.stages * 8;
  s.total = s.lut + 16 * 4;
  return s;
}

// Whether the kernel takes plan p for these operands: whole groups a split,
// splits covering K with none empty, stage rows a multiple or a divisor of
// the group, stages a multiple of the row groups, x chunks of whole
// stages, column blocks covering npk.
__host__ inline bool gemv_plan_ok(int kind, int no, int K, int group,
                                  int npk, const GemvPlan& p) {
  const int rg = p.row_groups, kt = p.stage_rows;
  if (rg != 1 && rg != 2 && rg != 4) return false;
  if (p.splits < 1 || p.splits > GEMV_MAX_SPLITS || p.rows_per_split <= 0 ||
      p.rows_per_split % group || (long)p.splits * p.rows_per_split < K ||
      (long)(p.splits - 1) * p.rows_per_split >= K)
    return false;
  if (kt <= 0 || kt > 256 || (kt % group && group % kt)) return false;
  if (p.stages < 2 || p.stages > 16 || p.stages % rg || p.x_rows < kt ||
      p.x_rows % kt)
    return false;
  // the tensor-core path: blocks of 3 rows or more (MT >= 4), 16 K rows
  // a step within one group, no dense stack
  if (p.mma < 0 ||
      (p.mma > 0 && (p.mma <= GEMV_MMA_MIN_MT / 2 || kind == KIND_DENSE ||
                     (group < kt ? group : kt) % 16 || kt % 16)))
    return false;
  const int cols = GEMV_CONSUMERS / rg * gemv_lane_cols(kind, no);
  return p.col_blocks >= 1 && (long)p.col_blocks * cols >= npk &&
         (long)(p.col_blocks - 1) * cols < npk;
}

// ---------------------------------------------------------------------------
// PTX the body needs beyond sm90.cuh

static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// the consumer warps only (named barrier 1)
static __device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(GEMV_CONSUMERS) : "memory");
}
static __device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// shared address addr of cluster CTA `rank` (volatile: it stays after the
// cluster barrier, and so do the loads that depend on it)
static __device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                        int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}
// the f32 at a cluster shared address (not volatile: loads of one output's
// terms may all be in flight at once)
static __device__ __forceinline__ float ld_cluster(uint32_t remote) {
  float v;
  asm("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

// f(std::integral_constant<int, I>) for each I of the sequence
template <class F, int... I>
static __device__ __forceinline__ void for_consts(
    F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

// byte c of w as the float 2^23 + byte (exact; one permute, no I2F)
template <int C>
static __device__ __forceinline__ float byte_magic(uint32_t w) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | C));
}

// The NO plane values one thread takes from one K row at p (shared
// memory): output o is sub-value h = o / LC of packed column o % LC (LC =
// NO / pack), or bf16 column o for a dense stack.
template <int KIND, int NO>
static __device__ __forceinline__ void decode_row(const uint8_t* p,
                                                  const float* lut,
                                                  float (&q)[NO]) {
  constexpr float TWO23 = 8388608.f;
  constexpr int LC = gemv_lane_cols(KIND, NO);
  if constexpr (KIND == KIND_DENSE) {
    uint32_t v[NO / 2];
    if constexpr (NO == 8) {
      const uint4 w = *reinterpret_cast<const uint4*>(p);
      v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    } else {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      v[0] = w.x; v[1] = w.y;
    }
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) {
      q[2 * i] = __uint_as_float(v[i] << 16);
      q[2 * i + 1] = __uint_as_float(v[i] & 0xFFFF0000u);
    }
  } else {
    // the LC bytes as words (1, 2, 4 or 8 bytes)
    uint32_t w[(LC + 3) / 4];
    if constexpr (LC == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x; w[1] = u.y;
    } else if constexpr (LC == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (LC == 2) {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    } else {
      w[0] = *p;
    }
    auto byte_of = [&](auto cc) { return w[decltype(cc)::value / 4]; };
    auto one = [&](auto hc) {
      constexpr int H = decltype(hc)::value / LC, C = decltype(hc)::value % LC;
      const uint32_t word = byte_of(std::integral_constant<int, C>{});
      constexpr int B = C % 4;  // byte of the word
      if constexpr (KIND == 0) {
        q[C] = byte_magic<B>(word ^ 0x80808080u) - (TWO23 + 128.f);
      } else if constexpr (KIND == 1 || KIND == 2) {
        constexpr int BITS = KIND == 1 ? 4 : 2;
        const uint32_t t = (word >> (BITS * H)) & (KIND == 1 ? 0x0F0F0F0Fu
                                                             : 0x03030303u);
        q[H * LC + C] = byte_magic<B>(t) - TWO23;
      } else {
        constexpr int BITS = KIND == 3 ? 4 : 2;
        q[H * LC + C] = lut[(word >> (8 * B + BITS * H)) & ((1u << BITS) - 1u)];
      }
    };
    for_consts(one, std::make_integer_sequence<int, NO>{});
  }
}

// N bf16 at shared address p (N = 1, 2, 4 or 8; 2N-byte aligned) as
// floats
template <int N>
static __device__ __forceinline__ void smem_bf16(const __nv_bfloat16* p,
                                                 float* f) {
  uint32_t v[N / 2 > 0 ? N / 2 : 1];
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = u.x; v[1] = u.y;
  } else if constexpr (N == 2) {
    v[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    f[0] = bf2f(*p);
    return;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xFFFF0000u);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core consumer (blocks of at least plan.mma rows; segments of
// a multiple of 16 rows): each warp
// takes 256 outputs of the tile as 16 mma.sync m16n8k16 tiles of 16 outputs
// x 16 K rows, A the codes (or LUT entries) as bf16, exact (every code and
// LUT entry the repack makes is), B the staged x of up to 8 rows. The MMA's
// K slots 2t, 2t+1, 2t+8, 2t+9 of lane (g, t) are K rows 4t..4t+3 of the
// 16, so a lane's four A rows are four plane rows of one column and its B
// pair one 8-byte load of x. C restarts at every segment; its scale (and
// min fold) is applied in f32, as on the FMA pipe.

static __device__ __forceinline__ void gemv_mma(float (&d)[4], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint32_t b0,
                                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// byte b of w0 and of w1 as bytes 0 and 2 (1 and 3 copies)
template <int B>
static __device__ __forceinline__ uint32_t pair_bytes(uint32_t w0,
                                                      uint32_t w1) {
  return __byte_perm(w0, w1, B | (B << 4) | ((B + 4) << 8) | ((B + 4) << 12));
}

// bf16x2 (128 + q0, 128 + q1) -> (q0, q1), exact
static __device__ __forceinline__ uint32_t minus128(uint32_t v) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                                   __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The bf16 pair (K row of byte 0, K row of byte 2 of p) of sub-value H.
template <int KIND, int H>
static __device__ __forceinline__ uint32_t code_pair(uint32_t p,
                                                     const float* lut,
                                                     const uint32_t* lut2) {
  if constexpr (KIND == 0) {
    const uint32_t v = p ^ 0x80808080u;
    const __nv_bfloat162 r = __floats2bfloat162_rn(
        byte_magic<0>(v) - (8388608.f + 128.f),
        byte_magic<2>(v) - (8388608.f + 128.f));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else if constexpr (KIND == 1) {
    return minus128(((p >> (4 * H)) & 0x000F000Fu) | 0x43004300u);
  } else if constexpr (KIND == 2) {
    return minus128(((p >> (2 * H)) & 0x00030003u) | 0x43004300u);
  } else if constexpr (KIND == 3) {
    const uint32_t lo = __float_as_uint(lut[(p >> (4 * H)) & 15u]);
    const uint32_t hi = __float_as_uint(lut[(p >> (16 + 4 * H)) & 15u]);
    return (lo >> 16) | (hi & 0xFFFF0000u);
  } else {
    // the 4-entry bf16 LUT lives in two registers (lut2): a permute picks
    // bytes 2c, 2c + 1 of each code c (selector nibbles 2c0, 2c0 + 1, 2c1,
    // 2c1 + 1)
    const uint32_t v = (p >> (2 * H)) & 0x00030003u;
    const uint32_t t = v | (v >> 8);
    return __byte_perm(lut2[0], lut2[1], t * 0x22u + 0x1010u);
  }
}

// Tile T (0 .. 2 NO - 1) of a warp: the word columns (8 apart, lane g's
// the g-th of each 8; NS = LB of them a row) of its A rows g and g + 8, the
// byte b within them, and their sub-values.
template <int KIND, int NO, int T>
struct MmaTile {
  static constexpr int PACK = kind_pack(KIND);
  static constexpr int NS = gemv_lane_bytes(KIND, NO);
  static constexpr int B = PACK == 4 ? (T / 2) % 4 : T % 4;
  static constexpr int S_LO = PACK == 4 ? T / 8 : T / 4;
  static constexpr int S_HI = PACK == 1 ? S_LO + NS / 2 : S_LO;
  static constexpr int H_LO = PACK == 4 ? 2 * (T % 2) : 0;
  static constexpr int H_HI = PACK == 1 ? 0 : H_LO + 1;
};

// One 16-row K step of every tile: part[T] += A_T . B.
template <int KIND, int NO>
static __device__ __forceinline__ void mma_step(
    const uint32_t (&w)[4][gemv_lane_bytes(KIND, NO)], uint32_t b0,
    uint32_t b1, const float* lut, const uint32_t* lut2,
    float (&part)[2 * NO][4]) {
  for_consts([&](auto tile) {
    constexpr int T = decltype(tile)::value;
    using Tl = MmaTile<KIND, NO, T>;
    const uint32_t p01 = pair_bytes<Tl::B>(w[0][Tl::S_LO], w[1][Tl::S_LO]);
    const uint32_t p23 = pair_bytes<Tl::B>(w[2][Tl::S_LO], w[3][Tl::S_LO]);
    const uint32_t q01 =
        Tl::S_HI == Tl::S_LO ? p01
                             : pair_bytes<Tl::B>(w[0][Tl::S_HI], w[1][Tl::S_HI]);
    const uint32_t q23 =
        Tl::S_HI == Tl::S_LO ? p23
                             : pair_bytes<Tl::B>(w[2][Tl::S_HI], w[3][Tl::S_HI]);
    gemv_mma(part[T], code_pair<KIND, Tl::H_LO>(p01, lut, lut2),
             code_pair<KIND, Tl::H_HI>(q01, lut, lut2),
             code_pair<KIND, Tl::H_LO>(p23, lut, lut2),
             code_pair<KIND, Tl::H_HI>(q23, lut, lut2), b0, b1);
  }, std::make_integer_sequence<int, 2 * NO>{});
}

// flush of every tile: acc += scale * part (- min * x-sums), in f32; a
// lane's scales (and mins) come four columns (the four bytes b) a load
template <int KIND, int NO, bool HAS_MIN, class ScAt>
static __device__ __forceinline__ void mma_flush(
    const float (&part)[2 * NO][4], float (&acc)[2 * NO][4], ScAt& sc_at,
    const uint8_t* st, int gi, int wb, int g, float xs0, float xs1) {
  constexpr int PACK = kind_pack(KIND), NS = gemv_lane_bytes(KIND, NO);
  float sv[NS][PACK][4], mv[HAS_MIN ? NS : 1][PACK][4];
#pragma unroll
  for (int sc = 0; sc < NS; ++sc)
#pragma unroll
    for (int h = 0; h < PACK; ++h) {
      smem_bf16<4>(sc_at(st, 0, gi, h, wb + 4 * (8 * sc + g)), sv[sc][h]);
      if constexpr (HAS_MIN)
        smem_bf16<4>(sc_at(st, 1, gi, h, wb + 4 * (8 * sc + g)), mv[sc][h]);
    }
  for_consts([&](auto tile) {
    constexpr int T = decltype(tile)::value;
    using Tl = MmaTile<KIND, NO, T>;
    const float slo = sv[Tl::S_LO][Tl::H_LO][Tl::B];
    const float shi = sv[Tl::S_HI][Tl::H_HI][Tl::B];
    float(&a)[4] = acc[T];
    a[0] = fmaf(slo, part[T][0], a[0]);
    a[1] = fmaf(slo, part[T][1], a[1]);
    a[2] = fmaf(shi, part[T][2], a[2]);
    a[3] = fmaf(shi, part[T][3], a[3]);
    if constexpr (HAS_MIN) {
      const float mlo = mv[Tl::S_LO][Tl::H_LO][Tl::B];
      const float mhi = mv[Tl::S_HI][Tl::H_HI][Tl::B];
      a[0] = fmaf(-mlo, xs0, a[0]);
      a[1] = fmaf(-mlo, xs1, a[1]);
      a[2] = fmaf(-mhi, xs0, a[2]);
      a[3] = fmaf(-mhi, xs1, a[3]);
    }
  }, std::make_integer_sequence<int, 2 * NO>{});
}

template <int KIND, int MT, int NO, bool HAS_MIN, class Consume, class ScAt,
          class RedAt>
static __device__ __forceinline__ void gemv_consume_mma(
    Consume& consume, ScAt& sc_at, float* red, RedAt& red_at,
    const __nv_bfloat16* x_s, const float* xsum_s, const float* lut_s,
    int x_rows, int nsx, int seg, int group, int kt, int row_bytes, int c,
    int r) {
  constexpr int LB = gemv_lane_bytes(KIND, NO), NT = 2 * NO;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wb = (c >> 5) * 32 * LB;  // the warp's first packed column
  uint32_t lut2[2] = {0, 0};  // u2lut: the LUT as bf16 pairs
  if constexpr (KIND == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(lut_s[0], lut_s[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(lut_s[2], lut_s[3]);
    lut2[0] = *reinterpret_cast<const uint32_t*>(&a);
    lut2[1] = *reinterpret_cast<const uint32_t*>(&b);
  }
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  consume([&](const uint8_t* st, int rows, int kl) {
    for (int r0 = 0; r0 < rows; r0 += seg) {
      float part[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
      for (int kk = r0; kk < r0 + seg; kk += 16) {
        uint32_t b0 = 0, b1 = 0;
        if (g < MT) {
          const uint2 xb = *reinterpret_cast<const uint2*>(
              x_s + g * x_rows + kl + kk + 4 * t);
          b0 = xb.x;
          b1 = xb.y;
        }
        uint32_t w[4][LB];
        const uint8_t* pr = st + (kk + 4 * t) * row_bytes + wb + 4 * g;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int sc = 0; sc < LB; ++sc)
            w[i][sc] = *reinterpret_cast<const uint32_t*>(
                pr + i * row_bytes + 32 * sc);
        mma_step<KIND, NO>(w, b0, b1, lut_s, lut2, part);
      }
      const int gi = group <= kt ? r0 / group : 0;
      float xs0 = 0.f, xs1 = 0.f;
      if constexpr (HAS_MIN) {
        const int sg = (kl + r0) / seg;
        if (2 * t < MT) xs0 = xsum_s[2 * t * nsx + sg];
        if (2 * t + 1 < MT) xs1 = xsum_s[(2 * t + 1) * nsx + sg];
      }
      mma_flush<KIND, NO, HAS_MIN>(part, acc, sc_at, st, gi, wb, g, xs0, xs1);
    }
  });
  // D rows g, g + 8 of tile T are its A rows; columns 2t, 2t + 1 rows m
  for_consts([&](auto tile) {
    constexpr int T = decltype(tile)::value;
    using Tl = MmaTile<KIND, NO, T>;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 2 * t + (i & 1);
      const bool hi = i >= 2;
      const int jj = wb + 4 * (8 * (hi ? Tl::S_HI : Tl::S_LO) + g) + Tl::B;
      if (m < MT) red[red_at(r, m, hi ? Tl::H_HI : Tl::H_LO, jj)] = acc[T][i];
    }
  }, std::make_integer_sequence<int, NT>{});
}

// The TMA maps of one launch (gemv_encode): the planes [E, K, npk] and the
// scales and mins [E, pack, K/group, npk], as 8-byte elements.
struct GemvMaps {
  CUtensorMap q, s, m;
};

// One block of the GEMV: column block bx of split `split`, MT >= M rows.
// x [M, K] bf16, expert e of the maps' planes, out [store_rows, pack, npk]
// f32: rows m < M the products, rows M..store_rows-1 zeros (K4's pad
// rows). Every CTA of a cluster must call it with the same operands but
// its split.
template <int KIND, int MT, bool HAS_MIN, int NO = gemv_no(MT)>
static __device__ __forceinline__ void gemv_block(
    const GemvMaps& maps, const __nv_bfloat16* __restrict__ x, int M, int K,
    int e, int npk, const float* __restrict__ lut, int group,
    float* __restrict__ out, int store_rows, const GemvPlan& p, uint8_t* smem,
    int split, int bx) {
  constexpr int PACK = kind_pack(KIND);
  constexpr int LB = gemv_lane_bytes(KIND, NO), LC = gemv_lane_cols(KIND, NO);
  constexpr bool DENSE = KIND == KIND_DENSE;
  const GemvSmem L = gemv_smem(KIND, HAS_MIN, MT, NO, p, group);
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = p.row_groups, ct = GEMV_CONSUMERS / rg;
  const int tile_cols = ct * LC, row_bytes = ct * LB;
  const int j0 = bx * tile_cols, ncols = min(tile_cols, npk - j0);
  // a segment: the rows of one group within one stage (a dense stack's
  // products need no segments: its whole stage)
  const int kt = p.stage_rows, seg = DENSE ? kt : min(group, kt);
  const int stages = p.stages;
  const int ngb = gemv_stage_groups(kt, group);  // scale rows a stage
  const int k_begin = split * p.rows_per_split;
  const int k_end = min(K, k_begin + p.rows_per_split);
  const int nstage = (k_end - k_begin + kt - 1) / kt;
  const int x_stages = p.x_rows / kt;
  const uint32_t ring_s = smem_u32(smem);
  const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * stages;
  float* lut_s = reinterpret_cast<float*>(smem + L.lut);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem + L.x);
  float* xsum_s = reinterpret_cast<float*>(smem + L.xsum);
  const int nsx = p.x_rows / seg;  // x-sum slots a row (with a min)

  // the producer: one TMA box a stage for the plane rows, one for the
  // scale rows of its groups (pack x groups x columns), one for the min's
  const bool producer = tid == GEMV_CONSUMERS;
  const uint32_t stage_bytes =
      kt * row_bytes +
      (DENSE ? 0 : ngb * PACK * tile_cols * 2 * (HAS_MIN ? 2 : 1));
  auto issue = [&](int s) {
    const int slot = s % stages, k0 = k_begin + s * kt;
    const uint32_t st = ring_s + slot * L.stage, bar = full + 8 * slot;
    mbar_expect_tx(bar, stage_bytes);
    tma_load_3d(st, &maps.q, bar, bx * row_bytes / 8, k0, e);
    if constexpr (!DENSE) {
      tma_load_4d(st + L.plane, &maps.s, bar, j0 / 4, k0 / group, 0, e);
      if constexpr (HAS_MIN)
        tma_load_4d(st + L.plane + L.scale, &maps.m, bar, j0 / 4, k0 / group,
                    0, e);
    }
  };
  if (producer) {
    // the maps' descriptors on their way while the block sets up; the
    // barriers are this CTA's own: a proxy fence makes them the TMA's
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.q) : "memory");
    if constexpr (!DENSE) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.s) : "memory");
      if constexpr (HAS_MIN)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.m) : "memory");
    }
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, ct / 32);
    }
    fence_proxy_async();
  }
  if (kind_lut(KIND) && tid < kind_nlut(KIND)) lut_s[tid] = lut[tid];
  __syncthreads();

  const int c = tid % ct, r = tid / ct;
  float* red = reinterpret_cast<float*>(smem);
  // partial sums red[row group][m][h][column of the tile] (the ring, once
  // drained)
  auto red_at = [&](int rr, int m, int h, int jj) {
    return ((rr * MT + m) * PACK + h) * tile_cols + jj;
  };

  // The consumers' walk: x staged a chunk at a time (zeros past M, then
  // the segment x-sums with a min), and each of this row group's stages,
  // waited for, handed to stage_fn(stage, rows, chunk-local first row) and
  // released to the producer.
  auto consume = [&](auto&& stage_fn) {
    for (int cs = 0; cs < nstage; cs += x_stages) {
      const int ce = min(nstage, cs + x_stages);
      const int kc0 = k_begin + cs * kt, kc1 = min(k_end, k_begin + ce * kt);
      const int xr = kc1 - kc0;
      consumer_sync();  // the previous chunk is no longer read
      if (kc0 % 8 == 0 && xr % 8 == 0 && p.x_rows % 8 == 0) {
        // 16 bytes a load (K % 32 == 0: rows stay aligned)
        const int xr8 = xr / 8;
        for (int i = tid; i < MT * xr8; i += GEMV_CONSUMERS) {
          const int m = i / xr8, kk = 8 * (i % xr8);
          *reinterpret_cast<uint4*>(x_s + m * p.x_rows + kk) =
              m < M ? __ldg(reinterpret_cast<const uint4*>(
                          x + (size_t)m * K + kc0 + kk))
                    : make_uint4(0, 0, 0, 0);
        }
      } else {
        for (int i = tid; i < MT * xr; i += GEMV_CONSUMERS) {
          const int m = i / xr, kk = i % xr;
          x_s[m * p.x_rows + kk] =
              m < M ? x[(size_t)m * K + kc0 + kk] : __float2bfloat16(0.f);
        }
      }
      consumer_sync();
      if constexpr (HAS_MIN) {
        const int ns = xr / seg;
        for (int i = tid; i < MT * ns; i += GEMV_CONSUMERS) {
          const int m = i / ns, sg = i % ns;
          const __nv_bfloat16* xp = x_s + m * p.x_rows + sg * seg;
          float t = 0.f;
          if (seg % 8 == 0 && p.x_rows % 8 == 0) {
            for (int k = 0; k < seg; k += 8) {
              float v[8];
              smem_bf16<8>(xp + k, v);
#pragma unroll
              for (int j = 0; j < 8; ++j) t += v[j];
            }
          } else {
            for (int k = 0; k < seg; ++k) t += bf2f(xp[k]);
          }
          xsum_s[m * nsx + sg] = t;
        }
        consumer_sync();
      }
      for (int s = cs + ((r - cs) % rg + rg) % rg; s < ce; s += rg) {
        const int slot = s % stages;
        mbar_wait(full + 8 * slot, (s / stages) & 1);
        const int k0 = k_begin + s * kt;
        stage_fn(smem + slot * L.stage, min(kt, k_end - k0), k0 - kc0);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * slot);
      }
    }
    consumer_sync();  // every stage read: the ring may hold red
  };
  // the segment's scale (or min) of packed column jj of the tile, as read
  // from the stage
  auto sc_at = [&](const uint8_t* st, int which, int gi, int h, int jj) {
    return reinterpret_cast<const __nv_bfloat16*>(
               st + L.plane + which * L.scale) +
           (h * ngb + gi) * tile_cols + jj;
  };

  if (tid >= GEMV_CONSUMERS) {
    // producer: each stage once its slot is free
    if (producer) {
      for (int s = 0; s < nstage; ++s) {
        if (s >= stages)
          mbar_wait(empty + 8 * (s % stages), ((s / stages) - 1) & 1);
        issue(s);
      }
    }
  } else if (p.mma > 0 && M >= p.mma) {
    if constexpr (!DENSE && MT >= GEMV_MMA_MIN_MT)
      gemv_consume_mma<KIND, MT, NO, HAS_MIN>(consume, sc_at, red, red_at, x_s,
                                          xsum_s, lut_s, p.x_rows, nsx, seg,
                                          group, kt, row_bytes, c, r);
  } else {
    // FMA pipe: thread c takes NO outputs a row (o = h * LC + cc:
    // sub-value h of packed column c * LC + cc)
    float acc[MT][NO];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int o = 0; o < NO; ++o) acc[m][o] = 0.f;
    consume([&](const uint8_t* st, int rows, int kl) {
      for (int r0 = 0; r0 < rows; r0 += seg) {
        // a dense stack's last stage of a split may hold fewer rows
        const int len = DENSE ? min(seg, rows - r0) : seg;
        float part[MT][NO];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int o = 0; o < NO; ++o) part[m][o] = 0.f;
        const __nv_bfloat16* xr0 = x_s + kl + r0;
        const uint8_t* pr = st + r0 * row_bytes + c * LB;
        if (MT <= 2 && seg % 8 == 0 && kt % 8 == 0) {
          // x eight rows at a time (16-byte aligned: kl + r0 % 8 == 0)
          for (int i = 0; i < len; i += 8) {
            float xv[MT][8];
#pragma unroll
            for (int m = 0; m < MT; ++m)
              smem_bf16<8>(xr0 + m * p.x_rows + i, xv[m]);
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              float q[NO];
              decode_row<KIND, NO>(pr + (i + u) * row_bytes, lut_s, q);
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int o = 0; o < NO; ++o)
                  part[m][o] = fmaf(xv[m][u], q[o], part[m][o]);
            }
          }
        } else {
#pragma unroll 4
          for (int i = 0; i < len; ++i) {
            float q[NO];
            decode_row<KIND, NO>(pr + i * row_bytes, lut_s, q);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float xv = bf2f(xr0[m * p.x_rows + i]);
#pragma unroll
              for (int o = 0; o < NO; ++o)
                part[m][o] = fmaf(xv, q[o], part[m][o]);
            }
          }
        }
        if constexpr (DENSE) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int o = 0; o < NO; ++o) acc[m][o] += part[m][o];
        } else {
          // the segment's group scale (and min) once, in f32
          const int gi = group <= kt ? r0 / group : 0;
          float sv[NO], mv[NO];
#pragma unroll
          for (int h = 0; h < PACK; ++h) {
            smem_bf16<LC>(sc_at(st, 0, gi, h, c * LC), sv + h * LC);
            if constexpr (HAS_MIN)
              smem_bf16<LC>(sc_at(st, 1, gi, h, c * LC), mv + h * LC);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float xs = 0.f;
            if constexpr (HAS_MIN) xs = xsum_s[m * nsx + (kl + r0) / seg];
#pragma unroll
            for (int o = 0; o < NO; ++o) {
              acc[m][o] = fmaf(sv[o], part[m][o], acc[m][o]);
              if constexpr (HAS_MIN) acc[m][o] = fmaf(-mv[o], xs, acc[m][o]);
            }
          }
        }
      }
    });
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int o = 0; o < NO; ++o)
        red[red_at(r, m, o / LC, c * LC + o % LC)] = acc[m][o];
  }

  const int nsplit = p.splits;
  if (nsplit > 1) cluster_sync(); else __syncthreads();
  // CTA `split` (its cluster rank) sums and stores a slice of the outputs,
  // columns fastest, over every CTA and row group in a fixed order
  const int per_row = PACK * ncols, total = store_rows * per_row;
  const int lo = (int)((long)total * split / nsplit);
  const int hi = (int)((long)total * (split + 1) / nsplit);
  for (int i = lo + tid; i < hi; i += GEMV_THREADS) {
    const int m = i / per_row, h = (i % per_row) / ncols, jj = i % ncols;
    float v = 0.f;
    if (m < MT) {
      const int step = MT * PACK * tile_cols;  // one row group's partials
      if (nsplit > 1) {
        // every term's load in flight at once, then the sum in rank order
        const uint32_t a = smem_u32(red + red_at(0, m, h, jj));
        float t[GEMV_MAX_SPLITS][4];
#pragma unroll
        for (int q = 0; q < GEMV_MAX_SPLITS; ++q) {
          const uint32_t ra = cluster_addr(a, q < nsplit ? q : 0);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            t[q][rr] = q < nsplit && rr < rg ? ld_cluster(ra + 4 * rr * step)
                                             : 0.f;
        }
#pragma unroll
        for (int q = 0; q < GEMV_MAX_SPLITS; ++q)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) v += t[q][rr];
      } else {
        for (int rr = 0; rr < rg; ++rr) v += red[red_at(0, m, h, jj) + rr * step];
      }
    }
    out[((size_t)m * PACK + h) * npk + j0 + jj] = v;
  }
  // no CTA leaves while another may still read its shared memory
  if (nsplit > 1) cluster_sync();
}

// Encode the maps of one launch over E experts (K1: 1): planes as
// [E, K, npk * bytes / 8] 8-byte elements, boxes of stage_rows rows x the
// column tile; scales and mins as [E, pack, K/group, npk / 4], boxes of
// pack x the stage's groups x the column tile. False if refused.
static inline bool gemv_encode(GemvMaps* mp, int kind, int no,
                               const GemvArgs& a, const GemvPlan& p, int E) {
  const int ct = GEMV_CONSUMERS / p.row_groups;
  const cuuint64_t cb = kind == KIND_DENSE ? 2 : 1, pack = kind_pack(kind);
  const cuuint64_t npk = a.npk, K = a.K, G = a.K / a.group, e = E;
  const cuuint64_t dq[3] = {npk * cb / 8, K, e};
  const cuuint64_t sq[2] = {npk * cb, K * npk * cb};
  const cuuint32_t bq[3] = {(cuuint32_t)(ct * gemv_lane_bytes(kind, no) / 8),
                            (cuuint32_t)p.stage_rows, 1};
  bool ok = tensor_map(&mp->q, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3, a.qs, dq,
                       sq, bq, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (kind == KIND_DENSE) {
    mp->s = mp->m = mp->q;
    return ok;
  }
  const cuuint64_t ds[4] = {npk / 4, G, pack, e};
  const cuuint64_t ss[3] = {npk * 2, G * npk * 2, pack * G * npk * 2};
  const cuuint32_t bs[4] = {(cuuint32_t)(ct * gemv_lane_cols(kind, no) / 4),
                            (cuuint32_t)gemv_stage_groups(p.stage_rows,
                                                          a.group),
                            (cuuint32_t)pack, 1};
  return ok &&
         tensor_map(&mp->s, CU_TENSOR_MAP_DATA_TYPE_UINT64, 4, a.scale, ds, ss,
                    bs, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         tensor_map(&mp->m, CU_TENSOR_MAP_DATA_TYPE_UINT64, 4,
                    a.minp ? a.minp : a.scale, ds, ss, bs,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Launch kern(maps, a, p) on grid (splits, col_blocks, tiles) as clusters
// of `splits` CTAs along x, with `smem` bytes of dynamic shared memory,
// after encoding the maps over E experts for `no` outputs a thread. The dynamic-smem attribute is
// set on every launch (a set-once flag would be one object across every
// library the process loads; qmm_tile.cuh).
template <class Kern>
static int gemv_launch(Kern kern, int kind, int no, const GemvArgs& a,
                       const GemvPlan& p, int E, int tiles, int smem,
                       cudaStream_t st) {
  GemvMaps maps;
  if (!gemv_encode(&maps, kind, no, a, p, E))
    return (int)cudaErrorInvalidValue;
  (void)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.col_blocks, tiles);
  cfg.blockDim = dim3(GEMV_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kern, maps, a, p);
  return rc != cudaSuccess ? (int)rc : launch_status();
}
