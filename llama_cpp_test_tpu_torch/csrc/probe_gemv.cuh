// The M = 8 dequant GEMV shared by the decode probes of tools/kbench.py
// (kernel_f, kernel_g, kernel_h; csrc/kbench.cu) and tools/pairprobe.py
// (_pairs_kernel; csrc/pairprobe.cu): y[8, N] = x[8, K] . w[K, N] with
//   w = bf16(bf16(q) * s[k / 32, n])   (q exact in bf16, one rounding)
// and f32 accumulation, over four byte layouts of the 4- and 8-bit q:
//   FMT_F      N-paired nibbles: byte (k, j) holds column j (low nibble) and
//              column j + N/2 (high); s [2, K/32, N/2]; y [8, 2, N/2]
//   FMT_G      signed int4 q - 8, two a byte: byte (k, j) holds column 2j
//              (low nibble) and 2j + 1 (high), each a 4-bit two's
//              complement; s [K/32, N]; y [8, N]
//   FMT_H      int8: byte (k, n); s [K/32, N]; y [8, N]
//   FMT_PAIRS  K-paired nibbles: byte (r, n) holds K-rows 2r (low nibble)
//              and 2r + 1 (high), q = 128 + nibble; s [K/32, N] and an f32
//              fold [K/32, N]: y = x . w - (per-group x-sums) . fold
//
// What bounds them on an H100: bytes (8 rows do 16 flops a weight, far
// below the 295 a byte the card needs to be compute-bound). The body is the
// shape of qmm_gemv.cuh's GEMV, at 8 rows on the tensor cores:
//   - Warp 4 of a 160-thread block is the producer: for each stage of
//     `stage_rows` K rows, one TMA box a 128 bytes of the block's plane
//     tile (128B-swizzled; a 64-byte tile 64B-swizzled), one of the scale
//     rows of the stage's groups and, for the pairs, one of its f32 fold
//     rows, all on the stage's mbarrier; `stages` stages in flight.
//   - x is staged in shared memory once a block, by one bulk copy a row
//     that the producer issues ahead of the first stage (rows padded by 32
//     bytes, so the lanes of a B-fragment load hit distinct banks), with
//     the per-group x-sums the pairs' fold needs.
//   - Warps 0-3 run mma.sync m16n8k16, the weight as A (16 columns x 16 K
//     rows) and x's 8 rows as B's n8, so no row of the tile is wasted. An
//     A register is a pair of exact bf16 codes times the bf16 pair (s, s)
//     by one __hmul2: the product of two bf16 values is exact in f32, so
//     its one rounding is bf16(q * s), as the TPU kernels round it. With
//     the scale inside A, C runs over the whole split with no per-group
//     flush; the pairs subtract x-sums . fold per group in f32.
//   - A lane reads 8 or 16 plane bytes of the K rows its MMA slots hold;
//     with the swizzle, the lanes of one load hit distinct banks.
//   - K is split across a thread-block cluster of at most 8 CTAs (grid x):
//     CTA rank q owns a slice of the outputs. Each CTA sums its row groups'
//     partial sums in its own shared memory, then stores each slice into
//     its owner's shared memory, 16 bytes a store (distributed shared
//     memory, no round trip); after one cluster barrier q sums its slice
//     over the CTAs in a fixed order and stores each output once. One
//     launch, no memset, no atomics: two calls give the same bits.
// The launch plan (column tile, splits, rows a split, stage rows, stages)
// comes from tools.probe_plan; probe_plan_ok checks it and the kernel takes
// any plan it accepts.
#pragma once

#include "qmm_gemv.cuh"

constexpr int FMT_F = 0, FMT_G = 1, FMT_H = 2, FMT_PAIRS = 3;
constexpr int PROBE_M = 8, PROBE_GROUP = 32;
constexpr int PROBE_CONSUMERS = 128;                 // warps 0-3
constexpr int PROBE_THREADS = PROBE_CONSUMERS + 32;  // + the producer warp
constexpr int PROBE_SMEM_MAX = 232448;  // shared memory one block may hold

// K rows a plane byte row holds; output columns a byte column feeds
__host__ __device__ constexpr int probe_kpb(int fmt) {
  return fmt == FMT_PAIRS ? 2 : 1;
}
__host__ __device__ constexpr int probe_vals(int fmt) {
  return fmt == FMT_F || fmt == FMT_G ? 2 : 1;
}
// Plane bytes a lane reads a row: 16 for the pairs on tiles of 128 bytes
// or wider, else 8 (a lane holds 16 outputs a row of F and G, 8 of H and
// of the pairs on a 64-byte tile). A warp takes 8 lanes' bytes of a row.
__host__ __device__ constexpr int probe_lane_bytes(int fmt, int tile) {
  return fmt == FMT_PAIRS && tile >= 128 ? 16 : 8;
}
// blocks an SM the kernel is built to hold (registers), as the plan aims
constexpr int PROBE_BLOCKS_PER_SM = 3;

// The launch plan (tools.probe_plan): `tile` plane bytes a block takes of
// a row (col_blocks = nbc / tile of them), K split into `splits` ranges of
// rows_per_split rows (one cluster), stages of stage_rows K rows.
struct ProbePlan {
  int col_blocks, tile, splits, rows_per_split, stage_rows, stages;
};

// x [8, K] bf16; qs [K / kpb, nbc] bytes; sc bf16 and fold f32 as in the
// header; out f32.
struct ProbeArgs {
  const __nv_bfloat16* x; int K; const void* qs; int nbc;
  const __nv_bfloat16* sc; const float* fold; float* out;
};

struct ProbeMaps {
  CUtensorMap q, s, f;
};

// Byte offsets of a block's dynamic shared memory (from a 1024-aligned
// base): the stage ring (the row groups' partial sums once drained), the
// partial sums the cluster's CTAs store (`recv`: `slice` floats from each),
// staged x (row m at x + m * xpitch), the pairs' x-sums, the mbarriers;
// `total` adds the alignment slack.
struct ProbeSmem {
  int box, plane, scale, stage, recv, slice, x, xpitch, xsum, bars, total;
};

__host__ __device__ inline ProbeSmem probe_smem(int fmt, const ProbePlan& p) {
  auto up = [](int b, int a) { return (b + a - 1) / a * a; };
  const int kt = p.stage_rows, gps = kt / PROBE_GROUP;
  const int outs = p.tile * probe_vals(fmt);
  const int cw = p.tile / (8 * probe_lane_bytes(fmt, p.tile));
  ProbeSmem s;
  s.box = kt / probe_kpb(fmt) * (p.tile < 128 ? p.tile : 128);
  s.plane = up(kt / probe_kpb(fmt) * p.tile, 1024);
  s.scale = up(gps * outs * 2, 128);
  const int fold = fmt == FMT_PAIRS ? up(gps * p.tile * 4, 128) : 0;
  s.stage = up(s.plane + s.scale + fold, 1024);
  const int red = 4 / cw * PROBE_M * outs * 4;
  s.recv = up(p.stages * s.stage > red ? p.stages * s.stage : red, 128);
  s.slice = up((PROBE_M * outs + p.splits - 1) / p.splits, 4);
  s.x = s.recv + up(p.splits * s.slice * 4, 128);
  s.xpitch = p.rows_per_split * 2 + 32;
  s.xsum = s.x + up(PROBE_M * s.xpitch, 128);
  s.bars = s.xsum + (fmt == FMT_PAIRS
                         ? up(PROBE_M * (p.rows_per_split / PROBE_GROUP) * 4, 16)
                         : 0);
  s.total = s.bars + (2 * p.stages + 1) * 8 + 1024;
  return s;
}

// Whether the kernel takes plan p: a power-of-two tile of 64-512 bytes
// dividing nbc that 1, 2 or 4 warps span, stages of whole groups within a
// 256-row TMA box, splits of whole stages covering K with none empty, at
// most 8 of them, and the shared memory one block may hold.
__host__ inline bool probe_plan_ok(int fmt, int K, int nbc, const ProbePlan& p) {
  const int kt = p.stage_rows;
  if (K <= 0 || K % PROBE_GROUP || nbc <= 0) return false;
  const int cw = p.tile / (8 * probe_lane_bytes(fmt, p.tile));
  if (p.tile < 64 || p.tile > 512 || (p.tile & (p.tile - 1)) || nbc % p.tile ||
      p.col_blocks != nbc / p.tile || cw > 4)
    return false;
  if (kt <= 0 || kt % PROBE_GROUP || kt / probe_kpb(fmt) > 256) return false;
  if (p.splits < 1 || p.splits > GEMV_MAX_SPLITS || p.rows_per_split <= 0 ||
      p.rows_per_split % kt || (long)p.splits * p.rows_per_split < K ||
      (long)(p.splits - 1) * p.rows_per_split >= K)
    return false;
  return p.stages >= 1 && p.stages <= 16 &&
         probe_smem(fmt, p).total <= PROBE_SMEM_MAX;
}

// ---------------------------------------------------------------------------
// A operands: bf16 pairs (first K row low), exact before the scale

// G: the signed nibbles H of bytes 0 and 2 of p, as bf16 128 + (q + 8)
// (q + 8 = nibble ^ 8), less 136
template <int H>
static __device__ __forceinline__ uint32_t int4_pair(uint32_t p) {
  uint32_t v = (((p >> (4 * H)) & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// H: byte B of w0 and of w1 (each already ^ 0x80808080) as int8 values
template <int B>
static __device__ __forceinline__ uint32_t int8_pair(uint32_t w0, uint32_t w1) {
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(byte_magic<B>(w0) - (8388608.f + 128.f),
                            byte_magic<B>(w1) - (8388608.f + 128.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// PAIRS: byte B of w (w4 = w >> 4) as bf16 (128 + low nibble, 128 + high
// nibble), the TPU kernel's bits (b & 0xF) | (b & 0xF0) << 12 | 0x43004300
template <int B>
static __device__ __forceinline__ uint32_t nibble_pair(uint32_t w, uint32_t w4) {
  return (__byte_perm(w, w4, B | ((B + 4) << 8)) & 0x000F000Fu) | 0x43004300u;
}

// the bf16 pair a * s, each half rounded once
static __device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t s) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                   *reinterpret_cast<__nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Byte o (a multiple of 8) of row `row` of a plane box `bw` bytes wide, as
// the TMA swizzled it: 16-byte chunk c of row r at chunk c ^ (r % 8) (128B)
// or c ^ (r / 2 % 4) (64B).
static __device__ __forceinline__ const uint8_t* swz(const uint8_t* box,
                                                     int row, int o, int bw) {
  const int a = row * bw + o;
  return box + (a ^ (((a >> 7) & (bw / 16 - 1)) << 4));
}

// `bytes` (a multiple of 16) from global src into shared dst by one bulk
// copy, counted on mbarrier bar
static __device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                                 int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// v into the 16 bytes at a cluster shared address
static __device__ __forceinline__ void st_cluster4(uint32_t remote, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// N bytes at shared address p as words (N = 8 or 16)
template <int N>
static __device__ __forceinline__ void lds_words(const uint8_t* p,
                                                 uint32_t (&w)[N / 4]) {
  if constexpr (N == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  }
}

// ---------------------------------------------------------------------------
// The kernel: grid (splits, col_blocks), clusters of `splits` CTAs along x.
//
// Warp w of the consumers takes the 8 * LB plane bytes at (w % cw) * 8 * LB
// of the tile (cw = tile / (8 * LB) column warps) in the groups gi of each
// stage with gi % rg == w / cw (rg = 4 / cw row groups); every consumer
// warp reads every stage, so the ring's stages are all in flight for all
// of them. Lane (g, t) holds SLOTS
// outputs a row: its MMA tiles T (NT = SLOTS / 2 of them) put output slot
// 2T in A row g and slot 2T + 1 in A row g + 8, and the lane's D holds
// both slots at x rows 2t and 2t + 1. Slot i is, of the lane's first byte
// column c = (w % cw) * 8 * LB + LB * g: for F, sub-value i % 2 of byte
// column c + i / 2 (tile output (i % 2) * tile + c + i / 2); for G, output
// 2c + i; for H and the pairs, byte column c + i. The MMA's K slots 2t,
// 2t + 1, 2t + 8, 2t + 9 are K rows 2t, 2t + 1, 2t + 8, 2t + 9 of the step
// (rows 4t .. 4t + 3 for the pairs: the lane's byte rows 2t and 2t + 1).
template <int FMT, int LB>
__global__ void __launch_bounds__(PROBE_THREADS, PROBE_BLOCKS_PER_SM)
probe_gemv_kernel(const __grid_constant__ ProbeMaps maps, const ProbeArgs a,
                  const ProbePlan p) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  constexpr int KPB = probe_kpb(FMT), V = probe_vals(FMT);
  constexpr int SLOTS = LB * V, NT = SLOTS / 2, NW = LB / 4;
  constexpr int ROWS = 4 / KPB;  // plane rows a lane reads a step
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const ProbeSmem L = probe_smem(FMT, p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, bx = blockIdx.y;
  const int tile = p.tile, bw = tile < 128 ? tile : 128;
  const int cw = tile / (8 * LB), rg = 4 / cw;
  const int outs = tile * V, kt = p.stage_rows, gps = kt / PROBE_GROUP;
  const int stages = p.stages;
  const int k_begin = split * p.rows_per_split;
  const int k_rows = min(a.K, k_begin + p.rows_per_split) - k_begin;
  const int nstage = (k_rows + kt - 1) / kt;
  const int gpr = p.rows_per_split / PROBE_GROUP;  // x-sum slots a row
  const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * stages;
  const uint32_t xbar = empty + 8 * stages;  // staged x
  const float* xsum = reinterpret_cast<const float*>(smem + L.xsum);
  const bool producer = tid == PROBE_CONSUMERS;

  if (producer) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.q) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.s) : "memory");
    if constexpr (FMT == FMT_PAIRS)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.f) : "memory");
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, PROBE_CONSUMERS / 32);
    }
    mbar_init(xbar, 1);
    fence_proxy_async();
  }
  __syncthreads();  // the barriers are ready
  // this CTA has started (the cluster barrier's first phase, waited for
  // before any CTA stores into another's shared memory)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int cs = warp % cw, rr = warp / cw;
  const int c0 = cs * 8 * LB + LB * g;  // the lane's first byte column

  if (tid >= PROBE_CONSUMERS) {
    // producer: each stage once its slot is free
    if (producer) {
      // x first: the split's rows of each of the 8 rows
      mbar_expect_tx(xbar, PROBE_M * k_rows * 2);
      for (int m = 0; m < PROBE_M; ++m)
        bulk_load(smem_u32(smem + L.x + m * L.xpitch),
                  a.x + (size_t)m * a.K + k_begin, k_rows * 2, xbar);
      const uint32_t tx = kt / KPB * tile + gps * outs * 2 +
                          (FMT == FMT_PAIRS ? gps * tile * 4 : 0);
      for (int s = 0; s < nstage; ++s) {
        const int slot = s % stages, k0 = k_begin + s * kt;
        if (s >= stages)
          mbar_wait(empty + 8 * slot, ((s / stages) - 1) & 1);
        const uint32_t st = smem_u32(smem + slot * L.stage), bar = full + 8 * slot;
        mbar_expect_tx(bar, tx);
        for (int b = 0; b < tile / bw; ++b)
          tma_load_2d(st + b * L.box, &maps.q, bar, bx * tile + b * bw, k0 / KPB);
        if constexpr (FMT == FMT_F)
          tma_load_3d(st + L.plane, &maps.s, bar, bx * tile / 4,
                      k0 / PROBE_GROUP, 0);
        else
          tma_load_2d(st + L.plane, &maps.s, bar, bx * outs / 4,
                      k0 / PROBE_GROUP);
        if constexpr (FMT == FMT_PAIRS)
          tma_load_2d(st + L.plane + L.scale, &maps.f, bar, bx * tile / 2,
                      k0 / PROBE_GROUP);
      }
    }
  } else {
    mbar_wait(xbar, 0);
    if constexpr (FMT == FMT_PAIRS) {
      // the x-sum of each group and row, in K order
      float* xs_out = reinterpret_cast<float*>(smem + L.xsum);
      for (int i = tid; i < k_rows / PROBE_GROUP * PROBE_M; i += PROBE_CONSUMERS) {
        const int gl = i / PROBE_M, m = i % PROBE_M;
        const __nv_bfloat16* xr = reinterpret_cast<const __nv_bfloat16*>(
            smem + L.x + m * L.xpitch) + PROBE_GROUP * gl;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < PROBE_GROUP; j += 8) {
          float v[8];
          smem_bf16<8>(xr + j, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += v[e];
        }
        xs_out[m * gpr + gl] = sum;
      }
      consumer_sync();
    }
    // lane (g, t)'s B fragments: x row g at K rows 2t, 2t + 1, 2t + 8,
    // 2t + 9 of each step (4t .. 4t + 3 for the pairs)
    const uint8_t* xrow = smem + L.x + g * L.xpitch +
                          (FMT == FMT_PAIRS ? 8 * t : 4 * t);
    const int box = c0 / bw, bo = c0 % bw;
    for (int s = 0; s < nstage; ++s) {
      const int slot = s % stages;
      mbar_wait(full + 8 * slot, (s / stages) & 1);
      const uint8_t* st = smem + slot * L.stage;
      const uint8_t* pl = st + box * L.box;
      const __nv_bfloat16* scs =
          reinterpret_cast<const __nv_bfloat16*>(st + L.plane);
      const int ng = min(kt, k_rows - s * kt) / PROBE_GROUP;
      for (int gi = rr; gi < ng; gi += rg) {
        // the group's scales of the lane's slots, as (s, s) pairs
        uint32_t s2[SLOTS];
        if constexpr (FMT == FMT_F) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4 u = *reinterpret_cast<const uint4*>(
                scs + (h * gps + gi) * tile + c0);
            const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int b = 0; b < 8; ++b)
              s2[2 * b + h] = __byte_perm(w[b / 2], 0, b % 2 ? 0x3232 : 0x1010);
          }
        } else {
          uint32_t v[SLOTS / 2];
#pragma unroll
          for (int i = 0; i < SLOTS / 8; ++i) {
            const uint4 u = *reinterpret_cast<const uint4*>(
                scs + gi * outs + V * c0 + 8 * i);
            v[4 * i] = u.x; v[4 * i + 1] = u.y;
            v[4 * i + 2] = u.z; v[4 * i + 3] = u.w;
          }
#pragma unroll
          for (int i = 0; i < SLOTS; ++i)
            s2[i] = __byte_perm(v[i / 2], 0, i % 2 ? 0x3232 : 0x1010);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the group's two 16-row steps
          const int kk = gi * PROBE_GROUP + 16 * h;  // stage-local K row
          const uint8_t* xp = xrow + 2 * (s * kt + kk);
          uint2 b;
          if constexpr (FMT == FMT_PAIRS) {
            b = *reinterpret_cast<const uint2*>(xp);
          } else {
            b.x = *reinterpret_cast<const uint32_t*>(xp);
            b.y = *reinterpret_cast<const uint32_t*>(xp + 16);
          }
          uint32_t w[ROWS][NW];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const int row = FMT == FMT_PAIRS ? kk / 2 + 2 * t + i
                                             : kk + 2 * t + (i & 1) + 8 * (i >> 1);
            lds_words<LB>(swz(pl, row, bo, bw), w[i]);
          }
          for_consts([&](auto tile_c) {
            constexpr int T = decltype(tile_c)::value;
            uint32_t a0, a1, a2, a3;
            if constexpr (FMT == FMT_F || FMT == FMT_G) {
              constexpr int Q = T / 4, B = T % 4;
              const uint32_t p01 = pair_bytes<B>(w[0][Q], w[1][Q]);
              const uint32_t p23 = pair_bytes<B>(w[2][Q], w[3][Q]);
              if constexpr (FMT == FMT_F) {
                a0 = code_pair<1, 0>(p01, nullptr, nullptr);
                a1 = code_pair<1, 1>(p01, nullptr, nullptr);
                a2 = code_pair<1, 0>(p23, nullptr, nullptr);
                a3 = code_pair<1, 1>(p23, nullptr, nullptr);
              } else {
                a0 = int4_pair<0>(p01);
                a1 = int4_pair<1>(p01);
                a2 = int4_pair<0>(p23);
                a3 = int4_pair<1>(p23);
              }
            } else if constexpr (FMT == FMT_H) {
              constexpr int Q = T / 2, B = 2 * (T % 2);
              const uint32_t u0 = w[0][Q] ^ 0x80808080u, u1 = w[1][Q] ^ 0x80808080u;
              const uint32_t u2 = w[2][Q] ^ 0x80808080u, u3 = w[3][Q] ^ 0x80808080u;
              a0 = int8_pair<B>(u0, u1);
              a1 = int8_pair<B + 1>(u0, u1);
              a2 = int8_pair<B>(u2, u3);
              a3 = int8_pair<B + 1>(u2, u3);
            } else {
              constexpr int Q = T / 2, B = 2 * (T % 2);
              const uint32_t w0 = w[0][Q], w1 = w[1][Q];
              a0 = nibble_pair<B>(w0, w0 >> 4);
              a1 = nibble_pair<B + 1>(w0, w0 >> 4);
              a2 = nibble_pair<B>(w1, w1 >> 4);
              a3 = nibble_pair<B + 1>(w1, w1 >> 4);
            }
            gemv_mma(acc[T], mul_bf16x2(a0, s2[2 * T]),
                     mul_bf16x2(a1, s2[2 * T + 1]), mul_bf16x2(a2, s2[2 * T]),
                     mul_bf16x2(a3, s2[2 * T + 1]), b.x, b.y);
          }, std::make_integer_sequence<int, NT>{});
        }
        if constexpr (FMT == FMT_PAIRS) {
          // - x-sums . fold for the group, in f32
          const float* fp = reinterpret_cast<const float*>(
                                st + L.plane + L.scale) + gi * tile + c0;
          float f[SLOTS];
#pragma unroll
          for (int i = 0; i < SLOTS / 4; ++i) {
            const float4 u = *reinterpret_cast<const float4*>(fp + 4 * i);
            f[4 * i] = u.x; f[4 * i + 1] = u.y; f[4 * i + 2] = u.z; f[4 * i + 3] = u.w;
          }
          const int gl = (s * kt) / PROBE_GROUP + gi;
          const float x0 = xsum[2 * t * gpr + gl], x1 = xsum[(2 * t + 1) * gpr + gl];
#pragma unroll
          for (int T = 0; T < NT; ++T) {
            acc[T][0] = fmaf(-x0, f[2 * T], acc[T][0]);
            acc[T][1] = fmaf(-x1, f[2 * T], acc[T][1]);
            acc[T][2] = fmaf(-x0, f[2 * T + 1], acc[T][2]);
            acc[T][3] = fmaf(-x1, f[2 * T + 1], acc[T][3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    }
  }
  __syncthreads();  // every stage consumed: the ring may hold the sums
  // partial sums red[row group][m][tile output]
  float* red = reinterpret_cast<float*>(smem);
  if (tid < PROBE_CONSUMERS) {
#pragma unroll
    for (int T = 0; T < NT; ++T)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = 2 * T + (i >> 1), m = 2 * t + (i & 1);
        const int o = FMT == FMT_F ? (slot % 2) * tile + c0 + slot / 2
                                   : V * c0 + slot;
        red[(rr * PROBE_M + m) * outs + o] = acc[T][i];
      }
  }
  __syncthreads();
  // every CTA of the cluster has started: four outputs a store, summed
  // over the row groups, into the owner's recv[split * slice + i] (flat
  // output m * outs + o = owner * slice + i)
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int total = PROBE_M * outs;
  const uint32_t recv = smem_u32(smem + L.recv);
  for (int j = 4 * tid; j < total; j += 4 * PROBE_THREADS) {
    float4 v = *reinterpret_cast<const float4*>(red + j);
    for (int r = 1; r < rg; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(red + r * total + j);
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    const int q = j / L.slice;
    st_cluster4(cluster_addr(recv + 4 * (split * L.slice + j - q * L.slice), q),
                v);
  }
  cluster_sync();
  // this CTA's slice, over the CTAs in a fixed order
  const float* got = reinterpret_cast<const float*>(smem + L.recv);
  for (int i = tid; i < L.slice; i += PROBE_THREADS) {
    const int idx = split * L.slice + i;
    if (idx >= total) break;
    float v = 0.f;
    for (int q = 0; q < p.splits; ++q) v += got[q * L.slice + i];
    const int m = idx / outs, o = idx % outs;
    size_t dst;
    if constexpr (FMT == FMT_F)
      dst = ((size_t)m * 2 + o / tile) * a.nbc + (size_t)bx * tile + o % tile;
    else
      dst = (size_t)m * V * a.nbc + (size_t)bx * outs + o;
    a.out[dst] = v;
  }
}

// Encode the maps and launch plan p (probe_plan_ok has accepted it) on
// stream st. Returns the launch's error code.
template <int FMT, int LB>
static int launch_probe(const ProbeArgs& a, const ProbePlan& p,
                        cudaStream_t st) {
  constexpr int KPB = probe_kpb(FMT), V = probe_vals(FMT);
  const int bw = p.tile < 128 ? p.tile : 128;
  const cuuint64_t nbc = a.nbc, G = a.K / PROBE_GROUP;
  const cuuint32_t gps = p.stage_rows / PROBE_GROUP, tile = p.tile;
  ProbeMaps maps;
  const cuuint64_t dq[2] = {nbc, (cuuint64_t)(a.K / KPB)}, sq[1] = {nbc};
  const cuuint32_t bq[2] = {(cuuint32_t)bw, (cuuint32_t)(p.stage_rows / KPB)};
  bool ok = tensor_map(&maps.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a.qs, dq, sq,
                       bq, bw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B);
  // scales and fold as 8-byte elements
  if constexpr (FMT == FMT_F) {
    const cuuint64_t ds[3] = {nbc / 4, G, 2}, ss[2] = {nbc * 2, G * nbc * 2};
    const cuuint32_t bs[3] = {tile / 4, gps, 2};
    ok = ok && tensor_map(&maps.s, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3, a.sc, ds,
                          ss, bs, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    const cuuint64_t ds[2] = {nbc * V / 4, G}, ss[1] = {nbc * V * 2};
    const cuuint32_t bs[2] = {tile * V / 4, gps};
    ok = ok && tensor_map(&maps.s, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, a.sc, ds,
                          ss, bs, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if constexpr (FMT == FMT_PAIRS) {
    const cuuint64_t df[2] = {nbc / 2, G}, sf[1] = {nbc * 4};
    const cuuint32_t bf[2] = {tile / 2, gps};
    ok = ok && tensor_map(&maps.f, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, a.fold,
                          df, sf, bf, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    maps.f = maps.s;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const int smem = probe_smem(FMT, p).total;
  auto kern = probe_gemv_kernel<FMT, LB>;
  // all of the SM's 228 KB as shared memory, so that the plan's blocks an
  // SM fit beside each other
  (void)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  (void)cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.col_blocks);
  cfg.blockDim = dim3(PROBE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kern, maps, a, p);
  return rc != cudaSuccess ? (int)rc : launch_status();
}

// Check plan p and launch the format's kernel: 8 plane bytes a lane, or
// for the pairs 16 on tiles of 128 bytes or wider.
template <int FMT>
static int run_probe(const ProbeArgs& a, const ProbePlan& p, void* stream) {
  if (!probe_plan_ok(FMT, a.K, a.nbc, p)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (FMT != FMT_PAIRS)
    return launch_probe<FMT, 8>(a, p, st);
  else
    return p.tile >= 128 ? launch_probe<FMT, 16>(a, p, st)
                         : launch_probe<FMT, 8>(a, p, st);
}
