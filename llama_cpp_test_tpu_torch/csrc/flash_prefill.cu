// K2: causal flash attention of a prefill chunk over the paged KV cache.
//
// Replaces the TPU kernel _fp_kernel (llama_cpp_test_tpu/ops/flash_prefill.py:31,
// launched by flash_prefill). The TPU grid walks pages as its innermost,
// sequential grid axis and carries the online-softmax state (m, l, acc) in
// scratch between steps; blocks on Hopper run in no order, so here one
// block per (sequence, kv head, tile of 64 query rows) carries that state
// in registers through a loop over 64-key tiles, reading each key's page id
// from the block table itself. Semantics are the TPU kernel's: token t
// attends cache index s iff s <= pos[t], s < kv_len and (window == 0 or
// s > pos[t] - window); optional tanh softcap; masked logits are -1e30 and
// the final denominator is clamped at 1e-30. T need not be a multiple of
// 128.
//
// Layout: q/out [B, T, H, D] bf16 (q pre-scaled), pages [KV, NB, BS, D]
// bf16, positions [B, T] int32, kv_len [B] int32, page table [B, NBmax].
//
// What bounds it on an H100: a TinyLlama 512-token prefill is ~1.1 GFLOP
// of products over 2 MB of pages, far too little work to reach the
// tensor-core rate or the memory rate; its time is latency and occupancy.
// Design, as FlashAttention-2 on mma.sync:
//   - rows: the G query heads of a kv head are packed into rows
//     r = t * G + g, as the TPU kernel packs them; a block of 4 warps takes
//     64 rows, each warp 16, so the block reads each K/V tile once for all
//     its heads;
//   - products: mma.sync m16n8k16 bf16 with f32 accumulators. S = Q.K^T
//     stays in registers (exact products of bf16 q and k, f32 sums, as the
//     TPU kernel's f32 dot of bf16-valued inputs); P is rounded to bf16 in
//     registers into the A operand of P.V (V through ldmatrix.trans). That
//     bf16 P is the one rounding the TPU kernel does not make;
//   - key tiles: 64 keys (64 / BS pages; any BS) copied by cp.async 16-byte
//     copies into a ring of 3 stages at D = 64 (2 at D = 80 and 96, where
//     3 would leave two blocks an SM, at 128, where 3 would leave one, and
//     at 256), later tiles in flight while this one is
//     multiplied; shared-memory rows are padded by 16 bytes, so ldmatrix's
//     8 rows fall in distinct banks; keys past kv_len arrive as zeros. The
//     sequence's page ids are staged in shared memory once, beside the
//     copy of Q, so no tile's copy waits on a read of the block table;
//   - D = 80 and 96 (Phi-2, Phi-3) are multiples of 16: 5 or 6 k-steps of
//     S = Q.K^T and 10 or 12 8-column tiles of O, in pairs; a row's D / 8
//     16-byte chunks need no power of two, and rows of D + 8 bf16 (176 or
//     208 bytes) keep ldmatrix's 8 rows in distinct banks;
//   - skipping: only tiles between the block's first attended key (its
//     lowest position less the window) and its last (its highest position,
//     below kv_len) are loaded; only tiles that cross the diagonal, the
//     window's edge or kv_len are masked;
//   - order: the grid's slow axis runs from the last query tile to the
//     first, so the heaviest tiles (late positions) start first;
//   - D = 256 (Gemma): a warp's 16 x 256 slice of O is 128 f32 registers a
//     thread, beside 32 for S. Q's fragments (64 more) would push the
//     thread past 255 and spill, so at D = 256 they are not held: each
//     16-wide k-step of S = Q.K^T reloads its Q fragment from the Q tile,
//     which stays in shared memory for the whole walk (one ldmatrix a
//     k-step, beside the two for K). The Q tile and two 64-key stages fill
//     169 KB: one block an SM;
//   - D = 192 (DeepSeek-V2/V3's MLA: q|k roped at 128 + 64, v zero-padded
//     to 192) takes D = 256's walk: O is 96 f32 registers a thread, and
//     Q's 12 k-steps of fragments (48 more) are reloaded from the Q tile,
//     not held. Rows of 200 bf16 (400 bytes) keep ldmatrix's 8 rows in
//     distinct banks; the Q tile and two 64-key stages fill 129 KB: one
//     block an SM;
//   - D = 100 (BitNet b1.58-3B) is no multiple of 16, nor of 8: a bf16 row
//     is 200 bytes, so a row at any slot is 8-byte aligned and no more.
//     The kernel runs at DP = pad16(D) = 112 in registers and shared
//     memory (7 k-steps, 14 O tiles, rows of 120 bf16), copies each row of
//     Q, K and V by 8-byte cp.async (25 a row) and zero-fills lanes
//     100..111 with the same copies at source size 0, so the padded lanes
//     add exact zeros to Q.K^T and to P.V; O's padded columns are never
//     stored. The pool keeps its [.., 100] rows: no session file, gather
//     or KV byte changes. Where D is a multiple of 8 (every other dim), DP
//     = D and the copies stay 16 bytes.
#include "common.cuh"

namespace {

constexpr int FP_ROWS = 64;      // query rows a block: 4 warps x 16
constexpr int FP_KEYS = 64;      // keys a tile
constexpr int FP_THREADS = 128;
constexpr int FP_PAGES = 1024;   // page ids staged in shared memory

template <int D>
struct FpPlan {
  static constexpr int DP = pad16(D);          // the dim held (D = 100: 112)
  static constexpr int LD = DP + 8;            // bf16 a padded smem row
  static constexpr int TILE = FP_KEYS * LD;    // one K or V tile
  static constexpr int Q = FP_ROWS * LD;
  static constexpr int STAGES = DP == 64 ? 3 : 2;
  // Q's fragments held in registers through the walk (D <= 128), or
  // reloaded from the Q tile at each k-step (D = 192 and 256; at 256
  // holding them spills). Reloading at D = 64/128 took 1.011-1.018x the held time over
  // the kernel rows (tools/attn_rows.py, H100 80GB HBM3 at 700 W).
  static constexpr bool QREG = DP <= 128;
  // Q, the ring of K and V tiles, the page ids
  static constexpr int BYTES = (Q + 2 * STAGES * TILE) * 2 + FP_PAGES * 4;
  // blocks an SM's 227 KB of shared memory holds (3 at D = 64, 80 and
  // 96, 2 at 100 and 128, 1 at 192 and 256);
  // the launch bounds let ptxas take the registers that many leave
  static constexpr int BLOCKS = 232448 / (BYTES + 1024);
};

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 address the rows of matrix i
static __device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                               const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
static __device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                                 const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulate
static __device__ __forceinline__ void mma16816(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A thread's S and O fragments cover rows lane / 4 (h = 0) and lane / 4 + 8
// (h = 1) of its warp's 16, element e of an 8-column fragment at row
// h = e / 2, column 2 * (lane % 4) + e % 2.
template <int D>
__global__ void __launch_bounds__(FP_THREADS, FpPlan<D>::BLOCKS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ kp,
                     const __nv_bfloat16* __restrict__ vp,
                     const int* __restrict__ positions,
                     const int* __restrict__ kv_len,
                     const int* __restrict__ pages,
                     __nv_bfloat16* __restrict__ out, int T, int H, int KV,
                     int NB, int BS, int nbmax, int G, int n_tiles,
                     int window, float soft_cap) {
  using P = FpPlan<D>;
  constexpr int LD = P::LD, DP = P::DP, STAGES = P::STAGES;
  // a row's copies: CB bytes (CE bf16) each, NCH of them over the DP held
  // lanes, the first VCH from the row and the rest zero-filled
  constexpr int CB = copy_bytes(D * 2), CE = CB / 2;
  constexpr int NCH = DP / CE, VCH = D / CE;
  extern __shared__ __align__(128) unsigned char fp_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fp_smem);
  __nv_bfloat16* Ks = Qs + P::Q;                // [STAGES][FP_KEYS][LD]
  __nv_bfloat16* Vs = Ks + STAGES * P::TILE;    // [STAGES][FP_KEYS][LD]
  int* pg_s = reinterpret_cast<int*>(Vs + STAGES * P::TILE);  // [FP_PAGES]
  __shared__ int s_lo, s_hi;                    // the block's token positions

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
  const int r0 = (n_tiles - 1 - (int)blockIdx.y) * FP_ROWS;
  const int rows = T * G, len = kv_len[b];
  const int* pos_b = positions + (size_t)b * T;
  auto q_row = [&](int gr) {  // row gr = t * G + g of q or out
    return ((size_t)b * T + gr / G) * H + kvh * G + gr % G;
  };

  if (tid == 0) {
    s_lo = 0x7fffffff;
    s_hi = -1;
  }
  __syncthreads();
  const int t_first = r0 / G, t_last = (min(r0 + FP_ROWS, rows) - 1) / G;
  for (int t = t_first + tid; t <= t_last; t += FP_THREADS) {
    atomicMin(&s_lo, pos_b[t]);
    atomicMax(&s_hi, pos_b[t]);
  }
  for (int i = tid; i < FP_ROWS * NCH; i += FP_THREADS) {
    const int r = i / NCH, c = i % NCH, gr = r0 + r;
    const bool ok = gr < rows && c < VCH;
    cp_async_n<CB>(Qs + r * LD + c * CE, ok ? q + q_row(gr) * D + c * CE : q,
                   ok);
  }
  const int* pg_b = pages + (size_t)b * nbmax;
  for (int i = tid; i < min(nbmax, FP_PAGES); i += FP_THREADS) pg_s[i] = pg_b[i];
  __syncthreads();
  const int lo_pos = s_lo, hi_pos = s_hi;
  // keys some token of the block attends: [first, last]
  const int first = window > 0 ? max(0, lo_pos - window + 1) : 0;
  const int last = min(hi_pos, len - 1);
  const int tile0 = first / FP_KEYS;
  const int n = last < first ? 0 : last / FP_KEYS + 1 - tile0;

  // keys of tile kt of the sequence -> its ring slot (zeros past kv_len)
  auto load_tile = [&](int kt) {
    __nv_bfloat16* kd = Ks + (kt % STAGES) * P::TILE;
    __nv_bfloat16* vd = Vs + (kt % STAGES) * P::TILE;
    for (int i = tid; i < FP_KEYS * NCH; i += FP_THREADS) {
      const int r = i / NCH, c = i % NCH, s = kt * FP_KEYS + r, pg = s / BS;
      const bool ok = s < len && pg < nbmax && c < VCH;
      size_t off = 0;
      if (ok)
        off = (((size_t)kvh * NB + (pg < FP_PAGES ? pg_s[pg] : pg_b[pg])) *
                   BS + s % BS) * D + c * CE;
      cp_async_n<CB>(kd + r * LD + c * CE, kp + off, ok);
      cp_async_n<CB>(vd + r * LD + c * CE, vp + off, ok);
    }
  };

  // this thread's two rows: position (-1 past the last row: all masked)
  int prow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = r0 + warp * 16 + (lane >> 2) + 8 * h;
    prow[h] = gr < rows ? pos_b[gr / G] : -1;
  }

  float o[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};
  uint32_t qf[P::QREG ? DP / 16 : 1][4];

  // commit groups: Q with tile 0, then one a tile (empty past the last),
  // so group it is complete when at most STAGES - 1 are pending
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n) load_tile(tile0 + j);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    const int s0 = (tile0 + it) * FP_KEYS;
    if (it + STAGES - 1 < n) load_tile(tile0 + it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const __nv_bfloat16* q_frag = Qs + (warp * 16 + (lane & 15)) * LD +
                                  (lane >> 4) * 8;
    if constexpr (P::QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) ldsm_x4(qf[kk], q_frag + kk * 16);
      }
    }
    const __nv_bfloat16* kt = Ks + ((tile0 + it) % STAGES) * P::TILE;
    const __nv_bfloat16* vt = Vs + ((tile0 + it) % STAGES) * P::TILE;

    // S = Q . K^T: 16 rows x 64 keys a warp
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (P::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldsm_x4(qa, q_frag + kk * 16);
      }
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        (2 * kk + ((lane >> 3) & 1)) * 8);
        mma16816(sc[j], qa, kb[0], kb[1]);
        mma16816(sc[j + 1], qa, kb[2], kb[3]);
      }
    }

    // the mask, only on tiles that cross the diagonal, the window's edge
    // or kv_len (the same for the whole block)
    const bool masked = !(s0 + FP_KEYS - 1 <= lo_pos &&
                          s0 + FP_KEYS - 1 < len &&
                          (window == 0 || s0 > hi_pos - window));
    auto attends = [&](int j, int e) {
      const int s = s0 + 8 * j + 2 * (lane & 3) + (e & 1), p = prow[e >> 1];
      return s <= p && s < len && (window == 0 || s > p - window);
    };
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = sc[j][e];
        if (soft_cap > 0.f) v = tanhf(v / soft_cap) * soft_cap;
        if (masked && !attends(j, e)) v = -1e30f;
        sc[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    // exp(v - m) as exp2(v log2 e - m log2 e): one fma and one ex2
    constexpr float L2E = 1.4426950408889634f;
    float alpha[2], mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f((m_r[h] - mx[h]) * L2E);
      m_r[h] = mx[h];
      mb[h] = -mx[h] * L2E;
      l_r[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = masked && !attends(j, e)
                            ? 0.f : exp2f(fmaf(sc[j][e], L2E, mb[e >> 1]));
        l_r[e >> 1] += p;
        sc[j][e] = p;
      }

    // O += P . V: P's accumulator fragments are the A fragments of P . V
#pragma unroll
    for (int kk = 0; kk < FP_KEYS / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DP / 8; j += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vt + (16 * kk + (lane & 15)) * LD + (j + (lane >> 4)) * 8);
        mma16816(o[j], pa, vb[0], vb[1]);
        mma16816(o[j + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the slot is refilled by a later iteration's load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int gr = r0 + warp * 16 + (lane >> 2) + 8 * h;
    if (gr >= rows) continue;
    __nv_bfloat16* op = out + q_row(gr) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (DP == D || 8 * j + 2 * (lane & 3) < D)   // no padded column
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
            __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* positions,
           const void* kv_len, const void* pages, void* out, int B, int T,
           int H, int KV, int NB, int BS, int nbmax, int window,
           float soft_cap, cudaStream_t st) {
  const int G = H / KV, n_tiles = (T * G + FP_ROWS - 1) / FP_ROWS;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  auto kern = flash_prefill_kernel<D>;
  // a refused attribute leaves the launch to fail, and launch_status() to
  // report it
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, FpPlan<D>::BYTES);
  (void)attr;
  const dim3 grid(KV * B, n_tiles);
  kern<<<grid, FP_THREADS, FpPlan<D>::BYTES, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)positions, (const int*)kv_len,
      (const int*)pages, (__nv_bfloat16*)out, T, H, KV, NB, BS, nbmax, G,
      n_tiles, window, soft_cap);
  return launch_status();
}

}  // namespace

// D in {64, 80, 96, 100, 128, 192, 256}; BS a multiple of 8, at most 64; any T
// and any G = H / KV.
PORT_API int flash_prefill(const void* q, const void* k, const void* v,
                           const void* positions, const void* kv_len,
                           const void* pages, void* out, int B, int T, int H,
                           int KV, int NB, int BS, int D, int nbmax,
                           int window, float soft_cap, void* stream) {
  if (B < 1 || T < 1 || KV <= 0 || H % KV || BS % 8 || BS > 64)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, positions, kv_len, pages, out, B, T, H, KV,
                        NB, BS, nbmax, window, soft_cap, st);
    case 80:
      return launch<80>(q, k, v, positions, kv_len, pages, out, B, T, H, KV,
                        NB, BS, nbmax, window, soft_cap, st);
    case 96:
      return launch<96>(q, k, v, positions, kv_len, pages, out, B, T, H, KV,
                        NB, BS, nbmax, window, soft_cap, st);
    case 100:
      return launch<100>(q, k, v, positions, kv_len, pages, out, B, T, H, KV,
                         NB, BS, nbmax, window, soft_cap, st);
    case 128:
      return launch<128>(q, k, v, positions, kv_len, pages, out, B, T, H, KV,
                         NB, BS, nbmax, window, soft_cap, st);
    case 192:
      return launch<192>(q, k, v, positions, kv_len, pages, out, B, T, H, KV,
                         NB, BS, nbmax, window, soft_cap, st);
    case 256:
      return launch<256>(q, k, v, positions, kv_len, pages, out, B, T, H, KV,
                         NB, BS, nbmax, window, soft_cap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
