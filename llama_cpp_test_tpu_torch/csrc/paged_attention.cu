// K3: paged flash-decoding, one query token per sequence, over bf16 pages
// (paged_decode) or q8_0 pages (paged_decode_q8).
//
// Replaces the TPU kernel _pa_kernel (llama_cpp_test_tpu/ops/paged_attention.py:50,
// launched by paged_attention_decode), both its bf16 branch and its
// quantized=True branch. The TPU kernel walks a sequence's pages P at a
// time along a sequential grid axis, all kv heads per step, carrying
// (m, l, acc) in scratch. Blocks on Hopper run in parallel and in no
// order, so here the walk is split across blocks (flash-decoding): block
// (row group of a kv head, sequence, split) takes a contiguous range of
// split_pages of the sequence's pages for up to 16 of the G query heads of
// that kv head, and leaves its partial (m, l, acc[G, D]) in f32 in a
// workspace; a second kernel merges a sequence's partials. The host picks
// the split count from the block table's width, B * KV and the SM count;
// no length is read back: a split that starts past its sequence's length
// writes l = 0 and exits. With one split the first kernel writes the
// output itself. Page ids come from the block table; only keys below the
// sequence length are read. Masked logits are -1e30 (softcap first) and
// the final denominator is clamped at 1e-30, as on the TPU.
//
// Layout: q/out [B, H, D] bf16 (q pre-scaled), pages [KV, NB, BS, D] bf16,
// or int8 with f32 per-slot scales [KV, NB, BS] (a key or value row is
// bf16(q * scale), as gather_kv_q8 and the TPU kernel's in-flight tile
// dequantize it), lengths [B] int32, page table [B, NBmax] int32.
//
// What bounds it on an H100: 2 bytes (bf16) or 1 byte + a 4-byte scale per
// row (q8) per K/V element for ~2 flops per element per query head, so it
// is bound by bytes; the q8 pages halve them. A decode step reads a few
// MB, so what keeps it from that bound is latency and how many SMs it
// fills: one block per (sequence, kv head) filled 4 of 132 SMs for one
// TinyLlama sequence. The split fills the card (at least two blocks an SM)
// and keeps each block's walk short (ranges of one or two 64-key tiles,
// both in flight at once, where 64 ranges allow). Inside a block, as K2
// (flash_prefill.cu) on mma.sync:
//   - rows: the block's query heads are the 16 rows of an m16n8k16 A
//     operand, rows past G zero; a kv head with G > 16 takes more row
//     groups (grid x), each reading the keys again;
//   - tiles: the split's page ids are staged in shared memory first, then
//     tiles of 64 keys and their values are copied into a ring of two
//     stages by cp.async, the next tile in flight while this one is
//     multiplied, so each row is read from HBM once for all the block's
//     heads; q8 tiles (and their slot scales) land as int8 and are
//     dequantized into one bf16 K and V tile before the products;
//   - products: warp w takes keys 16w..16w+15 of every tile, its own
//     online softmax over them: S = Q.K^T on mma.sync with f32
//     accumulators (exact products of bf16 values, f32 sums), P rounded to
//     bf16 into the A operand of P.V (V through ldmatrix.trans), the one
//     rounding the TPU kernel does not make;
//   - the four warps' states merge through shared memory at the end;
//   - Q's fragments are not held in registers but reloaded from the Q
//     rows, which stay in shared memory, at each 16-wide k-step of
//     S = Q.K^T: at D = 256 (Gemma) O's 16 x 256 accumulators alone are
//     128 f32 registers a thread, and at D = 64/128 holding them was no
//     faster (the reload took 0.97-1.00x the held time over the kernel
//     rows, tools/attn_rows.py, H100 80GB HBM3 at 700 W). At D = 256 a
//     bf16 stage is two 33 KB tiles (135 KB for the ring), a q8 ring 69 KB
//     beside 66 KB of dequantized tiles: one block an SM.
// D = 192 (DeepSeek-V2/V3's MLA) takes the same walk at 12 k-steps and
// 24 O tiles (96 f32 accumulators a thread); MLA has as many KV heads as
// query heads (G = 1), so 15 of the block's 16 mma rows are padding, as
// at Falcon's one KV head. A bf16 stage is two 25 KB tiles (100 KB for
// the ring), a q8 ring 53 KB beside 50 KB of dequantized tiles: two
// blocks an SM.
// D = 80 and 96 (Phi-2, Phi-3) take the same walk: 5 or 6 k-steps, 10 or
// 12 O tiles in pairs, 10 or 12 16-byte chunks a bf16 row and 5 or 6 an
// int8 one (rows of 96 or 112 bytes staged), no power of two assumed.
// D = 100 (BitNet b1.58-3B) is no multiple of 8: its rows (200 bytes in
// bf16, 100 in int8) are 8- and 4-byte aligned only. The block holds
// DP = pad16(D) = 112 lanes in shared memory and registers (7 k-steps, 14
// O tiles), copies a bf16 row by 25 8-byte cp.async and an int8 row by 25
// 4-byte ones, and zero-fills lanes 100..111 with the same copies at
// source size 0 (Q's too), so the padded lanes add exact zeros; the
// in-block merge and the output, the workspace and the merge kernel keep
// D = 100 (100 threads). The pool keeps its [.., 100] rows.
// The merge kernel takes one block per query head, a thread per dim (80
// threads: two warps and a half one; its warp-wide reductions run in
// warp 0 alone, which is whole), its
// loads over the splits independent: a merge whose threads walked the
// splits one load at a time took ~50 us at 64 splits (H100). It is a
// programmatic dependent launch of the split kernel, so its launch
// overlaps the split's last blocks (0.5-1.7 us less a call on an H100);
// a merge in the last block of each group instead (an atomic counter,
// one launch) was slower on every shape timed: the whole merge then runs
// in one block after the others.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int ROWS = 16;      // query heads a block (mma rows)
constexpr int TK = 64;        // keys a tile: 16 a warp
constexpr int NST = 2;        // ring stages

// Dynamic shared memory of a block: the block's Q rows (bf16, rows padded
// by 16 bytes, so ldmatrix's 8 rows fall in distinct banks); a ring of NST
// stages, each a TK-row key tile and value tile as they arrive (rows padded
// by 16 bytes) and, for q8 pages, the TK key and TK value slot scales; for
// q8, the dequantized bf16 key and value tiles; then the split's page ids.
// After the loop the ring's bytes hold the warps' (o, m, l) for their
// merge.
template <int D, typename T>
struct Plan {
  static constexpr bool Q8 = sizeof(T) == 1;
  static constexpr int DP = pad16(D);                 // lanes held (100: 112)
  static constexpr int LD = DP + 8;                   // bf16 an mma tile row
  static constexpr int ROW = DP * (int)sizeof(T) + 16;  // bytes a staged row
  static constexpr int TILE = TK * ROW;
  static constexpr int SCALES = Q8 ? 2 * TK * 4 : 0;
  static constexpr int STAGE = 2 * TILE + SCALES;
  static constexpr int DEQ = Q8 ? 2 * TK * LD * 2 : 0;
  static constexpr int QBYTES = ROWS * LD * 2;
  static constexpr int OLD = DP + 4;                  // f32 a merge row
  static constexpr int MERGE = (4 * ROWS * OLD + 2 * 4 * ROWS) * 4;
  static constexpr int BODY = NST * STAGE + DEQ > MERGE ? NST * STAGE + DEQ
                                                        : MERGE;
  static constexpr int PAGES_AT = QBYTES + BODY;      // then the page ids
};

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

// The workspace of S > 1 splits: acc [B, KV, S, G, D] f32, then (m, l)
// [B, KV, S, G, 2] f32.
__device__ __forceinline__ size_t ml_offset(int B, int KV, int S, int G,
                                            int D) {
  return (size_t)B * KV * S * G * D;
}

// T is __nv_bfloat16 (bf16 pages, scales null) or int8_t (q8 pages). A
// thread's S and O fragments cover rows lane / 4 (h = 0) and lane / 4 + 8
// (h = 1) of the block's 16, element e of an 8-column fragment at row
// h = e / 2, column 2 * (lane % 4) + e % 2.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ lengths,
                    const int* __restrict__ pages,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                    int H, int KV, int NB, int BS, int nbmax, int G,
                    int split_pages, float soft_cap) {
  using P = Plan<D, T>;
  constexpr int LD = P::LD, DP = P::DP;
  // a staged row's copies: CB bytes each, NCH over the DP held lanes, the
  // first VCH from the row and the rest zero-filled; its dequantization
  // (q8) walks CPR 16-byte chunks; Q's bf16 rows take QB-byte copies (QE
  // lanes each), QN over DP lanes, the first QV from the row
  constexpr int CB = copy_bytes(D * (int)sizeof(T));
  constexpr int NCH = DP * (int)sizeof(T) / CB, VCH = D * (int)sizeof(T) / CB;
  constexpr int CPR = DP * (int)sizeof(T) / 16;
  constexpr int QB = copy_bytes(D * 2), QE = QB / 2;
  constexpr int QN = DP / QE, QV = D / QE;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + P::QBYTES;
  __nv_bfloat16* deq = reinterpret_cast<__nv_bfloat16*>(ring + NST * P::STAGE);
  int* s_page = reinterpret_cast<int*>(smem + P::PAGES_AT);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the merge kernel may be scheduled now; it waits for this grid's
  // partials (griddepcontrol.wait) before it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int n_rg = (G + ROWS - 1) / ROWS;
  const int kvh = blockIdx.x / n_rg, g0 = (blockIdx.x % n_rg) * ROWS;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int B = gridDim.y, S = gridDim.z;
  const int rows = min(ROWS, G - g0);  // live heads of the block

  // the split's page ids (its whole range of the table row, loaded beside
  // the length), so no copy below waits on the block table
  const int split_keys = split_pages * BS;
  const int k_lo = sp * split_keys, pg0 = sp * split_pages;
  for (int i = tid; i < min(split_pages, nbmax - pg0); i += THREADS)
    s_page[i] = pages[(size_t)b * nbmax + pg0 + i];
  const int len = min(lengths[b], nbmax * BS);
  const int k_hi = min(len, k_lo + split_keys);
  const size_t rec0 = (((size_t)b * KV + kvh) * S + sp) * G + g0;  // head g0
  float* ml = ws + ml_offset(B, KV, S, G, D) + rec0 * 2;
  if (S > 1 && k_lo >= k_hi) {  // past the sequence's length: no keys
    for (int r = tid; r < rows; r += THREADS) {
      ml[2 * r] = -1e30f;
      ml[2 * r + 1] = 0.f;
    }
    return;
  }

  // Q rows: heads g0.. of kv head kvh, zeros past the live ones
  const __nv_bfloat16* qb = q + ((size_t)b * H + kvh * G + g0) * D;
  for (int i = tid; i < ROWS * QN; i += THREADS) {
    const int r = i / QN, c = i % QN;
    const bool ok = r < rows && c < QV;
    cp_async_n<QB>(Qs + r * LD + c * QE, ok ? qb + r * D + c * QE : qb, ok);
  }
  __syncthreads();  // the page ids

  // tile t of the split into ring stage t % NST: key and value rows by
  // CB-byte cp.async (and q8 slot scales by 4-byte ones); keys past the
  // split's end arrive as zeros and are masked
  auto slot = [&](int key) {  // the pool slot of key (< k_hi)
    return ((size_t)kvh * NB + s_page[(key - k_lo) / BS]) * BS + key % BS;
  };
  auto issue = [&](int t) {
    unsigned char* st = ring + (t % NST) * P::STAGE;
    const int k0 = k_lo + t * TK;
    for (int i = tid; i < 2 * TK * NCH; i += THREADS) {
      const int v = i / (TK * NCH), r = (i / NCH) % TK, c = i % NCH;
      const int key = k0 + r;
      const bool ok = key < k_hi && c < VCH;
      const T* src = v ? vp : kp;
      if (ok) src += slot(key) * D + c * (CB / (int)sizeof(T));
      cp_async_n<CB>(st + v * P::TILE + r * P::ROW + c * CB, src, ok);
    }
    if constexpr (P::Q8) {
      for (int i = tid; i < 2 * TK; i += THREADS) {
        const int v = i / TK, r = i % TK, key = k0 + r;
        const bool ok = key < k_hi;
        const float* src = v ? vs : ks;
        if (ok) src += slot(key);
        cp_async4(st + 2 * P::TILE + (v * TK + r) * 4, src, ok);
      }
    }
  };

  float o[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};
  const __nv_bfloat16* q_frag = Qs + (lane & 15) * LD + (lane >> 4) * 8;
  const int kw = 16 * warp;  // the warp's keys of a tile

  // commit groups: Q with tile 0, then one a tile (empty past the last),
  // so group t is complete when at most NST - 1 are pending
  const int nt = (k_hi - k_lo + TK - 1) / TK;
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < nt) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    if (t + NST - 1 < nt) issue(t + NST - 1);
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncthreads();  // tile t landed
    const unsigned char* st = ring + (t % NST) * P::STAGE;
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    if constexpr (P::Q8) {
      // dequantize the int8 tiles: bf16(q * slot scale), 16 values a step
      const float* sc_s = reinterpret_cast<const float*>(st + 2 * P::TILE);
      for (int i = tid; i < 2 * TK * CPR; i += THREADS) {
        const int v = i / (TK * CPR), r = (i / CPR) % TK, c = i % CPR;
        const uint4 u = *reinterpret_cast<const uint4*>(
            st + v * P::TILE + r * P::ROW + c * 16);
        const float s = sc_s[v * TK + r];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t x = w[e >> 1] >> (16 * (e & 1));
          h[e] = pack_bf16x2((float)(int8_t)(x & 0xffu) * s,
                             (float)(int8_t)((x >> 8) & 0xffu) * s);
        }
        uint4* dst = reinterpret_cast<uint4*>(deq + (v * TK + r) * LD + c * 16);
        dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
        dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
      }
      __syncthreads();
      kt = deq;
      vt = deq + TK * LD;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(st);
      vt = reinterpret_cast<const __nv_bfloat16*>(st + P::TILE);
    }

    // S = Q . K^T: 16 rows x the warp's 16 keys
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4(qa, q_frag + kk * 16);
      ldsm_x4(kb, kt + (kw + (lane & 7) + ((lane >> 4) << 3)) * LD +
                      (2 * kk + ((lane >> 3) & 1)) * 8);
      mma16816(sc[0], qa, kb[0], kb[1]);
      mma16816(sc[1], qa, kb[2], kb[3]);
    }
    const int kb0 = k_lo + t * TK + kw + 2 * (lane & 3);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = sc[j][e];
        if (soft_cap > 0.f) v = tanhf(v / soft_cap) * soft_cap;
        if (kb0 + 8 * j + (e & 1) >= k_hi) v = -1e30f;
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
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = kb0 + 8 * j + (e & 1) >= k_hi
                            ? 0.f : exp2f(fmaf(sc[j][e], L2E, mb[e >> 1]));
        l_r[e >> 1] += p;
        sc[j][e] = p;
      }

    // O += P . V: P's accumulator fragments are the A fragment of P . V
    const uint32_t pa[4] = {pack_bf16x2(sc[0][0], sc[0][1]),
                            pack_bf16x2(sc[0][2], sc[0][3]),
                            pack_bf16x2(sc[1][0], sc[1][1]),
                            pack_bf16x2(sc[1][2], sc[1][3])};
#pragma unroll
    for (int j = 0; j < DP / 8; j += 2) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vt + (kw + (lane & 15)) * LD + (j + (lane >> 4)) * 8);
      mma16816(o[j], pa, vb[0], vb[1]);
      mma16816(o[j + 1], pa, vb[2], vb[3]);
    }
    __syncthreads();  // the stage (and q8's tiles) are refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' states merge through the ring's bytes: s_o [4][16][OLD],
  // s_m and s_l [4][16]
  float* s_o = reinterpret_cast<float*>(ring);
  float* s_m = s_o + 4 * ROWS * P::OLD;
  float* s_l = s_m + 4 * ROWS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = warp * ROWS + (lane >> 2) + 8 * h;
    if ((lane & 3) == 0) {
      s_m[r] = m_r[h];
      s_l[r] = l;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<float2*>(s_o + r * P::OLD + 8 * j + 2 * (lane & 3)) =
          make_float2(o[j][2 * h], o[j][2 * h + 1]);
  }
  __syncthreads();
  for (int e = tid; e < rows * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float mm = -1e30f;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, s_m[w * ROWS + r]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = expf(s_m[w * ROWS + r] - mm);
      ll += s_l[w * ROWS + r] * wt;
      a = fmaf(s_o[(w * ROWS + r) * P::OLD + d], wt, a);
    }
    if (S == 1) {
      out[((size_t)b * H + kvh * G + g0 + r) * D + d] =
          __float2bfloat16_rn(a / fmaxf(ll, 1e-30f));
    } else {
      ws[(rec0 + r) * D + d] = a;
      if (d == 0) {
        ml[2 * r] = mm;
        ml[2 * r + 1] = ll;
      }
    }
  }
}

// Block (query head of a kv head, kv head, sequence), D threads (at most
// 256), thread d dim d: the S partials weighed by exp(m_s - max m) and divided by the
// weighed sum of their l (clamped at 1e-30); empty splits (l = 0) weigh
// nothing. Dynamic shared memory: m, l and the weight of each split.
__global__ void __launch_bounds__(256)
paged_decode_merge_kernel(const float* __restrict__ ws,
                          __nv_bfloat16* __restrict__ out, int H, int KV,
                          int G, int D, int S) {
  extern __shared__ float mg_smem[];
  float* s_m = mg_smem;
  float* s_l = s_m + S;
  float* s_w = s_l + S;
  __shared__ float s_inv;
  const int gi = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int d = threadIdx.x;
  // launched before the split kernel ends (programmatic dependent
  // launch): wait until its partials are written and visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t rec0 = ((size_t)b * KV + kvh) * S * G + gi;  // split 0
  const float* ml = ws + ml_offset(B, KV, S, G, D);
  for (int s = d; s < S; s += D) {
    s_m[s] = ml[(rec0 + (size_t)s * G) * 2];
    s_l[s] = ml[(rec0 + (size_t)s * G) * 2 + 1];
  }
  __syncthreads();
  if (d < 32) {
    float mm = -1e30f, ll = 0.f;
    for (int s = d; s < S; s += 32) mm = fmaxf(mm, s_m[s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
    for (int s = d; s < S; s += 32) {
      const float w = s_l[s] > 0.f ? expf(s_m[s] - mm) : 0.f;
      s_w[s] = w;
      ll += s_l[s] * w;
    }
    ll = row_sum<32>(ll);
    if (d == 0) s_inv = 1.f / fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  float a = 0.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const float w = s_w[s];
    const float v = ws[(rec0 + (size_t)s * G) * D + d];
    a = fmaf(w != 0.f ? v : 0.f, w, a);  // unwritten partials weigh 0
  }
  out[((size_t)b * H + kvh * G + gi) * D + d] = __float2bfloat16_rn(a * s_inv);
}

template <int D, typename T>
void launch_d(dim3 grid, const void* q, const void* k, const void* v,
              const void* ks, const void* vs, const void* lengths,
              const void* pages, void* out, void* ws, int H, int KV, int NB,
              int BS, int nbmax, int G, int split_pages, float soft_cap,
              cudaStream_t st) {
  auto kern = paged_decode_kernel<D, T>;
  // the page ids make the bytes depend on split_pages: allow the card's
  // most, once; a refused attribute or a range of pages past it leaves the
  // launch to fail, and launch_status() to report it
  static const cudaError_t attr = [&] {
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }();
  (void)attr;
  const size_t bytes = Plan<D, T>::PAGES_AT + (size_t)split_pages * 4;
  kern<<<grid, THREADS, bytes, st>>>(
      (const __nv_bfloat16*)q, (const T*)k, (const T*)v, (const float*)ks,
      (const float*)vs, (const int*)lengths, (const int*)pages,
      (__nv_bfloat16*)out, (float*)ws, H, KV, NB, BS, nbmax, G, split_pages,
      soft_cap);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, const void* pages, void* out,
           void* ws, int B, int H, int KV, int NB, int BS, int D, int nbmax,
           int splits, int split_pages, float soft_cap, void* stream) {
  if (B < 1 || KV <= 0 || H % KV || BS < 1 ||
      (D != 64 && D != 80 && D != 96 && D != 100 && D != 128 && D != 192 &&
       D != 256) ||
      splits < 1 || split_pages < 1 ||
      (long long)splits * split_pages < nbmax ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(KV * ((G + ROWS - 1) / ROWS), B, splits);
  if (D == 64)
    launch_d<64, T>(grid, q, k, v, ks, vs, lengths, pages, out, ws, H, KV, NB,
                    BS, nbmax, G, split_pages, soft_cap, st);
  else if (D == 80)
    launch_d<80, T>(grid, q, k, v, ks, vs, lengths, pages, out, ws, H, KV, NB,
                    BS, nbmax, G, split_pages, soft_cap, st);
  else if (D == 96)
    launch_d<96, T>(grid, q, k, v, ks, vs, lengths, pages, out, ws, H, KV, NB,
                    BS, nbmax, G, split_pages, soft_cap, st);
  else if (D == 100)
    launch_d<100, T>(grid, q, k, v, ks, vs, lengths, pages, out, ws, H, KV,
                     NB, BS, nbmax, G, split_pages, soft_cap, st);
  else if (D == 128)
    launch_d<128, T>(grid, q, k, v, ks, vs, lengths, pages, out, ws, H, KV,
                     NB, BS, nbmax, G, split_pages, soft_cap, st);
  else if (D == 192)
    launch_d<192, T>(grid, q, k, v, ks, vs, lengths, pages, out, ws, H, KV,
                     NB, BS, nbmax, G, split_pages, soft_cap, st);
  else
    launch_d<256, T>(grid, q, k, v, ks, vs, lengths, pages, out, ws, H, KV,
                     NB, BS, nbmax, G, split_pages, soft_cap, st);
  if (splits > 1) {
    // programmatic dependent launch: the merge's launch and scheduling
    // overlap the split kernel's last blocks instead of following them
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    at[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G, KV, B);
    cfg.blockDim = dim3(D);
    cfg.dynamicSmemBytes = 3 * splits * 4;
    cfg.stream = st;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(
        &cfg, paged_decode_merge_kernel, (const float*)ws,
        (__nv_bfloat16*)out, H, KV, G, D, splits);
    if (rc != cudaSuccess) return (int)rc;
  }
  return launch_status();
}

}  // namespace

// q/out [B, H, D] bf16, D in {64, 80, 96, 100, 128, 192, 256}; k/v [KV, NB, BS, D]
// bf16;
// lengths [B], pages
// [B, nbmax] int32. The sequence's pages split into `splits` ranges of
// split_pages (splits * split_pages >= nbmax; ops/paged_attention.split_plan
// picks them); with more than one, ws holds B * KV * splits * (H / KV) *
// (D + 2) f32.
PORT_API int paged_decode(const void* q, const void* k, const void* v,
                          const void* lengths, const void* pages, void* out,
                          void* ws, int B, int H, int KV, int NB, int BS,
                          int D, int nbmax, int splits, int split_pages,
                          float soft_cap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, lengths, pages, out,
                               ws, B, H, KV, NB, BS, D, nbmax, splits,
                               split_pages, soft_cap, stream);
}

// int8 pages k/v [KV, NB, BS, D] with f32 slot scales ks/vs [KV, NB, BS].
PORT_API int paged_decode_q8(const void* q, const void* k, const void* v,
                             const void* ks, const void* vs,
                             const void* lengths, const void* pages, void* out,
                             void* ws, int B, int H, int KV, int NB, int BS,
                             int D, int nbmax, int splits, int split_pages,
                             float soft_cap, void* stream) {
  return launch<int8_t>(q, k, v, ks, vs, lengths, pages, out, ws, B, H, KV, NB,
                        BS, D, nbmax, splits, split_pages, soft_cap, stream);
}
