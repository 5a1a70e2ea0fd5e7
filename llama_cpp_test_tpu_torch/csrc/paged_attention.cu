// K3: paged flash-decoding, one query token per sequence, over bf16 pages
// (paged_decode) or q8_0 pages (paged_decode_q8).
//
// Replaces the TPU kernel _pa_kernel (llama_cpp_test_tpu/ops/paged_attention.py:50,
// launched by paged_attention_decode), both its bf16 branch and its
// quantized=True branch. The TPU kernel walks a sequence's
// pages P at a time along a sequential grid axis, all kv heads per step,
// carrying (m, l, acc) in scratch. Here one block per (sequence, kv head)
// holds the G query heads of that kv head; its 128 threads split into key
// groups that take pages round-robin, each with its own online softmax, and
// the key groups merge their (m, l, acc) through shared memory at the end
// (flash-decoding within the block). Page ids come from the block table;
// only pages below the sequence length are read. Masked logits are -1e30
// and the final denominator is clamped at 1e-30, as on the TPU.
//
// Layout: q/out [B, H, D] bf16 (q pre-scaled), pages [KV, NB, BS, D] bf16,
// or int8 with f32 per-slot scales [KV, NB, BS] (a key or value row is
// q * scale, dequantized in registers after the load, as the TPU kernel
// dequantizes its in-flight tile), lengths [B] int32, page table
// [B, NBmax] int32.
//
// What bounds it on an H100: 2 bytes (bf16) or 1 byte + a 4-byte scale per
// row (q8) per K/V element for ~2 flops per element per query head, so it
// is bound by bytes; the q8 pages halve them. Each thread owns 32 of D
// dimensions of one query head and reads its slice of each key/value row
// with 16-byte loads; the G heads that share a kv head read the same bytes,
// which the L1 serves. A q8 row's dot product runs on the raw int8 values
// and takes the slot scale once. With one block per (sequence, kv head), a
// batch of one TinyLlama sequence fills only 4 SMs: splitting the pages
// across blocks with a second reduction pass is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int KCH = 8;  // keys per online-softmax update

// Dot product of 32 float query values with 32 int8 values at p (16-byte
// aligned).
__device__ __forceinline__ float dot32_i8(const float* q, const int8_t* p) {
  float s = 0.f;
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const uint4 u = p4[v];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      s = fmaf(q[v * 16 + e], (float)(int8_t)((w[e >> 2] >> (8 * (e & 3))) & 0xffu), s);
  }
  return s;
}

// acc[0..31] += p * (32 int8 values at ptr, 16-byte aligned).
__device__ __forceinline__ void axpy32_i8(float* acc, float p,
                                          const int8_t* ptr) {
  const uint4* p4 = reinterpret_cast<const uint4*>(ptr);
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const uint4 u = p4[v];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      acc[v * 16 + e] = fmaf(
          p, (float)(int8_t)((w[e >> 2] >> (8 * (e & 3))) & 0xffu), acc[v * 16 + e]);
  }
}

// T is __nv_bfloat16 (bf16 pages, scales null) or int8_t (q8 pages).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ lengths,
                    const int* __restrict__ pages,
                    __nv_bfloat16* __restrict__ out, int H, int KV, int NB,
                    int BS, int nbmax, int G, float soft_cap) {
  constexpr int TPR = D / 32;        // lanes per query head
  __shared__ float s_acc[32 * THREADS];
  __shared__ float s_m[THREADS], s_l[THREADS];

  const int tid = threadIdx.x;
  const int rt = G * TPR;            // threads per key group
  const int nkg = THREADS / rt;      // key groups
  const int kg = tid / rt, within = tid % rt;
  const int gi = within / TPR, part = within % TPR;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int h = kvh * G + gi;

  float qv[32];
  const __nv_bfloat16* qp = q + ((size_t)b * H + h) * D + part * 32;
#pragma unroll
  for (int i = 0; i < 32; ++i) qv[i] = bf2f(qp[i]);
  const int len = lengths[b];
  const int npages = min(nbmax, (len + BS - 1) / BS);

  constexpr bool Q8 = sizeof(T) == 1;
  float m = -1e30f, l = 0.f, acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // all lanes of a warp run the same trip count (key groups of one warp
  // differ only when rt < 32), so the row_sum shuffles stay converged
  const int warp_kg0 = (tid & ~31) / rt;
  for (int c0 = warp_kg0; c0 < npages; c0 += nkg) {
    const int c = c0 + (kg - warp_kg0);
    const bool live = c < npages;
    const int page = live ? pages[(size_t)b * nbmax + c] : 0;
    const int lo = c * BS;
    const size_t slot0 = ((size_t)kvh * NB + page) * BS;
    const size_t base = slot0 * D + part * 32;
    for (int s0 = 0; s0 < BS; s0 += KCH) {
      float sv[KCH];
      bool ok[KCH];
      float mx = m;
#pragma unroll
      for (int j = 0; j < KCH; ++j) {
        const int s = s0 + j;
        float dot;
        if constexpr (Q8)
          dot = row_sum<TPR>(dot32_i8(qv, kp + base + (size_t)s * D)) *
                ks[slot0 + s];
        else
          dot = row_sum<TPR>(dot32(qv, kp + base + (size_t)s * D));
        if (soft_cap > 0.f) dot = tanhf(dot / soft_cap) * soft_cap;
        ok[j] = live && lo + s < len;
        sv[j] = ok[j] ? dot : -1e30f;
        mx = fmaxf(mx, sv[j]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < KCH; ++j) {
        const float p = ok[j] ? expf(sv[j] - mx) : 0.f;
        l += p;
        if (ok[j]) {
          if constexpr (Q8)
            axpy32_i8(acc, p * vs[slot0 + s0 + j], vp + base + (size_t)(s0 + j) * D);
          else
            axpy32(acc, p, vp + base + (size_t)(s0 + j) * D);
        }
      }
      m = mx;
    }
  }

#pragma unroll
  for (int i = 0; i < 32; ++i) s_acc[i * THREADS + tid] = acc[i];
  s_m[tid] = m;
  s_l[tid] = l;
  __syncthreads();
  if (kg == 0) {
    float mm = -1e30f;
    for (int k = 0; k < nkg; ++k) mm = fmaxf(mm, s_m[k * rt + within]);
    float ll = 0.f, a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a[i] = 0.f;
    for (int k = 0; k < nkg; ++k) {
      const int src = k * rt + within;
      const float w = expf(s_m[src] - mm);
      ll += s_l[src] * w;
#pragma unroll
      for (int i = 0; i < 32; ++i) a[i] = fmaf(s_acc[i * THREADS + src], w, a[i]);
    }
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    __nv_bfloat16* op = out + ((size_t)b * H + h) * D + part * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) op[i] = __float2bfloat16_rn(a[i] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, const void* pages, void* out,
           int B, int H, int KV, int NB, int BS, int D, int nbmax,
           float soft_cap, void* stream) {
  if (KV <= 0 || H % KV || BS % KCH || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const int rt = G * (D / 32);
  if (rt > THREADS || THREADS % rt) return (int)cudaErrorInvalidValue;
  dim3 grid(KV, B);
  cudaStream_t st = (cudaStream_t)stream;
  auto kernel = D == 64 ? paged_decode_kernel<64, T> : paged_decode_kernel<128, T>;
  kernel<<<grid, THREADS, 0, st>>>(
      (const __nv_bfloat16*)q, (const T*)k, (const T*)v, (const float*)ks,
      (const float*)vs, (const int*)lengths, (const int*)pages,
      (__nv_bfloat16*)out, H, KV, NB, BS, nbmax, G, soft_cap);
  return launch_status();
}

}  // namespace

PORT_API int paged_decode(const void* q, const void* k, const void* v,
                          const void* lengths, const void* pages, void* out,
                          int B, int H, int KV, int NB, int BS, int D,
                          int nbmax, float soft_cap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, lengths, pages, out,
                               B, H, KV, NB, BS, D, nbmax, soft_cap, stream);
}

// int8 pages k/v [KV, NB, BS, D] with f32 slot scales ks/vs [KV, NB, BS].
PORT_API int paged_decode_q8(const void* q, const void* k, const void* v,
                             const void* ks, const void* vs,
                             const void* lengths, const void* pages, void* out,
                             int B, int H, int KV, int NB, int BS, int D,
                             int nbmax, float soft_cap, void* stream) {
  return launch<int8_t>(q, k, v, ks, vs, lengths, pages, out, B, H, KV, NB,
                        BS, D, nbmax, soft_cap, stream);
}
