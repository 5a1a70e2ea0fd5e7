// K5: weight-strip-cached prefill dequant-matmul.
//
// Replaces the TPU kernel _qmm_t_cache_kernel
// (llama_cpp_test_tpu/ops/qmatmul.py:276, launched by _qmm_t_cache_call).
// Computes the same function as K1 (qmm.cu): y[M, pack, NPK] =
// x[M, K] . dequant(W) over the same planes (qs [K, NPK] of kind 0-4,
// scale/min [pack, K/group, NPK] bf16, lut f32 for the LUT kinds), with the
// min folded as xsum[M, K/group] @ min, where the wrapper computes xsum (the
// per-group sums of the bf16 x rows, f32) with a torch op, as the reference
// computes it in XLA.
//
// Design. The TPU kernel dequantizes each full-K weight strip once into
// VMEM and reuses it for every row tile. Here a block owns one strip of
// SW = 16 logical columns (16 / pack packed plane columns, all their
// sub-values) over the whole K (<= 4096): it dequantizes the strip once
// into shared memory as bf16, column-major [16][K + 8] (bf16(q*s) for the
// plain kinds, bf16(lut[q]*s) for the LUT kinds: the reference's
// rounding), then walks every 128-row tile of x against the resident strip
// on the tensor cores (wmma, mma.sync 16x16x16 bf16, f32 accumulate; each
// of the 8 warps owns 16 rows), staging x in 128-wide K chunks through
// shared memory with the next chunk prefetched into registers during the
// current chunk's products. The epilogue subtracts xsum . min (f32, as the
// reference's second dot) and writes each output once.
//
// What bounds it on an H100: at M = 512 the products are bound by
// operations (2*M*K*N flops; 989 TFLOP/s bf16), but a 16-column strip
// (128 KB of the 227 KB a block may hold at K = 4096) means x is re-read
// from L2 once per strip, 16 flops per x byte: the L2 stream of x, not the
// tensor cores or the dequantization, sets the time. The reference makes
// the same trade (qmatmul.py:499-504). One block per SM fits.
#include <mma.h>

#include "qmm_gemv.cuh"

using namespace nvcuda;

namespace {

constexpr int SW = 16;           // logical columns per strip (one wmma N tile)
constexpr int CM = 128;          // x rows per row tile (8 warps x 16)
constexpr int CK = 128;          // K per staged x chunk
constexpr int LDA = CK + 8;      // bf16 elements per staged x row
constexpr int LDC = SW + 4;      // floats per staged output row
constexpr int C_THREADS = 256;
constexpr int MAX_K = 4096;
constexpr int XV = CM * CK / 8 / C_THREADS;  // uint4 x loads per thread

__host__ __device__ constexpr size_t cache_smem_bytes(int K, int groups,
                                                      bool has_min) {
  return (size_t)SW * (K + 8) * 2 + (size_t)CM * LDA * 2 +
         (size_t)CM * LDC * 4 + (has_min ? (size_t)groups * SW * 4 : 0);
}

template <int N>
static __device__ __forceinline__ void load_plane_bytes(const uint8_t* p,
                                                        uint8_t* b) {
  if constexpr (N == 16)
    *reinterpret_cast<uint4*>(b) = __ldg(reinterpret_cast<const uint4*>(p));
  else if constexpr (N == 8)
    *reinterpret_cast<uint2*>(b) = __ldg(reinterpret_cast<const uint2*>(p));
  else
    *reinterpret_cast<uint32_t*>(b) =
        __ldg(reinterpret_cast<const uint32_t*>(p));
}

template <int KIND, bool HAS_MIN>
__global__ void __launch_bounds__(C_THREADS)
qmm_cache_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                 const uint8_t* __restrict__ qs, int npk,
                 const __nv_bfloat16* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ minp,
                 const float* __restrict__ lut, int group,
                 const float* __restrict__ xsum, float* __restrict__ out) {
  constexpr int PACK = kind_pack(KIND);
  constexpr int SPK = SW / PACK;      // packed columns per strip
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float lut_s[16];
  const int LDK = K + 8;
  const int G = K / group;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [SW][LDK]
  __nv_bfloat16* As = Ws + SW * LDK;                             // [CM][LDA]
  float* Cs = reinterpret_cast<float*>(As + CM * LDA);           // [CM][LDC]
  float* mn_s = Cs + CM * LDC;                                   // [G][SW]
  load_lut<KIND>(lut_s, lut);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int jb = blockIdx.x * SPK;

  // 1. the strip, dequantized once: thread t takes rows k = t, t + 256, ...
  for (int k = tid; k < K; k += C_THREADS) {
    const int g = k / group;
    __align__(16) uint8_t qb[SPK];
    load_plane_bytes<SPK>(qs + (size_t)k * npk + jb, qb);
#pragma unroll
    for (int h = 0; h < PACK; ++h) {
      const __nv_bfloat16* sp = scale + ((size_t)h * G + g) * npk + jb;
#pragma unroll
      for (int jj = 0; jj < SPK; ++jj)
        Ws[(h * SPK + jj) * LDK + k] = __float2bfloat16_rn(
            plane_value<KIND>(qb[jj], h, lut_s) * bf2f(sp[jj]));
    }
  }
  if constexpr (HAS_MIN) {
    for (int i = tid; i < G * SW; i += C_THREADS) {
      const int g = i / SW, c = i % SW;
      mn_s[i] = bf2f(minp[((size_t)(c / SPK) * G + g) * npk + jb + c % SPK]);
    }
  }

  // 2. every row tile against the resident strip
  uint4 xr[XV];
  auto load_x = [&](int m0, int k0) {
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int i = tid + v * C_THREADS;
      const int r = i / (CK / 8), c8 = (i % (CK / 8)) * 8;
      xr[v] = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        xr[v] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K +
                                                k0 + c8);
    }
  };
  auto store_x = [&]() {
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int i = tid + v * C_THREADS;
      const int r = i / (CK / 8), c8 = (i % (CK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * LDA + c8) = xr[v];
    }
  };

  for (int m0 = 0; m0 < M; m0 += CM) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    load_x(m0, 0);
    for (int k0 = 0; k0 < K; k0 += CK) {
      __syncthreads();  // the strip is complete; As is free again
      store_x();
      __syncthreads();
      if (k0 + CK < K) load_x(m0, k0 + CK);
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(a, As + (16 * warp) * LDA + kk, LDA);
        wmma::load_matrix_sync(b, Ws + k0 + kk, LDK);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    // epilogue: each warp writes its own 16 rows; lane -> column lane % 16,
    // rows lane / 16 + 2i
    float* cw = Cs + (16 * warp) * LDC;
    wmma::store_matrix_sync(cw, acc, LDC, wmma::mem_row_major);
    __syncwarp();
    const int c = lane & 15, h = c / SPK, jj = c % SPK;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (lane >> 4) + 2 * i;
      const int m = m0 + 16 * warp + r;
      if (m >= M) continue;
      float v = cw[r * LDC + c];
      if constexpr (HAS_MIN) {
        const float* xs = xsum + (size_t)m * G;
        for (int g = 0; g < G; ++g) v = fmaf(-xs[g], mn_s[g * SW + c], v);
      }
      out[((size_t)m * PACK + h) * npk + jb + jj] = v;
    }
    __syncwarp();
  }
}

template <int KIND, bool HAS_MIN>
int launch(const __nv_bfloat16* x, int M, int K, const uint8_t* qs, int npk,
           const __nv_bfloat16* scale, const __nv_bfloat16* minp,
           const float* lut, int group, const float* xsum, float* out,
           cudaStream_t st) {
  const size_t bytes = cache_smem_bytes(K, K / group, HAS_MIN);
  auto kern = qmm_cache_kernel<KIND, HAS_MIN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(npk / (SW / kind_pack(KIND)));
  kern<<<grid, C_THREADS, bytes, st>>>(x, M, K, qs, npk, scale, minp, lut,
                                       group, xsum, out);
  return launch_status();
}

}  // namespace

// x [M, K] bf16; qs [K, npk] plane of kind 0-4; scale/min [pack, K/group,
// npk] bf16 (min may be null); lut [16] or [4] f32 for kinds 3/4, else null;
// xsum [M, K/group] f32 per-group sums of x's rows (read only with a min);
// out [M, pack, npk] float32. K <= 4096 and a multiple of 128; npk a
// multiple of 16 / pack. The LUT kinds carry no min.
PORT_API int qmm_cache(const void* x, int M, int K, const void* qs, int npk,
                       int kind, const void* scale, const void* minp,
                       const void* lut, int group, const void* xsum,
                       void* out, void* stream) {
  if (M < 1 || K > MAX_K || K % CK || kind < 0 || kind > 4 || group <= 0 ||
      K % group || npk % (SW / kind_pack(kind)) ||
      (lut != nullptr) != kind_lut(kind) ||
      (minp != nullptr && (kind_lut(kind) || xsum == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto xb = (const __nv_bfloat16*)x;
  auto q = (const uint8_t*)qs;
  auto sc = (const __nv_bfloat16*)scale;
  auto mn = (const __nv_bfloat16*)minp;
  auto lu = (const float*)lut;
  auto xs = (const float*)xsum;
  auto o = (float*)out;
  auto st = (cudaStream_t)stream;
  switch (kind) {
    case 0:
      return mn ? launch<0, true>(xb, M, K, q, npk, sc, mn, lu, group, xs, o, st)
                : launch<0, false>(xb, M, K, q, npk, sc, mn, lu, group, xs, o, st);
    case 1:
      return mn ? launch<1, true>(xb, M, K, q, npk, sc, mn, lu, group, xs, o, st)
                : launch<1, false>(xb, M, K, q, npk, sc, mn, lu, group, xs, o, st);
    case 2:
      return mn ? launch<2, true>(xb, M, K, q, npk, sc, mn, lu, group, xs, o, st)
                : launch<2, false>(xb, M, K, q, npk, sc, mn, lu, group, xs, o, st);
    case 3:
      return launch<3, false>(xb, M, K, q, npk, sc, mn, lu, group, xs, o, st);
    default:
      return launch<4, false>(xb, M, K, q, npk, sc, mn, lu, group, xs, o, st);
  }
}
