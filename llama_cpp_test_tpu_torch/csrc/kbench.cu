// The decode-qmm probes of tools/kbench.py on an H100.
//
// kbench_gemv replaces the TPU kernels kernel_f (tools/kbench.py:98,
// launched :131), kernel_g (:155, :179) and kernel_h (:203, :227): one
// M = 8 dequant GEMV over three weight formats (probe_gemv.cuh: N-paired
// nibbles, signed int4 two a byte, int8), w = bf16(q * s) with group-32
// bf16 scales along K and f32 accumulation. Bound by bytes; see the header.
//
// kbench_stream replaces kern in build_e (tools/kbench.py:265, launched
// :275), the HBM-streaming probe: for a u8 array a [rows, cols] it computes
//   out[0, j] = sum_{r < rows_used} a[r, j] + (rows_used / 512) * x[0, 0]
// where rows_used = (rows / 512) * 512 (kbench's grid drops the tail), for
// every column j; the caller keeps the first 128. The probe exists to
// stream every byte, so every column's sum is written: a kernel that kept
// only 128 columns would let the compiler drop the other 7/8 of the loads.
// A block takes 128 columns of a slab of rows: 8 threads a row, 16 bytes
// each, 32 rows a step, STREAM_BATCH steps' loads issued before any sum;
// about two blocks per SM. Sums are 32-bit integers per column (exact:
// 255 * rows < 2^24), added to `out` with one float atomicAdd per column
// and block; integers below 2^24 add exactly in any order.
#include "probe_gemv.cuh"

namespace {

constexpr int STREAM_THREADS = 256;
constexpr int STREAM_COLS = 128;                        // columns a block
constexpr int STREAM_TPR = STREAM_COLS / 16;            // threads a row
constexpr int STREAM_LANES = STREAM_THREADS / STREAM_TPR;  // rows a step
constexpr int STREAM_BATCH = 4;                         // steps in flight

__global__ void __launch_bounds__(STREAM_THREADS)
stream_colsum_kernel(const uint8_t* __restrict__ a, int rows_used, int cols,
                     int rows_per_block, const float* __restrict__ x,
                     float* __restrict__ out) {
  __shared__ uint32_t red[STREAM_THREADS * 16];
  const int tid = threadIdx.x;
  const int n_cg = cols / STREAM_COLS;
  const int cg = blockIdx.x % n_cg, slab = blockIdx.x / n_cg;
  const int c16 = cg * STREAM_COLS + (tid % STREAM_TPR) * 16;
  const int rl = tid / STREAM_TPR;
  const int r0 = slab * rows_per_block;
  const int r1 = min(rows_used, r0 + rows_per_block);
  uint32_t s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0;
  for (int r = r0 + rl; r < r1; r += STREAM_BATCH * STREAM_LANES) {
    uint4 v[STREAM_BATCH];
#pragma unroll
    for (int u = 0; u < STREAM_BATCH; ++u) {
      const int rr = r + u * STREAM_LANES;
      v[u] = rr < r1 ? __ldg(reinterpret_cast<const uint4*>(
                           a + (size_t)rr * cols + c16))
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < STREAM_BATCH; ++u) {
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] += (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) red[tid * 16 + i] = s[i];
  __syncthreads();
  if (tid < STREAM_COLS) {
    uint32_t t = 0;
    for (int l = 0; l < STREAM_LANES; ++l)
      t += red[(l * STREAM_TPR + tid / 16) * 16 + tid % 16];
    const float add = slab == 0 ? (float)(rows_used / 512) * x[0] : 0.f;
    atomicAdd(out + cg * STREAM_COLS + tid, (float)t + add);
  }
}

}  // namespace

// fmt 0 (F), 1 (G) or 2 (H); x [8, K] bf16; qs [K, nbc] bytes; sc bf16
// (F: [2, K/32, nbc]; G: [K/32, 2 nbc]; H: [K/32, nbc]); out f32 (F: [8, 2,
// nbc]; G: [8, 2 nbc]; H: [8, nbc]). K a multiple of 32, nbc of 128.
PORT_API int kbench_gemv(int fmt, const void* x, int K, const void* qs,
                         int nbc, const void* sc, void* out, void* stream) {
  switch (fmt) {
    case FMT_F:
      return launch_probe_gemv<FMT_F, 4>(x, K, qs, nbc, sc, nullptr, out, stream);
    case FMT_G:
      return launch_probe_gemv<FMT_G, 4>(x, K, qs, nbc, sc, nullptr, out, stream);
    case FMT_H:
      return launch_probe_gemv<FMT_H, 4>(x, K, qs, nbc, sc, nullptr, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// a [rows, cols] u8 (cols a multiple of 128); x [1, >= 1] f32; out
// [1, cols] f32 (zeroed here).
PORT_API int kbench_stream(const void* a, int rows, int cols, const void* x,
                           void* out, void* stream) {
  if (rows < 0 || cols <= 0 || cols % STREAM_COLS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, (size_t)cols * sizeof(float), st);
  const int rows_used = rows / 512 * 512;
  if (rows_used == 0) return launch_status();
  // about two blocks per SM: slabs of whole row steps per column group
  const int n_cg = cols / STREAM_COLS;
  const int slabs = max(1, 2 * num_sms() / n_cg);
  int rpb = (rows_used + slabs - 1) / slabs;
  rpb = (rpb + STREAM_LANES - 1) / STREAM_LANES * STREAM_LANES;
  const int blocks = n_cg * ((rows_used + rpb - 1) / rpb);
  stream_colsum_kernel<<<blocks, STREAM_THREADS, 0, st>>>(
      (const uint8_t*)a, rows_used, cols, rpb, (const float*)x, (float*)out);
  return launch_status();
}
