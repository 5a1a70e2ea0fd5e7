// The decode-qmm probes of tools/kbench.py on an H100.
//
// kbench_gemv replaces the TPU kernels kernel_f (tools/kbench.py:98,
// launched :131), kernel_g (:155, :179) and kernel_h (:203, :227): one
// M = 8 dequant GEMV over three weight formats (probe_gemv.cuh: N-paired
// nibbles, signed int4 two a byte, int8), w = bf16(q * s) with group-32
// bf16 scales along K and f32 accumulation, on the tensor cores from a TMA
// ring, K split across a cluster. Bound by bytes; see the header.
//
// kbench_stream replaces kern in build_e (tools/kbench.py:265, launched
// :275), the HBM-streaming probe: for a u8 array a [rows, cols] it computes
//   out[0, j] = sum_{r < rows_used} a[r, j] + (rows_used / 512) * x[0, 0]
// where rows_used = (rows / 512) * 512 (kbench's grid drops the tail), for
// every column j; the caller keeps the first 128. The probe exists to
// stream every byte, so every column's sum is written: a kernel that kept
// only 128 columns would let the compiler drop the other 7/8 of the loads.
// Bound by bytes. One launch, no memset, no atomics: a column group of
// STREAM_COLS bytes is one cluster of STREAM_SLABS CTAs, each taking a slab
// of the rows (kbench's 1024 columns: 128 CTAs). Warp 8 of a CTA pulls the
// slab's rows into a ring of STREAM_STAGES stages by one 2-D TMA box each
// (STREAM_COLS x up to 256 rows); warps 0-7 sum the columns as integers in
// registers (16-bit lanes within a stage, 32-bit across: exact, since
// 255 * rows < 2^24), then over the CTA in shared memory; each CTA stores
// its column sums into rank 0's shared memory (distributed shared memory,
// 16 bytes a store), and after one cluster barrier rank 0 sums the slabs
// in rank order and stores each column once. On an H100 this feed outran
// clustered designs fed by 16-byte register loads; the cluster launch
// itself costs ~0.8 us against the atomics it replaces (PERF.md).
#include "probe_gemv.cuh"

namespace {

constexpr int STREAM_COLS = 64;    // bytes of a column group: one cluster
constexpr int STREAM_SLABS = 8;    // its CTAs, each a slab of the rows
constexpr int STREAM_STAGES = 6;
constexpr int STREAM_BOX_ROWS = 256;   // rows of a stage's TMA box (16 KB)
constexpr int STREAM_CONSUMERS = 256;  // warps 0-7
constexpr int STREAM_THREADS = STREAM_CONSUMERS + 32;
constexpr int STREAM_TILE = 512;       // kbench's row tile
constexpr int STREAM_WPR = STREAM_COLS / 4;                 // words a row
constexpr int STREAM_LANES = STREAM_CONSUMERS / STREAM_WPR;  // row lanes
constexpr int STREAM_STAGE_BYTES = STREAM_BOX_ROWS * STREAM_COLS;
constexpr int STREAM_SMEM = STREAM_STAGES * STREAM_STAGE_BYTES +
                            (STREAM_LANES + STREAM_SLABS) * STREAM_COLS * 4 +
                            2 * STREAM_STAGES * 8;

// grid (STREAM_SLABS, cols / STREAM_COLS), one cluster a column group: CTA
// (slab, cg) sums rows [slab * slab_rows, min(rows_used, (slab + 1) *
// slab_rows)) of its columns, a TMA box of STREAM_BOX_ROWS rows a stage.
__global__ void __cluster_dims__(STREAM_SLABS, 1, 1)
    __launch_bounds__(STREAM_THREADS)
stream_colsum_kernel(const __grid_constant__ CUtensorMap map, int rows_used,
                     int slab_rows, const float* __restrict__ x,
                     float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int slab = blockIdx.x, cg = blockIdx.y;
  const int r0 = slab * slab_rows;
  const int rows = max(0, min(rows_used, r0 + slab_rows) - r0);
  const int nstage = (rows + STREAM_BOX_ROWS - 1) / STREAM_BOX_ROWS;
  // partial sums [row lane][column], the slabs' column sums (rank 0's:
  // [slab][column]), the mbarriers
  uint32_t* red =
      reinterpret_cast<uint32_t*>(smem + STREAM_STAGES * STREAM_STAGE_BYTES);
  uint32_t* csum = red + STREAM_LANES * STREAM_COLS;
  const uint32_t full = smem_u32(csum + STREAM_SLABS * STREAM_COLS);
  const uint32_t empty = full + 8 * STREAM_STAGES;
  if (tid == STREAM_CONSUMERS) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map) : "memory");
    for (int i = 0; i < STREAM_STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, STREAM_CONSUMERS / 32);
    }
    fence_proxy_async();
  }
  __syncthreads();
  // this CTA has started (waited for before any CTA stores into rank 0)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (tid >= STREAM_CONSUMERS) {
    if (tid == STREAM_CONSUMERS) {
      for (int s = 0; s < nstage; ++s) {
        const int slot = s % STREAM_STAGES;
        if (s >= STREAM_STAGES)
          mbar_wait(empty + 8 * slot, ((s / STREAM_STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * slot, STREAM_STAGE_BYTES);
        tma_load_2d(smem_u32(smem + slot * STREAM_STAGE_BYTES), &map,
                    full + 8 * slot, cg * STREAM_COLS,
                    r0 + s * STREAM_BOX_ROWS);
      }
    }
  } else {
    // thread (row lane rl, word c): bytes 4c .. 4c + 3 of rows rl,
    // rl + STREAM_LANES, ...; a warp reads 128 contiguous bytes a load
    const int c = tid % STREAM_WPR, rl = tid / STREAM_WPR;
    uint32_t sum[4] = {0, 0, 0, 0};
    for (int s = 0; s < nstage; ++s) {
      const int slot = s % STREAM_STAGES;
      mbar_wait(full + 8 * slot, (s / STREAM_STAGES) & 1);
      const uint8_t* st = smem + slot * STREAM_STAGE_BYTES;
      const int n = min(STREAM_BOX_ROWS, rows - s * STREAM_BOX_ROWS);
      // bytes 0, 2 and 1, 3 in 16-bit lanes: 16 rows a stage here
      uint32_t lo = 0, hi = 0;
      for (int r = rl; r < n; r += STREAM_LANES) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(st + r * STREAM_COLS + 4 * c);
        lo += w & 0x00FF00FFu;
        hi += (w >> 8) & 0x00FF00FFu;
      }
      sum[0] += lo & 0xFFFFu;
      sum[1] += hi & 0xFFFFu;
      sum[2] += lo >> 16;
      sum[3] += hi >> 16;
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) red[rl * STREAM_COLS + 4 * c + j] = sum[j];
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < STREAM_COLS / 4) {
    uint32_t v[4] = {0, 0, 0, 0};
    for (int l = 0; l < STREAM_LANES; ++l)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] += red[l * STREAM_COLS + 4 * tid + j];
    st_cluster4(cluster_addr(smem_u32(csum + slab * STREAM_COLS + 4 * tid), 0),
                make_float4(__uint_as_float(v[0]), __uint_as_float(v[1]),
                            __uint_as_float(v[2]), __uint_as_float(v[3])));
  }
  cluster_sync();
  if (slab == 0 && tid < STREAM_COLS) {
    uint32_t v = 0;
    for (int q = 0; q < STREAM_SLABS; ++q) v += csum[q * STREAM_COLS + tid];
    // the plain version's rounding: the product, then the sum
    out[cg * STREAM_COLS + tid] = __fadd_rn(
        (float)v, __fmul_rn((float)(rows_used / STREAM_TILE), x[0]));
  }
}

}  // namespace

// fmt 0 (F), 1 (G) or 2 (H); x [8, K] bf16; qs [K, nbc] bytes; sc bf16
// (F: [2, K/32, nbc]; G: [K/32, 2 nbc]; H: [K/32, nbc]); out f32 (F: [8, 2,
// nbc]; G: [8, 2 nbc]; H: [8, nbc]). K a multiple of 32; the launch plan of
// tools.probe_plan (col_blocks ... stages), which probe_plan_ok must accept.
// One launch: no memset, no atomics.
PORT_API int kbench_gemv(int fmt, const void* x, int K, const void* qs,
                         int nbc, const void* sc, void* out, void* stream,
                         int col_blocks, int tile, int splits,
                         int rows_per_split, int stage_rows, int stages) {
  const ProbeArgs a{(const __nv_bfloat16*)x, K, qs, nbc,
                    (const __nv_bfloat16*)sc, nullptr, (float*)out};
  const ProbePlan p{col_blocks, tile, splits, rows_per_split, stage_rows,
                    stages};
  switch (fmt) {
    case FMT_F: return run_probe<FMT_F>(a, p, stream);
    case FMT_G: return run_probe<FMT_G>(a, p, stream);
    case FMT_H: return run_probe<FMT_H>(a, p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one probe GEMV block takes under the plan (fmt 0-3,
// FMT_PAIRS the pairs), what tools.probe_smem computes; -1 where
// probe_plan_ok refuses the plan for K and nbc byte columns.
PORT_API int probe_smem_bytes(int fmt, int K, int nbc, int col_blocks,
                              int tile, int splits, int rows_per_split,
                              int stage_rows, int stages) {
  const ProbePlan p{col_blocks, tile, splits, rows_per_split, stage_rows,
                    stages};
  if (fmt < FMT_F || fmt > FMT_PAIRS || !probe_plan_ok(fmt, K, nbc, p))
    return -1;
  return probe_smem(fmt, p).total;
}

// a [rows, cols] u8, 16-byte aligned, cols a multiple of 128; x [1, >= 1]
// f32; out [1, cols] f32, every column written. One launch: no memset, no
// atomics.
PORT_API int kbench_stream(const void* a, int rows, int cols, const void* x,
                           void* out, void* stream) {
  if (rows < 0 || cols <= 0 || cols % 128 || (uintptr_t)a % 16)
    return (int)cudaErrorInvalidValue;
  const int rows_used = rows / STREAM_TILE * STREAM_TILE;
  const int slab_rows = (rows_used + STREAM_SLABS - 1) / STREAM_SLABS;
  // rows past rows_used come in as zeros and are not summed
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)cols,
                              (cuuint64_t)(rows_used > 0 ? rows_used : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {STREAM_COLS, STREAM_BOX_ROWS};
  const cuuint32_t unit[2] = {1, 1};
  const EncodeTiled enc = encoder();
  if (enc == nullptr ||
      enc(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(a), dims,
          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  (void)cudaFuncSetAttribute(stream_colsum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             STREAM_SMEM);
  stream_colsum_kernel<<<dim3(STREAM_SLABS, cols / STREAM_COLS),
                         STREAM_THREADS, STREAM_SMEM, (cudaStream_t)stream>>>(
      map, rows_used, slab_rows, (const float*)x, (float*)out);
  return launch_status();
}
