// The K-paired-nibble dequant probe of tools/pairprobe.py on an H100.
//
// pairs_gemv replaces the TPU kernel _pairs_kernel (tools/pairprobe.py:42,
// launched by pairs_qmm :80): y[8, N] = x[8, K] . w - xsum . fold with
//   w[k, n] = bf16(bf16(128 + q[k, n]) * s[k / 32, n]),
// q the nibbles of qs [K/2, N] u8 (byte row r: K-row 2r in the low nibble,
// 2r + 1 in the high one), s [K/32, N] bf16, fold [K/32, N] f32 and
// xsum[m, g] = sum of x[m, k] over group g. It is the M = 8 GEMV of
// probe_gemv.cuh (FMT_PAIRS), bound by bytes (qs, s and fold read once:
// 0.69 B a weight, 0.5 of nibbles and 0.19 of scale and fold). A byte's two
// nibbles are the K pair of one MMA A register, built as the TPU kernel
// builds them: (b & 0xF) | (b & 0xF0) << 12 | 0x43004300 is bf16
// (128 + q_lo, 128 + q_hi), then one __hmul2 by (s, s) rounds each weight
// once; the fold is subtracted per group in f32 from the staged x-sums.
// The block width, 32 * cpl columns (cpl 2, 4 or 8), is the probe's one
// knob, as tile_n was on the TPU: it is the plan's column tile.
#include "probe_gemv.cuh"

// x [8, K] bf16; qs [K/2, n] u8; sc [K/32, n] bf16; fold [K/32, n] f32;
// out [8, n] f32. K a multiple of 32; the launch plan of tools.probe_plan
// at tile 32 * cpl, which probe_plan_ok must accept. One launch: no
// memset, no atomics.
PORT_API int pairs_gemv(const void* x, int K, const void* qs, int n,
                        const void* sc, const void* fold, int cpl, void* out,
                        void* stream, int col_blocks, int tile, int splits,
                        int rows_per_split, int stage_rows, int stages) {
  if ((cpl != 2 && cpl != 4 && cpl != 8) || tile != 32 * cpl)
    return (int)cudaErrorInvalidValue;
  const ProbeArgs a{(const __nv_bfloat16*)x, K, qs, n,
                    (const __nv_bfloat16*)sc, (const float*)fold, (float*)out};
  const ProbePlan p{col_blocks, tile, splits, rows_per_split, stage_rows,
                    stages};
  return run_probe<FMT_PAIRS>(a, p, stream);
}
