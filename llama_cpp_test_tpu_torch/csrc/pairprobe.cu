// The K-paired-nibble dequant probe of tools/pairprobe.py on an H100.
//
// pairs_gemv replaces the TPU kernel _pairs_kernel (tools/pairprobe.py:42,
// launched by pairs_qmm :80): y[8, N] = x[8, K] . w - xsum . fold with
//   w[k, n] = bf16(bf16(128 + q[k, n]) * s[k / 32, n]),
// q the nibbles of qs [K/2, N] u8 (byte row r: K-row 2r in the low nibble,
// 2r + 1 in the high one), s [K/32, N] bf16, fold [K/32, N] f32 and
// xsum[m, g] = sum of x[m, k] over group g. The TPU kernel built both
// bf16 weights of a byte with integer ops and one bitcast; here the value
// 128 + q is formed in a register and rounded the same way. It is the
// M = 8 GEMV of probe_gemv.cuh (FMT_PAIRS); bound by bytes (qs, s and fold
// read once: 0.69 B a weight, 0.5 of nibbles and 0.19 of scale and fold).
// The block width,
// 32 lanes times cpl columns (2, 4 or 8), is the probe's one knob, as
// tile_n was on the TPU.
#include "probe_gemv.cuh"

// x [8, K] bf16; qs [K/2, n] u8; sc [K/32, n] bf16; fold [K/32, n] f32;
// out [8, n] f32. K a multiple of 32, n of 32 * cpl.
PORT_API int pairs_gemv(const void* x, int K, const void* qs, int n,
                        const void* sc, const void* fold, int cpl, void* out,
                        void* stream) {
  switch (cpl) {
    case 2:
      return launch_probe_gemv<FMT_PAIRS, 2>(x, K, qs, n, sc, fold, out, stream);
    case 4:
      return launch_probe_gemv<FMT_PAIRS, 4>(x, K, qs, n, sc, fold, out, stream);
    case 8:
      return launch_probe_gemv<FMT_PAIRS, 8>(x, K, qs, n, sc, fold, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}
