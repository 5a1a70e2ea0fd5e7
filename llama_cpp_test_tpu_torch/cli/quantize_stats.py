"""Quantization error statistics (the examples/quantize-stats analogue).

Counterpart of llama_cpp_test_tpu/cli/quantize_stats.py, host numpy only:
for each quant type, every weight tensor of a model (or those whose name
holds an -l substring) goes through quantize and dequantize, and the
RMSE, the largest error and the 95th percentile of |error| are printed,
per tensor with --per-layer and over all of them.

  python -m llama_cpp_test_tpu_torch.cli.quantize_stats -m f.gguf \\
      [-t Q4_K ...] [-l blk.0 ...] [--per-layer]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def tensor_stats(x: np.ndarray, ggml_type) -> dict | None:
    """Round-trip error of x through ggml_type; None where the row length
    is no multiple of the type's block."""
    from ..quant.codecs import dequantize, quantize

    try:
        raw = quantize(x, ggml_type)
    except (ValueError, NotImplementedError):
        return None
    y = dequantize(raw, ggml_type).reshape(x.shape)
    err = np.abs(y - x)
    rms = float(np.sqrt(np.mean(x * x))) or 1.0
    return {
        "rmse": float(np.sqrt(np.mean(err * err))),
        "maxerr": float(err.max()),
        "p95": float(np.percentile(err, 95)),
        "p99": float(np.percentile(err, 99)),
        "rms_x": rms,
        "n": int(x.size),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("llama-quantize-stats (cuda port, host only)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-t", "--type", action="append", default=[],
                    help="quant type name e.g. Q4_K (repeatable; "
                         "default: Q4_0 Q4_K Q6_K Q8_0)")
    ap.add_argument("-l", "--include-layer", action="append", default=[],
                    help="only tensors whose name contains this substring")
    ap.add_argument("--per-layer", action="store_true",
                    help="print one line per tensor")
    args = ap.parse_args(argv)

    from ..gguf.constants import GGMLType
    from ..gguf.reader import GGUFReader

    types = [GGMLType[t.upper()] for t in (args.type or
                                           ["Q4_0", "Q4_K", "Q6_K", "Q8_0"])]
    with GGUFReader(args.model) as r:
        names = [n for n in r.tensors
                 if not args.include_layer or
                 any(s in n for s in args.include_layer)]
        for t in types:
            tot_se, tot_n, tot_max = 0.0, 0, 0.0
            for name in names:
                if len(r.tensors[name].shape) < 2:
                    continue  # norms and biases stay F32 in a file
                x = r.dequantize(name, np.float32)
                st = tensor_stats(x, t)
                if st is None:
                    continue
                if args.per_layer:
                    print(f"{t.name:8} {name:40} rmse {st['rmse']:.8f} "
                          f"max {st['maxerr']:.6f} p95 {st['p95']:.6f}")
                tot_se += st["rmse"] ** 2 * st["n"]
                tot_n += st["n"]
                tot_max = max(tot_max, st["maxerr"])
            if tot_n:
                print(f"{t.name:8} overall rmse {np.sqrt(tot_se / tot_n):.8f} "
                      f"max {tot_max:.6f} over {tot_n} weights")
            else:
                print(f"{t.name:8} no compatible tensors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
