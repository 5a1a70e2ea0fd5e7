"""K2's and K3's kernel rows timed on one GPU.

    python llama_cpp_test_tpu_torch/tools/attn_rows.py [--tree DIR] [D ...]

Builds csrc/flash_prefill.cu and csrc/paged_attention.cu, prints their
ptxas register and spill lines, then times chip_smoke.py's K2 (flash
prefill) and K3 (paged decode over bf16 and q8_0 pages) rows at each
head dim D asked for:

  64   TinyLlama: K2 at T = 512 and at T = 100 over 300 cached tokens;
       K3 at B = 1, 8 and B = 1 over 4000 tokens
  128  Llama-3-8B: K2 at T = 512; K3 at B = 8 and B = 1 over 4000
       tokens; Mixtral-8x7B over q8_0 pages at B = 8, 1 and 1 over 4000
  256  Gemma-2-2B (window 4096, softcap 50): K2 at T = 512; K3 and K3-q8
       at B = 8 and B = 1 over 4608 tokens

With --tree DIR the rows run on the package and chip_smoke.py of another
checkout (for example `git archive` of an earlier commit), so two
versions of the kernels are timed in one call, one process each, with
the same seed and so the same inputs. Prints one JSON object a row.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."),
        help="checkout whose package and chip_smoke.py are timed")
    ap.add_argument("dims", nargs="*", type=int, default=[64, 128])
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.tools import L2FlushedTimer

    if not torch.cuda.is_available():
        print("attn_rows: needs a CUDA device", file=sys.stderr)
        return 1
    for name, text in _cuda.build_all(("flash_prefill",
                                       "paged_attention")).items():
        print(json.dumps({"tree": tree, "source": name, "ptxas": [
            ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
    kc = cs.KernelChecks(torch, L2FlushedTimer(), np.random.default_rng(77))
    t, l8, mx = cs.TINYLLAMA, cs.LLAMA3_8B, cs.MIXTRAL
    rows = {
        64: [lambda: kc.flash_prefill(t),
             lambda: kc.flash_prefill(t, t=100, start=300),
             lambda: kc.paged_decode(t, 1), lambda: kc.paged_decode(t, 8),
             lambda: kc.paged_decode(t, 1, lens=[4000])],
        128: [lambda: kc.flash_prefill(l8),
              lambda: kc.paged_decode(l8, 8),
              lambda: kc.paged_decode(l8, 1, lens=[4000]),
              lambda: kc.paged_decode(mx, 8, q8=True),
              lambda: kc.paged_decode(mx, 1, q8=True),
              lambda: kc.paged_decode(mx, 1, q8=True, lens=[4000])]}
    if 256 in args.dims:
        g = cs.GEMMA2_2B
        cap, win = g["attn_softcap"], g["sliding_window"]
        rows[256] = [lambda: kc.flash_prefill(g, window=win, soft_cap=cap)] + [
            (lambda q8=q8, b=b, lens=lens: kc.paged_decode(
                g, b, q8=q8, lens=lens, soft_cap=cap))
            for q8 in (False, True) for b, lens in ((8, None), (1, [4608]))]
    for d in args.dims:
        for fn in rows[d]:
            r = fn()
            print(json.dumps({"tree": tree, "kernel": r["kernel"],
                              "shape": r["shape"], "ms": r["ms"],
                              "nmse": r["nmse"],
                              "library_ms": r["library_ms"]}), flush=True)
    if kc.failures:
        print(f"attn_rows: rows outside their gate: {kc.failures}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
