"""K3's split plans timed on one GPU.

    python llama_cpp_test_tpu_torch/tools/k3_plans.py [--tree DIR] [PLAN ...]

Times chip_smoke.py's K3 rows (TinyLlama, Llama-3-8B and Mixtral-8x7B
geometry, bf16 and q8_0 pages, block tables of 64 pages as every serve
phase builds them, and of 32) under each named split plan of
ops/paged_attention:

  kept  split_plan as it stands (the default)
  two   about two blocks an SM over B * KV * splits, ranges of any length
        from 64 keys up (the plan K3 was first split with)

Each row also carries chip_smoke's `one_split_ms` (one range a sequence,
no merge). With --tree DIR the rows run on the package and chip_smoke.py
of another checkout (for example `git archive` of an earlier commit), at
its own plan, so two versions of K3 are timed in one process after the
other. Prints one JSON object a row and the timer's floor for one and
two empty kernels.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _two_per_sm(b, kv, nbmax, bs, sms):
    want = min(64, max(1, -(-2 * sms // (b * kv)), -(-nbmax // 1024)))
    pages = max(-(-nbmax // want), -(-64 // bs), 1)
    return -(-nbmax // pages), pages


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."),
        help="checkout whose package and chip_smoke.py are timed")
    ap.add_argument("plans", nargs="*", default=["kept", "two"])
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from llama_cpp_test_tpu_torch.ops import paged_attention as pa
    from llama_cpp_test_tpu_torch.tools import L2FlushedTimer

    if not torch.cuda.is_available():
        print("k3_plans: needs a CUDA device", file=sys.stderr)
        return 1
    timer = L2FlushedTimer()
    empty = lambda n: lambda: [torch.cuda._sleep(0) for _ in range(n)]
    print(json.dumps({"tree": tree, "one_empty_kernel_ms": timer(empty(1)),
                      "two_empty_kernels_ms": timer(empty(2))}), flush=True)
    plans = {"kept": pa.split_plan, "two": _two_per_sm}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t, l8, mx = cs.TINYLLAMA, cs.LLAMA3_8B, cs.MIXTRAL
    rows = [(t, 1, 64, False, None), (t, 8, 64, False, None),
            (t, 8, 32, False, None), (t, 1, 64, False, [4000]),
            (l8, 8, 64, False, None), (l8, 1, 64, False, [4000]),
            (mx, 8, 64, True, None), (mx, 8, 32, True, None),
            (mx, 1, 64, True, None), (mx, 1, 64, True, [4000]),
            (t, 32, 64, False, None), (mx, 32, 64, True, None)]
    for name in args.plans:
        pa.split_plan = plans[name]
        # the same seed for every plan: the same lengths, pages and queries
        kc = cs.KernelChecks(torch, timer, np.random.default_rng(1234))
        for hp, b, nbmax, q8, lens in rows:
            width = max(nbmax, -(-max(lens) // 16)) if lens else nbmax
            r = kc.paged_decode(hp, b, nbmax=nbmax, q8=q8, lens=lens)
            print(json.dumps({
                "plan": name, "kernel": r["kernel"], "shape": r["shape"],
                "splits": plans[name](b, hp["n_head_kv"], width, 16, sms),
                "nmse": r["nmse"], "ms": r["ms"],
                "one_split_ms": r.get("one_split_ms"),
                "library_ms": r["library_ms"]}), flush=True)
        if kc.failures:
            print(f"k3_plans: rows outside their gate: {kc.failures}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
