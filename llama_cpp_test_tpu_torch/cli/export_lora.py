"""Merge LoRA adapters into a dense GGUF (reference examples/export-lora).

Counterpart of llama_cpp_test_tpu/cli/export_lora.py: host numpy only, no
device work (models/lora.merge_lora). Several adapters merge one after
another, through intermediate files in a temporary directory that is
removed at the end.

  python -m llama_cpp_test_tpu_torch.cli.export_lora -m base.gguf \
      --lora adapter.gguf [--lora-scaled other.gguf 0.5] -o out.gguf
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("export-lora")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--lora", action="append", default=[])
    ap.add_argument("--lora-scaled", action="append", nargs=2, default=[],
                    metavar=("PATH", "SCALE"))
    ap.add_argument("-o", "--output", default="ggml-lora-merged-f16.gguf")
    args = ap.parse_args(argv)

    from ..models.lora import merge_lora

    adapters = [(p, 1.0) for p in args.lora] + \
        [(p, float(s)) for p, s in args.lora_scaled]
    if not adapters:
        ap.error("need at least one --lora / --lora-scaled")
    src = args.model
    # chain-merge: each adapter bakes into the previous output
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for i, (path, scale) in enumerate(adapters):
            dst = args.output if i == len(adapters) - 1 else \
                os.path.join(tmp, f"_lora_merge_{i}.gguf")
            n = merge_lora(src, path, dst, user_scale=scale)
            print(f"merged {path} (scale {scale}): {n} tensors -> {dst}")
            src = dst
    return 0


if __name__ == "__main__":
    sys.exit(main())
