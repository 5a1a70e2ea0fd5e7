"""Control-vector generator CLI (reference examples/cvector-generator):
extract per-layer PCA steering directions from positive/negative prompt
files (one prompt per line) and write a controlvector GGUF.

Counterpart of llama_cpp_test_tpu/cli/cvector_generator.py; the model runs
on the CUDA device (main(argv, device=...) lets a caller pick another).

  python -m llama_cpp_test_tpu_torch.cli.cvector_generator -m model.gguf \
      --positive-file pos.txt --negative-file neg.txt -o cvector.gguf
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser("cvector-generator (cuda)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--positive-file", required=True)
    ap.add_argument("--negative-file", required=True)
    ap.add_argument("-o", "--output", default="control_vector.gguf")
    ap.add_argument("-c", "--ctx-size", type=int, default=512)
    args = ap.parse_args(argv)

    from ..models.cvec import generate_control_vector
    from ..runtime.engine import Context, Model

    pos = [l for l in open(args.positive_file, encoding="utf-8")
           .read().splitlines() if l.strip()]
    neg = [l for l in open(args.negative_file, encoding="utf-8")
           .read().splitlines() if l.strip()]
    if len(pos) != len(neg):
        ap.error("positive/negative files must have the same line count")
    model = Model(args.model, device=device)
    ctx = Context(model, n_ctx=args.ctx_size, n_seq_max=2)
    dirs = generate_control_vector(ctx, pos, neg, args.output)
    print(f"wrote {args.output}: {len(dirs)} layer directions from "
          f"{len(pos)} prompt pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
