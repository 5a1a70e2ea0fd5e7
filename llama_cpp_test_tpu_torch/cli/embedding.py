"""Embedding CLI — the examples/embedding analogue.

Counterpart of llama_cpp_test_tpu/cli/embedding.py: the same arguments
and output. Computes pooled embeddings for one or more prompts (the
model's own pooling and causality unless --pooling says otherwise: an
encoder's CLS or mean over bidirectional attention, a decoder's causal
mean) and prints them, or their cosine-similarity matrix with
--similarity. The model runs on the CUDA device (main(argv, device=...)
lets a caller pick another). The Context is the reference's 2048 tokens,
cut to a learned position table where the file has one (BERT-base's 512,
engine.fit_n_ctx), which the reference would open past the table
(ROADMAP §3, fault 15).

  python -m llama_cpp_test_tpu_torch.cli.embedding -m model.gguf \
      -p "first text" -p "second text" [--similarity]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser("llama-embedding (cuda)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", action="append", required=True,
                    help="text to embed (repeatable; '\\n'-separated batches)")
    ap.add_argument("--pooling", choices=["mean", "cls", "last"],
                    default=None,
                    help="default: the model's pooling_type (bert: cls)")
    ap.add_argument("--embd-normalize", type=int, default=2,
                    help="-1: none, 2: L2 (default)")
    ap.add_argument("--similarity", action="store_true",
                    help="print the cosine-similarity matrix instead")
    ap.add_argument("--embd-output-format", choices=["", "json", "array"],
                    default="")
    args = ap.parse_args(argv)

    from ..runtime.engine import Context, Model, fit_n_ctx

    model = Model(args.model, device=device)
    tok = model.tokenizer
    prompts = []
    for p in args.prompt:
        prompts.extend(x for x in p.split("\n") if x)
    ctx = Context(model, n_ctx=fit_n_ctx(model, 2048), n_seq_max=1)

    embs = []
    for p in prompts:
        ids = tok.encode(p, add_special=True) if tok else [1, 2, 3]
        e = np.asarray(ctx.embed(ids, args.pooling), np.float32)
        if args.embd_normalize == 2:
            e = e / (np.linalg.norm(e) or 1.0)
        embs.append(e)

    if args.similarity:
        print("cosine similarity matrix:")
        for a in embs:
            print(" ".join(f"{float(a @ b):6.2f}" for b in embs))
        return 0

    if args.embd_output_format == "json":
        import json

        print(json.dumps({"object": "list", "data": [
            {"object": "embedding", "index": i,
             "embedding": [float(x) for x in e]}
            for i, e in enumerate(embs)]}))
    else:
        for i, e in enumerate(embs):
            head = " ".join(f"{float(x):.6f}" for x in e[:8])
            print(f"embedding {i}: {head} ...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
