"""Document retrieval — the examples/retrieval analogue.

Counterpart of llama_cpp_test_tpu/cli/retrieval.py: the same arguments
and output. Chunks input files on a separator, embeds every chunk (the
model's own pooling unless --pooling says otherwise), then answers
queries by cosine top-k over the chunk embeddings (retrieval.cpp's
interactive loop; --query makes it one-shot for scripting). The model
runs on the CUDA device (main(argv, device=...) lets a caller pick
another); the Context is 2048 tokens, cut to a learned position table
(engine.fit_n_ctx).

  python -m llama_cpp_test_tpu_torch.cli.retrieval -m model.gguf \
      -f docs.txt --query "what is it?" [--top-k 3]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def chunk_file(path: str, size: int, separator: str) -> list[str]:
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    chunks, cur = [], ""
    for part in text.split(separator):
        cur += part + separator
        if len(cur) >= size:
            chunks.append(cur.strip())
            cur = ""
    if cur.strip():
        chunks.append(cur.strip())
    return chunks


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser("llama-retrieval (cuda)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--context-file", action="append", required=True)
    ap.add_argument("--chunk-size", type=int, default=200)
    ap.add_argument("--chunk-separator", default="\n")
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--query", action="append", default=[],
                    help="one-shot query (repeatable); omit for stdin loop")
    ap.add_argument("--pooling", choices=["mean", "cls", "last"],
                    default=None,
                    help="default: the model's pooling_type (bert: cls)")
    args = ap.parse_args(argv)

    from ..runtime.engine import Context, Model, fit_n_ctx

    model = Model(args.model, device=device)
    tok = model.tokenizer
    ctx = Context(model, n_ctx=fit_n_ctx(model, 2048), n_seq_max=1)

    chunks: list[tuple[str, str]] = []  # (filename, text)
    for path in args.context_file:
        for c in chunk_file(path, args.chunk_size, args.chunk_separator):
            chunks.append((path, c))
    if not chunks:
        print("no chunks", file=sys.stderr)
        return 1

    def embed(text: str) -> np.ndarray:
        ids = tok.encode(text, add_special=True) if tok else [1]
        e = np.asarray(ctx.embed(ids, args.pooling), np.float32)
        return e / (np.linalg.norm(e) or 1.0)

    mat = np.stack([embed(c) for _, c in chunks])
    print(f"embedded {len(chunks)} chunks", file=sys.stderr)

    def answer(q: str):
        qv = embed(q)
        scores = mat @ qv
        order = np.argsort(-scores)[: args.top_k]
        print(f"query: {q}")
        for rank, i in enumerate(order):
            fn, text = chunks[int(i)]
            snippet = text[:120].replace("\n", " ")
            print(f"  top {rank + 1} (score {float(scores[i]):.4f}, {fn}): "
                  f"{snippet}")

    if args.query:
        for q in args.query:
            answer(q)
        return 0
    for line in sys.stdin:
        line = line.strip()
        if not line:
            break
        answer(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
