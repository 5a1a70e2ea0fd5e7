"""Prompt-lookup decoding CLI (reference examples/lookup: lookup.cpp,
lookup-create.cpp, lookup-merge.cpp, lookup-stats.cpp).

Counterpart of llama_cpp_test_tpu/cli/lookup.py: the same arguments and
output; the model runs on the CUDA device (main(argv, device=...) lets a
caller pick another). --merge loads no model; --create loads it for its
tokenizer, as the reference does.

  python -m llama_cpp_test_tpu_torch.cli.lookup ARGS, where ARGS is
  generate: -m model.gguf -p "..." -n 64 [-lcs static.bin] [-lcd dyn.bin]
  create:   --create cache.bin --text corpus.txt -m model.gguf
            (tokenize corpus -> static cache)
  merge:    --merge a.bin b.bin -o out.bin
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser("llama-lookup (cuda)")
    ap.add_argument("-m", "--model", default=None)
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("-f", "--file", default=None)
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--draft", type=int, default=8, help="max draft tokens")
    ap.add_argument("--ngram-min", type=int, default=1)
    ap.add_argument("--ngram-max", type=int, default=4)
    ap.add_argument("-lcs", "--lookup-cache-static", default=None)
    ap.add_argument("-lcd", "--lookup-cache-dynamic", default=None)
    ap.add_argument("--create", default=None, metavar="OUT.bin",
                    help="build a static cache from --text/--file")
    ap.add_argument("--text", default=None, help="corpus file for --create")
    ap.add_argument("--merge", nargs="+", default=None, metavar="CACHE.bin")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)

    from ..runtime.ngram_cache import LookupDecoder, NGramCache

    if args.merge:
        if not args.output:
            ap.error("--merge needs -o OUT.bin")
        acc = NGramCache.load(args.merge[0])
        for p in args.merge[1:]:
            acc.merge(NGramCache.load(p))
        acc.save(args.output)
        print(f"merged {len(args.merge)} caches -> {args.output} "
              f"({len(acc.data)} ngrams)")
        return 0

    from ..runtime.engine import Context, Model

    if not args.model:
        ap.error("-m/--model required")
    model = Model(args.model, device=device)
    tok = model.tokenizer

    if args.create:
        src = args.text or args.file
        if not src:
            ap.error("--create needs --text FILE")
        text = open(src, encoding="utf-8").read()
        ids = tok.encode(text)
        cache = NGramCache(args.ngram_min, args.ngram_max)
        cache.update(ids)
        cache.save(args.create)
        print(f"static cache: {len(ids)} tokens -> {len(cache.data)} ngrams "
              f"-> {args.create}")
        return 0

    prompt = args.prompt
    if args.file:
        prompt = open(args.file, encoding="utf-8").read()
    ctx = Context(model, n_ctx=args.ctx_size, n_seq_max=2)
    nc_static = NGramCache.load(args.lookup_cache_static) \
        if args.lookup_cache_static else None
    nc_dynamic = None
    if args.lookup_cache_dynamic:
        import os
        nc_dynamic = NGramCache.load(args.lookup_cache_dynamic) \
            if os.path.exists(args.lookup_cache_dynamic) \
            else NGramCache(args.ngram_min, args.ngram_max)
    dec = LookupDecoder(ctx, n_draft=args.draft, ngram_min=args.ngram_min,
                        ngram_max=args.ngram_max, nc_dynamic=nc_dynamic,
                        nc_static=nc_static)
    ids = tok.encode(prompt)
    eos = {tok.vocab.eos_id}
    t0 = time.time()
    out = dec.generate(ids, args.n_predict, eos_ids=eos)
    dt = time.time() - t0
    print(tok.decode(out))
    print(f"\nn_draft      = {args.draft}\n"
          f"n_predict    = {len(out)}\n"
          f"n_drafted    = {dec.n_drafted}\n"
          f"n_accept     = {dec.n_accepted}\n"
          f"accept rate  = {dec.n_accepted / max(dec.n_drafted, 1):.3f}\n"
          f"gen speed    = {len(out) / dt:.2f} t/s", file=sys.stderr)
    if nc_dynamic is not None:
        nc_dynamic.save(args.lookup_cache_dynamic)
    return 0


if __name__ == "__main__":
    sys.exit(main())
