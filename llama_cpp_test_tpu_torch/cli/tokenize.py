"""Tokenize a prompt with a model's vocabulary (the examples/tokenize
analogue).

Counterpart of llama_cpp_test_tpu/cli/tokenize.py, host only: the token
ids of a prompt (-p, -f or --stdin), each with its piece, or --ids alone.

  python -m llama_cpp_test_tpu_torch.cli.tokenize -m f.gguf -p "text" [--ids]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("llama-tokenize (cuda port, host only)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default=None)
    ap.add_argument("-f", "--file", default=None)
    ap.add_argument("--stdin", action="store_true")
    ap.add_argument("--ids", action="store_true",
                    help="print only the id list")
    ap.add_argument("--no-bos", action="store_true")
    ap.add_argument("--no-parse-special", action="store_true")
    ap.add_argument("--show-count", action="store_true")
    args = ap.parse_args(argv)

    if args.prompt is not None:
        text = args.prompt
    elif args.file:
        with open(args.file, encoding="utf-8") as f:
            text = f.read()
    elif args.stdin:
        text = sys.stdin.read()
    else:
        ap.error("one of --prompt/--file/--stdin is required")

    from ..gguf.reader import open_gguf
    from ..tokenizer import load_tokenizer

    with open_gguf(args.model) as r:
        tok = load_tokenizer(r)
    ids = tok.encode(text, add_special=not args.no_bos,
                     parse_special=not args.no_parse_special)
    if args.ids:
        print("[" + ", ".join(str(i) for i in ids) + "]")
    else:
        for i in ids:
            print(f"{i:>8} -> {tok.token_to_piece(i)!r}")
    if args.show_count:
        print(f"Total number of tokens: {len(ids)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
