"""Check a text against a GBNF grammar (the examples/gbnf-validator
analogue).

Counterpart of llama_cpp_test_tpu/cli/gbnf_validator.py over the port's
runtime/grammar.GrammarParser: exit 0 and say so when the grammar takes
the whole input and can end there, else exit 1 naming the first
character it refuses (or that it wants more input).

  python -m llama_cpp_test_tpu_torch.cli.gbnf_validator grammar.gbnf input.txt
"""
from __future__ import annotations

import argparse
import sys


def validate(grammar_text: str, text: str) -> tuple[bool, int]:
    """(accepted, characters taken): accepted when every character is
    taken and the grammar can finish after the last one."""
    from ..runtime.grammar import GrammarParser

    g = GrammarParser(grammar_text).parse()
    for pos, ch in enumerate(text):
        if not g.accept_char(ord(ch)):
            return False, pos
    return g.can_finish(), len(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gbnf-validator (cuda port, host only)")
    ap.add_argument("grammar", help="GBNF grammar file")
    ap.add_argument("input", nargs="?", default=None,
                    help="input file (default: stdin)")
    args = ap.parse_args(argv)

    with open(args.grammar, encoding="utf-8") as f:
        grammar_text = f.read()
    if args.input:
        with open(args.input, encoding="utf-8") as f:
            text = f.read()
    else:
        text = sys.stdin.read()

    ok, pos = validate(grammar_text, text)
    if ok:
        print("Input string is valid according to the grammar.")
        return 0
    if pos < len(text):
        ctx = text[max(0, pos - 20):pos + 20].replace("\n", "\\n")
        print(f"Input string is invalid: unexpected character at position "
              f"{pos}: ...{ctx}...")
    else:
        print("Input string is invalid: grammar expects more input "
              "(incomplete parse).")
    return 1


if __name__ == "__main__":
    sys.exit(main())
