"""Activation-trace CLI (reference examples/eval-callback): run one prompt
and print per-layer tensor summaries.

Counterpart of llama_cpp_test_tpu/cli/eval_callback.py; the model runs on
the CUDA device (main(argv, device=...) lets a caller pick another).

  python -m llama_cpp_test_tpu_torch.cli.eval_callback -m model.gguf -p "hi"
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser("eval-callback (cuda)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="hello world")
    ap.add_argument("-c", "--ctx-size", type=int, default=512)
    args = ap.parse_args(argv)

    from ..runtime.engine import Context, Model
    from ..runtime.tracing import print_traces, trace_eval

    model = Model(args.model, device=device)
    ctx = Context(model, n_ctx=args.ctx_size, n_seq_max=2)
    ids = model.tokenizer.encode(args.prompt) if model.tokenizer else \
        [1, 2, 3]
    print_traces(trace_eval(ctx, ids))
    return 0


if __name__ == "__main__":
    sys.exit(main())
