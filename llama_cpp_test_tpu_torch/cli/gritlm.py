"""gritlm analogue (reference examples/gritlm/gritlm.cpp): one model serving
both text embedding and generation (Generative Representational
Instruction Tuning).

Counterpart of llama_cpp_test_tpu/cli/gritlm.py: the same arguments and
output. Embedding mode formats the input as
  "<|user|>\\n{instruction}\\n<|embed|>\\n{sample}"
and runs non-causal (bidirectional) attention with mean pooling over the
sample tokens (Context.embed(causal=False, n_skip=...), K2 without a
causal bound on CUDA). Generation mode is the ordinary causal path with
the "<|user|>\\n...\\n<|assistant|>\\n" wrapper. The model runs on the
CUDA device (main(argv, device=...) lets a caller pick another); -c is
cut to a learned position table (engine.fit_n_ctx).

  python -m llama_cpp_test_tpu_torch.cli.gritlm -m model.gguf \
      --doc "A purely peer-to-peer version..." --doc "Curiosity rover..." \
      --query "What is bitcoin?" [--instruction "..."] [-p "gen prompt"]
"""
from __future__ import annotations

import sys

import numpy as np


def gritlm_instruction(instruction: str) -> str:
    if instruction:
        return f"<|user|>\n{instruction}\n<|embed|>\n"
    return "<|embed|>\n"


def build_parser():
    from ..common.args import Arg, build_parser as registry_parser

    extras = [
        Arg(("--doc",), "doc", str, None, "document to embed (repeatable)",
            action="append", examples=("gritlm",)),
        Arg(("--query",), "query", str, None, "query to embed (repeatable)",
            action="append", examples=("gritlm",)),
        Arg(("--instruction",), "instruction", str,
            "Given a scientific paper title, retrieve the paper's abstract",
            "embedding instruction", examples=("gritlm",)),
        Arg(("-p", "--prompt"), "prompt", str, None,
            "also run generation with this prompt", examples=("gritlm",)),
    ]
    return registry_parser("llama-gritlm (cuda)",
                           examples=("gritlm", "main", "sampling"),
                           extra=extras)


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    from ..runtime.engine import Context, Model, fit_n_ctx, generate

    model = Model(args.model, device=device)
    if model.tokenizer is None:
        print("error: model has no tokenizer", file=sys.stderr)
        return 1
    ctx = Context(model, n_ctx=fit_n_ctx(model, args.ctx_size), n_seq_max=2)

    queries = args.query or []
    docs = args.doc or []
    if queries or docs:
        instr = gritlm_instruction(args.instruction)

        def embed(text: str, instructed: bool) -> np.ndarray:
            prefix = instr if instructed else gritlm_instruction("")
            n_pre = len(model.tokenizer.encode(prefix, add_special=True,
                                               parse_special=True))
            toks = model.tokenizer.encode(prefix + text, add_special=True,
                                          parse_special=True)
            # instruction tokens attend but are excluded from the mean
            # pool (gritlm.cpp:46 pools over the sample only)
            return ctx.embed(toks, pooling="mean", causal=False,
                             n_skip=n_pre)

        q_emb = [embed(q, True) for q in queries]
        d_emb = [embed(d, False) for d in docs]
        for i, q in enumerate(queries):
            for j, d in enumerate(docs):
                cos = float(np.dot(q_emb[i], d_emb[j]))
                print(f"cosine(query[{i}], doc[{j}]) = {cos:.3f} "
                      f"| {q[:40]!r} vs {d[:40]!r}")

    if args.prompt:
        text = f"<|user|>\n{args.prompt}\n<|assistant|>\n"
        toks = model.tokenizer.encode(text, add_special=True,
                                      parse_special=True)
        eog = {model.tokenizer.vocab.eos_id}
        for tok in generate(ctx, toks, args.n_predict, eos_ids=eog):
            sys.stdout.write(model.tokenizer.token_to_piece(tok))
            sys.stdout.flush()
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
