"""Lookahead decoding CLI — the examples/lookahead analogue.

Counterpart of llama_cpp_test_tpu/cli/lookahead.py: the same arguments
and output; the model runs on the CUDA device (main(argv, device=...)
lets a caller pick another). Runs greedy generation with Jacobi lookahead
+ n-gram pool speculation and reports the speedup statistics (tokens per
forward pass).

  python -m llama_cpp_test_tpu_torch.cli.lookahead -m f.gguf -p "..." -n 64
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser("llama-lookahead (cuda)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", required=True)
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("-W", "--lookahead-w", type=int, default=8,
                    help="window width")
    ap.add_argument("-N", "--lookahead-n", type=int, default=4,
                    help="n-gram size")
    ap.add_argument("-G", "--lookahead-g", type=int, default=8,
                    help="pool entries per key")
    args = ap.parse_args(argv)

    from ..runtime.engine import Context, Model
    from ..runtime.lookahead import LookaheadDecoder, LookaheadParams

    model = Model(args.model, device=device)
    tok = model.tokenizer
    if tok is None:
        print("model has no tokenizer", file=sys.stderr)
        return 1
    prompt = tok.encode(args.prompt, add_special=True)
    ctx = Context(model, n_ctx=args.ctx_size, n_seq_max=1)
    dec = LookaheadDecoder(ctx, LookaheadParams(
        w=args.lookahead_w, n=args.lookahead_n, g=args.lookahead_g))
    eos = {tok.vocab.eos_id} if tok.vocab.eos_id >= 0 else None

    t0 = time.time()
    out = dec.generate(prompt, args.n_predict, eos_ids=eos)
    dt = time.time() - t0
    print(tok.decode(out))
    st = dec.stats
    print(f"\nn_generated = {st.n_generated}, n_forward = {st.n_forward}, "
          f"accepted = {st.n_accepted}, "
          f"tokens/pass = {st.tokens_per_pass:.2f}, "
          f"{st.n_generated / dt:.2f} t/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
