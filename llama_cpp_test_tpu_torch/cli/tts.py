"""llama-tts analogue (reference examples/tts/tts.cpp, OuteTTS flow):
a text-to-codes LLM generates audio-codebook tokens, the WavTokenizer-dec
vocoder (models/wavtokenizer.py) turns them into a 24kHz waveform.

Counterpart of llama_cpp_test_tpu/cli/tts.py: the LLM (the paged Model /
Context, so its projections, prefill and decode attention run on the
port's kernels) and the vocoder run on the CUDA device (main(argv,
device=...) lets a caller pick another). Of the generated tokens, only
those in [CODE_TOKEN_OFFSET, CODE_TOKEN_OFFSET + the vocoder's rows) are
audio codes; the reference keeps every token from the offset up and its
gather clamps a token past the codebook to the last code (ROADMAP §3,
fault 26). A --codes list with a code past the codebook raises.

Usage:
  python -m llama_cpp_test_tpu_torch.cli.tts -m outetts.gguf \
      -mv wavtok.gguf -p "hello world" -o out.wav
  python -m llama_cpp_test_tpu_torch.cli.tts -mv wavtok.gguf \
      --codes 12,44,19,... -o out.wav      # vocoder-only
"""
from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np

# OuteTTS v0.2 audio-code token offset ("<|0|>", tts.cpp:720)
CODE_TOKEN_OFFSET = 151672


def process_text(text: str) -> str:
    """tts.cpp process_text (OuteTTS v0.2 prompt_processor analogue):
    lowercase, strip to word characters, join single-spaced."""
    t = text.lower()
    t = re.sub(r"[-_/,\.\\]", " ", t)
    t = re.sub(r"[^a-z\s]", "", t)
    t = re.sub(r"\s+", " ", t).strip()
    return t


def build_prompt(text: str) -> str:
    words = process_text(text).split()
    body = "<|text_sep|>".join(words)
    return ("<|im_start|>\n<|text_start|>" + body +
            "<|text_end|>\n<|audio_start|>\n")


def generate_codes(model, ctx, text: str, n_predict: int) -> list:
    """Greedy text-to-codes (tts.cpp's loop): the prompt prefilled, then
    one decode a token until <|audio_end|>, an end of generation or
    n_predict tokens. Returns every token generated."""
    toks = model.tokenizer.encode(build_prompt(text), add_special=True)
    s = ctx.new_seq()
    logits = ctx.prefill(s, toks)
    out = []
    vocab = model.tokenizer.vocab
    for _ in range(n_predict):
        tok = int(np.argmax(logits))
        if vocab.is_eog(tok) or tok < CODE_TOKEN_OFFSET:
            piece = model.tokenizer.token_to_piece(tok)
            if "audio_end" in piece or vocab.is_eog(tok):
                break
        out.append(tok)
        logits = ctx.decode([s], [tok])[0]
    ctx.free_seq(s)
    return out


def audio_codes(tokens, n_codes: int) -> np.ndarray:
    """The generated tokens that are codes of an n_codes-row vocoder, as
    codes."""
    t = np.asarray(tokens, np.int64)
    keep = (t >= CODE_TOKEN_OFFSET) & (t < CODE_TOKEN_OFFSET + n_codes)
    return (t[keep] - CODE_TOKEN_OFFSET).astype(np.int32)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser("llama-tts (cuda)")
    ap.add_argument("-m", "--model", default=None,
                    help="OuteTTS text-to-codes GGUF")
    ap.add_argument("-mv", "--model-vocoder", required=True,
                    help="WavTokenizer-dec GGUF")
    ap.add_argument("-p", "--prompt", default="Hello world")
    ap.add_argument("-o", "--output", default="output.wav")
    ap.add_argument("-n", "--n-predict", type=int, default=768)
    ap.add_argument("-c", "--ctx-size", type=int, default=4096)
    ap.add_argument("--codes", default=None,
                    help="comma-separated audio codes (skip the LLM)")
    args = ap.parse_args(argv)

    from ..models.wavtokenizer import (decode_codes, embd_to_audio,
                                       load_wavtokenizer, write_wav)

    voc = load_wavtokenizer(args.model_vocoder, device=device)
    if args.codes:
        codes = np.asarray([int(c) for c in args.codes.split(",")], np.int32)
    else:
        if not args.model:
            print("error: need -m (OuteTTS model) or --codes",
                  file=sys.stderr)
            return 1
        from ..runtime.engine import Context, Model

        t0 = time.time()
        model = Model(args.model, device=device)
        print(f"# ttc model loaded in {time.time()-t0:.1f}s",
              file=sys.stderr)
        ctx = Context(model, n_ctx=args.ctx_size, n_seq_max=1)
        out = generate_codes(model, ctx, args.prompt, args.n_predict)
        codes = audio_codes(out, voc.n_codes)
        print(f"# generated {codes.size} audio codes", file=sys.stderr)
        if codes.size == 0:
            print("error: model produced no audio codes", file=sys.stderr)
            return 1

    t0 = time.time()
    embd = decode_codes(voc, codes)
    audio = embd_to_audio(embd, n_fft=voc.n_fft)
    write_wav(args.output, audio)
    print(f"# {audio.size} samples ({audio.size/24000:.2f}s) -> "
          f"{args.output} in {time.time()-t0:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
