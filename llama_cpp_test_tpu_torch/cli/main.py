"""llama-cli analogue (reference examples/main/main.cpp): one-shot and
interactive generation from a GGUF model, with the full sampler chain.

Counterpart of llama_cpp_test_tpu/cli/main.py, the llama branch: the
model runs on the CUDA device (main(argv, device=...) lets a caller pick
another). LoRA adapters (--lora, --lora-scaled) and control vectors
(--control-vector, --control-vector-scaled) attach as the reference
attaches them, except that several adapters all apply (the reference
keeps only the last; ROADMAP §3, fault 9). A recurrent file (mamba,
rwkv6, rwkv6qwen2, rwkv7, arwkv7) runs one-shot greedy generation on its
own Context, as the reference's _run_mamba/_run_rwkv6/_run_rwkv7 do
(sampling flags ignored, as there); --lora, --control-vector,
--prompt-cache and -tp > 1 are refused on it (the reference ignores
them). A t5 file encodes the prompt and decodes greedily from its
decoder start token (models/t5.py, the reference's _run_t5), with the same
refusals; a t5encoder file is embedding-only and returns 1, as there. A
wavtokenizer-dec file is refused naming its loader (cli/tts.py drives
it), and tensor parallelism raises NotImplementedError until the port
carries it (ROADMAP item 13).

Usage:
  python -m llama_cpp_test_tpu_torch.cli.main -m model.gguf -p "prompt" -n 64
  python -m llama_cpp_test_tpu_torch.cli.main -m model.gguf -i   # chat
"""
from __future__ import annotations

import os
import sys
import time


def build_parser():
    """Flags come from the declarative registry (common/args.py) with env
    mirrors; only llama-cli-specific extras are declared here."""
    from ..common.args import Arg, build_parser as registry_parser

    extras = [
        Arg(("-p", "--prompt"), "prompt", str, "", "prompt text",
            examples=("main",)),
        Arg(("-f", "--file"), "file", str, None, "prompt from file",
            examples=("main",)),
        Arg(("-i", "--interactive"), "interactive", "store_true", False,
            "interactive chat mode", examples=("main",)),
        Arg(("--no-display-prompt",), "no_display_prompt", "store_true",
            False, "", examples=("main",)),
        Arg(("--verbose-prompt",), "verbose_prompt", "store_true", False,
            "", examples=("main",)),
        Arg(("-r", "--reverse-prompt"), "reverse_prompt", str, None,
            "stop generation when this string appears (repeatable; "
            "interactive mode returns control)", action="append",
            examples=("main",)),
        Arg(("--prompt-cache",), "prompt_cache", str, None,
            "session file: restore the prompt's KV from it and update it "
            "after the run (main.cpp:237-255)", examples=("main",)),
        Arg(("--prompt-cache-all",), "prompt_cache_all", "store_true",
            False, "also cache generated tokens in the session file",
            examples=("main",)),
        Arg(("--prompt-cache-ro",), "prompt_cache_ro", "store_true",
            False, "use the session file but never update it",
            examples=("main",)),
    ]
    return registry_parser("llama-cli (cuda)",
                           examples=("main", "sampling"), extra=extras)


def _refuse_unported(args, arch: str) -> None:
    """An arch the paged engine does not host raises naming its loader
    (models/registry.check_arch); -tp > 1 names its ROADMAP item."""
    from ..models.registry import check_arch

    check_arch(arch)
    if args.tensor_parallel > 1:
        raise NotImplementedError(
            "-tp > 1 is not ported yet (ROADMAP item 13)")


def _refuse_paged_options(args, what: str) -> None:
    """The options of the paged llama path, refused on another family's
    file (the reference ignores them there)."""
    for flag, on in (("--lora", args.lora or args.lora_scaled),
                     ("--control-vector",
                      args.control_vector or args.control_vector_scaled),
                     ("--prompt-cache", args.prompt_cache),
                     ("-tp > 1", args.tensor_parallel > 1)):
        if on:
            raise ValueError(f"{flag} does not apply to {what}")


def _prompt(args) -> str:
    if args.file:
        with open(args.file, encoding="utf-8") as f:
            return f.read()
    return args.prompt or ""


def _run_recurrent(args, arch: str, device) -> int:
    """One-shot greedy generation for a recurrent file (no KV cache): its
    model class and Context (models/mamba.py, rwkv6.py, rwkv7.py), the
    reference's banner, the prompt echoed, pieces until end of generation
    or -n tokens."""
    _refuse_paged_options(
        args, f"a recurrent {arch} file: it carries state, not a KV cache "
              "or a llama body, and runs on one device")
    from ..models.mamba import generate
    from ..runtime.recurrent import classes

    cls, ctx_cls = classes(arch)
    t0 = time.time()
    model = cls(args.model, device=device)
    hp = model.hp
    size = (f"d_inner={hp.d_inner}" if arch == "mamba"
            else f"head_size={hp.head_size}")
    name = "rwkv6" if arch == "rwkv6qwen2" else arch
    print(f"# {name} model loaded in {time.time()-t0:.1f}s "
          f"(n_layer={hp.n_layer}, {size})", file=sys.stderr)
    if model.tokenizer is None:
        print("error: model has no tokenizer", file=sys.stderr)
        return 1
    prompt = _prompt(args)
    toks = model.tokenizer.encode(prompt, add_special=True)
    vocab = model.tokenizer.vocab
    sys.stdout.write(prompt)
    for tok in generate(ctx_cls(model), toks, args.n_predict):
        if vocab.is_eog(tok):
            break
        sys.stdout.write(model.tokenizer.token_to_piece(tok))
        sys.stdout.flush()
    sys.stdout.write("\n")
    return 0


def _run_t5(args, device) -> int:
    """Encoder-decoder generation (t5): the encoder over the prompt, then
    the decoder's greedy loop seeded with decoder_start_token (the
    reference's _run_t5, main.cpp's T5 flow): its banner, the pieces
    until EOS (the vocab's, or 1) or -n tokens. A t5encoder file is
    embedding-only and returns 1."""
    _refuse_paged_options(
        args, "an encoder-decoder file: it has no paged KV cache or llama "
              "body and runs on one device")
    from ..models.t5 import T5Context, T5Model, generate

    t0 = time.time()
    model = T5Model(args.model, device=device)
    print(f"# t5 model loaded in {time.time()-t0:.1f}s "
          f"(n_layer={model.hp.n_layer}, d_kv={model.hp.d_kv})",
          file=sys.stderr)
    if model.tokenizer is None:
        print("error: model has no tokenizer", file=sys.stderr)
        return 1
    if model.dec is None:
        print("error: t5encoder GGUFs are embedding-only — use "
              "llama-embedding", file=sys.stderr)
        return 1
    toks = model.tokenizer.encode(_prompt(args), add_special=True)
    ctx = T5Context(model, n_ctx=max(64, args.n_predict + 8))
    vocab = model.tokenizer.vocab
    eos = vocab.eos_id if vocab.eos_id is not None else 1
    for tok in generate(ctx, toks, args.n_predict, eos_id=eos):
        sys.stdout.write(model.tokenizer.token_to_piece(tok))
        sys.stdout.flush()
    sys.stdout.write("\n")
    return 0


def _attach_adapters(args, model) -> None:
    """--lora/--lora-scaled and --control-vector(-scaled) onto the model's
    weights. One adapter attaches as the reference attaches it (scale
    applied after the update); several stack along the rank axis
    (attach_loras), where the reference's loop kept only the last."""
    loras = [(p, 1.0) for p in args.lora] + \
        [(p, float(s)) for p, s in args.lora_scaled]
    if loras:
        from ..models.lora import attach_lora, attach_loras, load_lora

        adapters = [(load_lora(p, model.hp), s) for p, s in loras]
        if len(adapters) == 1:
            attach_lora(model.weights, *adapters[0])
        else:
            attach_loras(model.weights, adapters)
        for path, scale in loras:
            print(f"# lora attached: {path} (scale {scale})", file=sys.stderr)
    cv_specs = [(p, 1.0) for p in args.control_vector] + \
        [(p, float(s)) for p, s in args.control_vector_scaled]
    if cv_specs:
        from ..models.cvec import attach_control_vector, load_control_vector

        combined: dict = {}
        for path, strength in cv_specs:
            for il, v in load_control_vector(path).items():
                combined[il] = combined.get(il, 0) + v * strength
        attach_control_vector(model.weights, combined)
        print(f"# control vectors attached: {len(cv_specs)}", file=sys.stderr)


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    from ..common.args import (parse_kv_overrides, rope_kv_overrides,
                               sampler_params_from_args)
    from ..gguf.reader import open_gguf
    from ..runtime.engine import Context, Model
    from ..runtime.scheduler import GenRequest, Scheduler

    from ..models.registry import RECURRENT

    arch = open_gguf(args.model).metadata.get("general.architecture",
                                              "llama")
    if arch in RECURRENT:
        return _run_recurrent(args, arch, device)
    if arch in ("t5", "t5encoder"):
        return _run_t5(args, device)
    _refuse_unported(args, arch)
    t0 = time.time()
    overrides = parse_kv_overrides(getattr(args, "override_kv", None))
    overrides.update(rope_kv_overrides(args))
    model = Model(args.model, device=device, kv_overrides=overrides)
    print(f"# model loaded in {time.time()-t0:.1f}s "
          f"(arch={model.hp.arch}, n_layer={model.hp.n_layer}, "
          f"n_vocab={model.hp.n_vocab}, device={model.device})",
          file=sys.stderr)
    if model.tokenizer is None:
        print("error: model has no tokenizer", file=sys.stderr)
        return 1
    _attach_adapters(args, model)

    ctx = Context(model, n_ctx=args.ctx_size, n_seq_max=1,
                  kv_type=args.cache_type_kv)
    sched = Scheduler(ctx, n_slots=1, chunk_size=args.batch_size,
                      ctx_shift=not args.no_context_shift)
    # session file (--prompt-cache, main.cpp:237-255): pre-warm slot 0's
    # sequence from the saved KV; the scheduler's prefix reuse then skips
    # re-prefilling the shared prefix. Saved back after each run.
    if args.prompt_cache and os.path.exists(args.prompt_cache):
        from ..runtime.state import load_seq_state

        sess = load_seq_state(ctx, args.prompt_cache)
        sched.slots[0].seq = sess
        sched.slots[0].cache_tokens = list(sess.tokens)
        print(f"# session restored: {len(sess.tokens)} tokens from "
              f"{args.prompt_cache}", file=sys.stderr)
    # every 'sampling'-domain flag the parser accepts (incl. --grammar and
    # --json-schema) reaches the chain through the shared helper
    sp = sampler_params_from_args(args)

    prompt = args.prompt
    if args.file:
        with open(args.file, encoding="utf-8") as f:
            prompt = f.read()

    def run_once(text: str) -> None:
        toks = model.tokenizer.encode(text, add_special=True,
                                      parse_special=True)
        if args.verbose_prompt:
            for t in toks:
                print(f"{t:7d} -> {model.tokenizer.token_to_piece(t)!r}",
                      file=sys.stderr)
        t_start = time.time()

        def on_token(tok, piece, finished):
            if finished is None and piece:
                sys.stdout.write(piece)
                sys.stdout.flush()

        req = GenRequest(prompt_tokens=toks, max_tokens=args.n_predict,
                         sampling=sp, on_token=on_token,
                         ignore_eos=args.ignore_eos, n_keep=args.keep,
                         stop_strings=list(args.reverse_prompt or ()))
        if not args.no_display_prompt:
            sys.stdout.write(text)
        sched.submit(req)
        sched.run()
        dt = time.time() - t_start
        m = sched.metrics()
        print(f"\n# {len(toks)} prompt + {len(req.output_tokens)} generated "
              f"in {dt:.2f}s | prefill {m['prompt_tok_per_s']} t/s | "
              f"decode {m['gen_tok_per_s']} t/s", file=sys.stderr)
        if args.prompt_cache and not args.prompt_cache_ro and \
                sched.slots[0].seq is not None:
            from ..runtime.state import save_seq_state

            sess = sched.slots[0].seq
            if not args.prompt_cache_all and sess.n_cached > len(toks):
                # prompt-only caching: drop the generated tail
                ctx.truncate_seq(sess, len(toks))
                sched.slots[0].cache_tokens = list(sess.tokens)
            nb = save_seq_state(ctx, sess, args.prompt_cache)
            print(f"# session saved: {sess.n_cached} tokens "
                  f"({nb/1e6:.1f} MB) -> {args.prompt_cache}",
                  file=sys.stderr)

    if args.interactive:
        print("== interactive mode; empty line or /exit quits ==",
              file=sys.stderr)
        while True:
            try:
                line = input("> ")
            except (EOFError, KeyboardInterrupt):
                break
            if not line.strip() or line.strip() == "/exit":
                break
            run_once(line)
    else:
        if not prompt:
            print("error: empty prompt (use -p or -f or -i)", file=sys.stderr)
            return 1
        run_once(prompt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
