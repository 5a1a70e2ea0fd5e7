"""llava-cli analogue (examples/llava/llava-cli.cpp and qwen2vl-cli.cpp):
multimodal generation. A vision tower (mmproj GGUF) feeds projected image
embeddings into the LLM's context at each `<image>` marker.

Counterpart of llama_cpp_test_tpu/cli/llava.py: the same flags and
output. The projector family is read from the mmproj
(clip.has_qwen2vl_merger: the Qwen2-VL tower, whose tokens rope by
their M-RoPE streams, the text after them from the compressed position;
else CLIP with its llava, gemma3 or resampler projector). The towers and
the model run on the CUDA device (main(argv, device=...) lets a caller
pick another); PIL is imported only to read an --image. A second
qwen2vl image is taken where the reference raises (ROADMAP §3, fault
25).

  python -m llama_cpp_test_tpu_torch.cli.llava -m model.gguf \
      --mmproj mmproj.gguf --image photo.png \
      -p "USER: <image>\\nDescribe the image. ASSISTANT:"
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("llava-cli (cuda)")
    ap.add_argument("-m", "--model", required=True, help="LLM GGUF path")
    ap.add_argument("--mmproj", required=True, help="CLIP mmproj GGUF path")
    ap.add_argument("--image", action="append", default=[], required=False,
                    help="image file (repeatable, one per <image> marker)")
    ap.add_argument("-p", "--prompt",
                    default="USER: <image>\nDescribe the image in detail. "
                            "ASSISTANT:")
    ap.add_argument("-n", "--n-predict", type=int, default=128)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=0.1)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("-s", "--seed", type=int, default=0)
    return ap


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    from ..gguf.reader import open_gguf
    from ..runtime.engine import Context, Model
    from ..runtime.sampling import SamplerChain, SamplerParams

    t0 = time.time()
    model = Model(args.model, device=device)
    is_qwen2vl = bool(open_gguf(args.mmproj).metadata.get(
        "clip.has_qwen2vl_merger"))
    if is_qwen2vl:
        from ..models import qwen2vl_vision as qv

        vis = qv.load_qwen2vl_vision(args.mmproj, device=model.device)
        print(f"# model+mmproj loaded in {time.time()-t0:.1f}s "
              f"(qwen2vl vit {vis.n_layer}L embed {vis.embed})",
              file=sys.stderr)
    else:
        from ..models import clip as clip_mod

        clip = clip_mod.load_clip(args.mmproj, device=model.device)
        print(f"# model+mmproj loaded in {time.time()-t0:.1f}s "
              f"(vit {clip.n_layer}L hidden {clip.hidden}, "
              f"{clip.n_patches} patches/img)", file=sys.stderr)
    if model.tokenizer is None:
        print("error: model has no tokenizer", file=sys.stderr)
        return 1

    segments = args.prompt.split("<image>")
    n_markers = len(segments) - 1
    if n_markers != len(args.image):
        print(f"error: prompt has {n_markers} <image> markers but "
              f"{len(args.image)} --image args", file=sys.stderr)
        return 1

    ctx = Context(model, n_ctx=args.ctx_size, n_seq_max=1)
    s = ctx.new_seq()
    logits = None
    for i, seg in enumerate(segments):
        if i > 0:
            from PIL import Image

            t0 = time.time()
            img = Image.open(args.image[i - 1])
            if is_qwen2vl:
                # M-RoPE image positions, then the text from the
                # compressed position (qwen2vl-cli.cpp:28-60)
                patches, gh, gw = qv.preprocess_image(vis, img)
                emb = qv.encode_image(vis, patches, gh, gw)
                t_img = s.n_cached + s.pos_offset
                mr = qv.mrope_image_positions(t_img, gh, gw)
                logits = ctx.prefill_embeds(s, emb, mrope_pos=mr)
                s.pos_offset = (qv.mrope_delta_after_image(t_img, gh, gw)
                                - s.n_cached)
            else:
                emb = clip_mod.encode_image(
                    clip, clip_mod.preprocess_image(clip, img))
                logits = ctx.prefill_embeds(s, emb)
            print(f"# image {i}: {emb.shape[0]} embeddings in "
                  f"{time.time()-t0:.2f}s", file=sys.stderr)
        toks = model.tokenizer.encode(seg, add_special=(i == 0))
        if toks:
            logits = ctx.prefill(s, toks)
    if logits is None:
        print("error: empty prompt", file=sys.stderr)
        return 1

    sp = SamplerParams(temp=args.temp, top_k=args.top_k, top_p=args.top_p,
                       seed=args.seed)
    chain = SamplerChain.from_params(sp, n_vocab=model.hp.n_vocab)
    vocab = model.tokenizer.vocab
    for _ in range(args.n_predict):
        tok = int(chain.sample(logits))
        chain.accept(tok)
        if vocab.is_eog(tok):
            break
        sys.stdout.write(model.tokenizer.token_to_piece(tok))
        sys.stdout.flush()
        logits = ctx.decode([s], [tok])[0]
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
