"""Perplexity tool (the examples/perplexity analogue,
perplexity.cpp:441).

Counterpart of llama_cpp_test_tpu/cli/perplexity.py: the same flags and
output. Computes token-level perplexity of a text file (WikiText-2
style) with llama.cpp's chunking: the text is tokenized once, split into
n_ctx windows at a stride (n_ctx/2 by default), and the NLL of each
window's tail beyond its first n_ctx - stride tokens is accumulated (the
first window's whole), so the numbers compare with the reference's.
--save-nll writes the per-token NLL and --compare-nll reports the mean
NLL difference against a saved base (a KL proxy for a quantized file
against its source); --hellaswag, --winogrande and --multiple-choice
score those task files by length-normalized ending log-probabilities.
The model runs on the CUDA device (main(argv, device=...) lets a caller
pick another); Context.prefill_nll keeps the log-softmax on the device.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np


def chunks(tokens: list[int], n_ctx: int, stride: int):
    for start in range(0, max(len(tokens) - n_ctx, 1), stride):
        yield start, tokens[start:start + n_ctx]


def _ending_logprob(ctx, context_ids: list[int],
                    full_ids: list[int]) -> tuple[float, int]:
    """(sum logprob, n tokens) of full_ids beyond the context prefix."""
    s = ctx.new_seq()
    try:
        nll = ctx.prefill_nll(s, full_ids)
    finally:
        ctx.free_seq(s)
    # nll[i] is the NLL of full_ids[i+1]; ending spans indices >= len(ctx)-1
    begin = max(len(context_ids) - 1, 0)
    use = nll[begin:]
    return -float(use.sum()), len(use)


def hellaswag_score(ctx, tokenizer, text: str, max_tasks: int = 0) -> float:
    """HellaSwag acc_norm (reference perplexity.cpp:741 hellaswag_score).
    Datafile: 6 lines per task — 'activity: ctx', gold index, 4 endings.
    Picks the ending with the highest length-normalized logprob."""
    lines = text.splitlines()
    if len(lines) % 6:
        raise ValueError("hellaswag file: line count not a multiple of 6")
    n_tasks = len(lines) // 6
    if max_tasks:
        n_tasks = min(n_tasks, max_tasks)
    n_correct = 0
    for ti in range(n_tasks):
        base = ti * 6
        context = lines[base]
        gold = int(lines[base + 1])
        ctx_ids = tokenizer.encode(context, add_special=True)
        scores = []
        for ei in range(4):
            full = tokenizer.encode(context + " " + lines[base + 2 + ei],
                                    add_special=True)
            lp, cnt = _ending_logprob(ctx, ctx_ids, full)
            scores.append(lp / max(cnt, 1))
        if int(np.argmax(scores)) == gold:
            n_correct += 1
        acc = 100.0 * n_correct / (ti + 1)
        print(f"{ti + 1}\t{acc:.8f}", file=sys.stderr)
    return 100.0 * n_correct / max(n_tasks, 1)


def winogrande_score(ctx, tokenizer, text: str, max_tasks: int = 0) -> float:
    """Winogrande accuracy (reference perplexity.cpp:1084): CSV rows
    index,sentence-with-_,option1,option2,answer(1|2); each option replaces
    the blank and the trailing context is scored."""
    import csv
    import io

    rows = list(csv.reader(io.StringIO(text)))
    tasks = []
    for row in rows:
        if len(row) < 5 or row[0] == "" or not row[0].strip().isdigit():
            continue
        sentence, o1, o2, answer = row[1], row[2], row[3], row[4]
        if "_" not in sentence:
            continue
        first, second = sentence.split("_", 1)
        tasks.append((first, second, o1, o2, int(answer)))
    if max_tasks:
        tasks = tasks[:max_tasks]
    n_correct = 0
    for ti, (first, second, o1, o2, answer) in enumerate(tasks):
        scores = []
        for choice in (o1, o2):
            ctx_ids = tokenizer.encode(first + choice, add_special=True)
            full = tokenizer.encode(first + choice + second,
                                    add_special=True)
            lp, cnt = _ending_logprob(ctx, ctx_ids, full)
            scores.append(lp / max(cnt, 1))
        if int(np.argmax(scores)) + 1 == answer:
            n_correct += 1
        acc = 100.0 * n_correct / (ti + 1)
        print(f"{ti + 1}\t{acc:.4f}", file=sys.stderr)
    return 100.0 * n_correct / max(len(tasks), 1)


def multiple_choice_score(ctx, tokenizer, text: str,
                          max_tasks: int = 0) -> float:
    """Generic multiple-choice accuracy (reference perplexity.cpp:1388;
    JSON task list instead of the reference's ad-hoc binary format):
    [{"question": str, "choices": [str, ...], "answer": int}, ...]"""
    tasks = json.loads(text)
    if max_tasks:
        tasks = tasks[:max_tasks]
    n_correct = 0
    for ti, task in enumerate(tasks):
        q = task["question"]
        ctx_ids = tokenizer.encode(q, add_special=True)
        scores = []
        for choice in task["choices"]:
            full = tokenizer.encode(q + " " + choice, add_special=True)
            lp, cnt = _ending_logprob(ctx, ctx_ids, full)
            scores.append(lp / max(cnt, 1))
        if int(np.argmax(scores)) == int(task["answer"]):
            n_correct += 1
    return 100.0 * n_correct / max(len(tasks), 1)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser("llama-perplexity (cuda)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", required=True, help="plain text file")
    ap.add_argument("--hellaswag", action="store_true")
    ap.add_argument("--hellaswag-tasks", type=int, default=400)
    ap.add_argument("--winogrande", action="store_true")
    ap.add_argument("--winogrande-tasks", type=int, default=0)
    ap.add_argument("--multiple-choice", action="store_true")
    ap.add_argument("--multiple-choice-tasks", type=int, default=0)
    ap.add_argument("-c", "--ctx-size", type=int, default=512)
    ap.add_argument("--chunks", type=int, default=0,
                    help="max chunks (0 = all)")
    ap.add_argument("--ppl-stride", type=int, default=0,
                    help="stride (default n_ctx/2)")
    ap.add_argument("--save-nll", default=None,
                    help="write per-token NLL to .npz for KL comparisons")
    ap.add_argument("--compare-nll", default=None,
                    help="npz from --save-nll of a base model: report "
                    "mean ΔNLL (≈ KL proxy)")
    args = ap.parse_args(argv)

    from ..runtime.engine import Context, Model

    model = Model(args.model, device=device)
    if model.tokenizer is None:
        print("error: model has no tokenizer", file=sys.stderr)
        return 1
    with open(args.file, encoding="utf-8") as f:
        text = f.read()
    if args.hellaswag or args.winogrande or args.multiple_choice:
        ctx = Context(model, n_ctx=args.ctx_size, n_seq_max=1)
        if args.hellaswag:
            acc = hellaswag_score(ctx, model.tokenizer, text,
                                  args.hellaswag_tasks)
            print(json.dumps({"hellaswag_acc": round(acc, 4)}))
        elif args.winogrande:
            acc = winogrande_score(ctx, model.tokenizer, text,
                                   args.winogrande_tasks)
            print(json.dumps({"winogrande_acc": round(acc, 4)}))
        else:
            acc = multiple_choice_score(ctx, model.tokenizer, text,
                                        args.multiple_choice_tasks)
            print(json.dumps({"multiple_choice_acc": round(acc, 4)}))
        return 0
    t0 = time.time()
    tokens = model.tokenizer.encode(text, add_special=True)
    print(f"# tokenized {len(tokens)} tokens in {time.time()-t0:.1f}s",
          file=sys.stderr)
    n_ctx = args.ctx_size
    stride = args.ppl_stride or n_ctx // 2
    if len(tokens) < n_ctx:
        print(f"error: need at least n_ctx={n_ctx} tokens, got {len(tokens)}",
              file=sys.stderr)
        return 1

    ctx = Context(model, n_ctx=n_ctx, n_seq_max=1)
    total_nll = 0.0
    total_cnt = 0
    all_nll = []
    n_chunks = 0
    t0 = time.time()
    for start, chunk in chunks(tokens, n_ctx, stride):
        if args.chunks and n_chunks >= args.chunks:
            break
        s = ctx.new_seq()
        nll = ctx.prefill_nll(s, chunk)
        ctx.free_seq(s)
        # first half is context warm-up except for the very first chunk
        begin = 0 if start == 0 else (n_ctx - stride - 1)
        use = nll[begin:]
        total_nll += float(use.sum())
        total_cnt += len(use)
        all_nll.append(use)
        n_chunks += 1
        ppl = math.exp(total_nll / total_cnt)
        print(f"[{n_chunks}] ppl {ppl:.4f}", file=sys.stderr)
    dt = time.time() - t0
    ppl = math.exp(total_nll / total_cnt)
    print(f"# {total_cnt} tokens in {dt:.1f}s "
          f"({total_cnt/dt:.1f} tok/s)", file=sys.stderr)
    out = {"ppl": round(ppl, 4), "tokens": total_cnt, "n_ctx": n_ctx}
    if args.save_nll:
        np.savez(args.save_nll, nll=np.concatenate(all_nll))
        print(f"# saved NLL to {args.save_nll}", file=sys.stderr)
    if args.compare_nll:
        base = np.load(args.compare_nll)["nll"]
        ours = np.concatenate(all_nll)
        n = min(len(base), len(ours))
        delta = float((ours[:n] - base[:n]).mean())
        out["delta_nll_vs_base"] = round(delta, 6)
        out["delta_ppl_vs_base"] = round(
            math.exp(ours[:n].mean()) - math.exp(base[:n].mean()), 4)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
