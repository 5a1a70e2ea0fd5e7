"""Lookahead (Jacobi) decoding — the examples/lookahead analogue
(reference examples/lookahead/lookahead.cpp, W/N/G windows).

Counterpart of llama_cpp_test_tpu/runtime/lookahead.py (host Python over
the port's Context; each step's all-logits prefill runs K1 and K2 on
CUDA).

Self-speculative decoding with no draft model: each step runs ONE forward
pass over [last_token] + guess window, teacher-forcing the current guesses
(a Jacobi fixed-point iteration on the token sequence). The longest guess
prefix that matches the model's own greedy predictions is accepted, plus the
standard bonus token — so every step yields >= 1 token, and every token is
the argmax of its own verification row (lossless). On the card the
verification rows (K1's GEMM, K2) and plain decode (K1's GEMV, K3) round
differently, so a near tie can split them (ROADMAP §3).

Guesses come from two sources, as in the reference:
  - the Jacobi window: the model's predictions from the previous iteration
    (lookahead.cpp's 2D W x (N-1) window, flattened to the leading
    trajectory: one contiguous prefill, no custom mask);
  - an n-gram pool keyed by the current last token (the G verification
    branch, lookahead.cpp:45-58), filled from observed prediction
    trajectories with N-grams.

The rejected tail of each window is rolled back with Context.truncate_seq
(the llama_kv_self_seq_rm analogue), so the paged KV cache never holds
unverified tokens.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from .engine import Context


@dataclasses.dataclass
class LookaheadParams:
    w: int = 8       # window width (guess length per step)
    n: int = 4       # n-gram size collected into the pool
    g: int = 8       # max pool entries kept per key token


@dataclasses.dataclass
class LookaheadStats:
    n_forward: int = 0     # forward passes (prefill calls)
    n_generated: int = 0   # tokens emitted
    n_accepted: int = 0    # guessed tokens accepted (beyond the bonus)

    @property
    def tokens_per_pass(self) -> float:
        return self.n_generated / max(1, self.n_forward)


class LookaheadDecoder:
    """Greedy lookahead decoding over one Context (no draft model)."""

    def __init__(self, ctx: Context, params: LookaheadParams | None = None):
        self.ctx = ctx
        self.p = params or LookaheadParams()
        self.stats = LookaheadStats()
        # n-gram pool: key token -> recent (n-1)-gram continuations
        self.pool: dict[int, deque] = {}

    def _pool_add(self, key: int, gram: list[int]) -> None:
        dq = self.pool.setdefault(key, deque(maxlen=self.p.g))
        if gram and gram not in dq:
            dq.append(gram)

    def _guess(self, last: int, window: list[int]) -> list[int]:
        """Pick the guess sequence for this step: pool hit beats the Jacobi
        window (the pool holds verified-looking trajectories)."""
        dq = self.pool.get(last)
        if dq:
            g = list(dq[-1])  # most recent n-gram for this key
            # extend with the window to keep the full width
            return (g + window)[: self.p.w]
        return window[: self.p.w]

    def generate(self, prompt_tokens: list[int], max_new_tokens: int,
                 eos_ids: set[int] | None = None) -> list[int]:
        p = self.p
        ctx = self.ctx
        s = ctx.new_seq()
        out: list[int] = []
        try:
            logits = ctx.prefill(s, list(prompt_tokens))
            self.stats.n_forward += 1
            last = int(np.argmax(logits))
            out.append(last)
            self.stats.n_generated += 1
            # seed the Jacobi window from the prompt tail (lookahead.cpp
            # seeds from the prompt as well)
            window = list(prompt_tokens[-p.w:]) if prompt_tokens else [last]
            while len(out) < max_new_tokens:
                if eos_ids and last in eos_ids:
                    break
                guess = self._guess(last, window)
                block = [last] + guess
                logits = ctx.prefill(s, block, all_logits=True)
                self.stats.n_forward += 1
                preds = np.argmax(np.asarray(logits), axis=-1).tolist()
                # preds[i] is the model's token after block[:i+1]
                n_acc = 0
                for i, gt in enumerate(guess):
                    if preds[i] == gt:
                        n_acc += 1
                    else:
                        break
                accepted = guess[:n_acc]
                bonus = int(preds[n_acc])
                self.stats.n_accepted += n_acc
                # roll back the rejected guess tail from the KV cache
                ctx.truncate_seq(s, s.n_cached - len(block) + 1 + n_acc)
                # harvest n-grams from the prediction trajectory into the pool
                traj = [last] + preds
                for i in range(len(traj) - 1):
                    self._pool_add(traj[i], traj[i + 1: i + p.n])
                # Jacobi update: next window = model predictions past the
                # accepted point (the fixed-point iterate)
                window = preds[n_acc + 1: n_acc + 1 + p.w]
                if len(window) < p.w:
                    window = window + preds[:p.w - len(window)]
                for t in accepted + [bonus]:
                    out.append(t)
                    self.stats.n_generated += 1
                    if eos_ids and t in eos_ids:
                        return out
                    if len(out) >= max_new_tokens:
                        break
                last = out[-1]
            return out
        finally:
            ctx.free_seq(s)
