"""Speculative decoding — draft model proposes, target verifies.

The common/speculative.h + examples/speculative-simple analogue
(reference common/speculative.cpp: common_speculative_gen_draft with
n_draft/p_min; examples/speculative-simple/speculative-simple.cpp accept
loop): the draft model greedily proposes up to n_draft tokens (stopping
early when its confidence drops below p_min), the target scores the whole
proposal in ONE prefill call (all-logits), the longest agreeing prefix is
accepted, and the target's logits at the first disagreement supply the
bonus/correction token. Rejected tail KV is rolled back by truncating the
paged block table (the llama_kv_self_seq_rm analogue — no data movement,
just table bookkeeping).

Counterpart of llama_cpp_test_tpu/runtime/speculative.py: host Python over
the port's Context. The scoring call is a bucketed prefill (K1's GEMM and
K2 on the card), so a K-token verification costs one dense step instead
of K serial decode steps: the win is K_accepted tokens per target call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .engine import Context, SeqState


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max())
    return e / e.sum()


@dataclasses.dataclass
class SpecParams:
    n_draft: int = 8       # max tokens per draft (speculative.h n_draft=16)
    p_min: float = 0.75    # draft confidence floor (speculative.h p_min)


@dataclasses.dataclass
class SpecStats:
    n_target_calls: int = 0
    n_drafted: int = 0
    n_accepted: int = 0

    @property
    def accept_rate(self) -> float:
        return self.n_accepted / max(self.n_drafted, 1)


class SpeculativeDecoder:
    """Greedy-acceptance speculative decoding over two Contexts."""

    def __init__(self, target: Context, draft: Context,
                 params: SpecParams | None = None):
        self.target = target
        self.draft = draft
        self.params = params or SpecParams()
        self.stats = SpecStats()

    def generate(self, prompt_tokens: list[int], max_new_tokens: int,
                 eos_ids: set[int] | None = None) -> list[int]:
        p = self.params
        st = self.target.new_seq()
        sd = self.draft.new_seq()
        out: list[int] = []
        try:
            tgt_logits = self.target.prefill(st, prompt_tokens)
            self.draft.prefill(sd, prompt_tokens)
            self.stats.n_target_calls += 1
            last = int(np.argmax(tgt_logits))
            out.append(last)
            while len(out) < max_new_tokens:
                if eos_ids and last in eos_ids:
                    break
                # --- draft proposes greedily with confidence floor ---------
                draft_toks: list[int] = []
                d_logits = self.draft.decode([sd], [last])[0]
                for _ in range(p.n_draft):
                    probs = _softmax(d_logits)
                    t = int(np.argmax(probs))
                    if probs[t] < p.p_min:
                        break
                    draft_toks.append(t)
                    if len(draft_toks) >= p.n_draft:
                        break
                    d_logits = self.draft.decode([sd], [t])[0]
                self.stats.n_drafted += len(draft_toks)
                # --- target verifies [last] + draft in one prefill ---------
                block = [last] + draft_toks
                logits = self.target.prefill(st, block, all_logits=True)
                self.stats.n_target_calls += 1
                # logits[i] predicts block[i+1]; the last row predicts next
                n_acc = 0
                for i, dt in enumerate(draft_toks):
                    if int(np.argmax(logits[i])) == dt:
                        n_acc += 1
                    else:
                        break
                self.stats.n_accepted += n_acc
                accepted = draft_toks[:n_acc]
                bonus = int(np.argmax(logits[n_acc]))
                k = len(draft_toks)
                # --- roll back rejected KV (llama_kv_self_seq_rm analogue) --
                # target cache now: prompt + last + t1..tk; keep through the
                # accepted prefix
                base = st.n_cached - (k + 1)   # tokens before this block
                self._truncate(st, base + 1 + n_acc, self.target)
                # draft cache now: prompt + last + t1..t_{k-1} (the final
                # proposal was never fed back); keep prompt + last + accepted
                base_d = sd.n_cached - max(k, 1)  # before decode(last)
                want_d = base_d + 1 + n_acc
                if want_d <= sd.n_cached:
                    self._truncate(sd, want_d, self.draft)
                else:
                    # all k proposals accepted: draft is missing t_k's KV
                    self.draft.prefill(sd, [draft_toks[-1]])
                for t in accepted + [bonus]:
                    out.append(t)
                    if eos_ids and t in eos_ids:
                        return out
                    if len(out) >= max_new_tokens:
                        break
                last = out[-1]
            return out
        finally:
            self.target.free_seq(st)
            self.draft.free_seq(sd)

    @staticmethod
    def _truncate(s: SeqState, n: int, ctx: Context) -> None:
        n = max(0, min(n, s.n_cached))
        s.table.truncate(n)
        s.n_cached = n
        s.tokens = s.tokens[:n]


@dataclasses.dataclass
class TreeSpecParams:
    n_draft: int = 8       # draft depth per round
    n_seq_dft: int = 4     # max parallel draft branches (reference -ns)
    p_split: float = 0.1   # branch when runner-up prob exceeds this
    p_min: float = 0.0     # stop a branch when its best prob drops below


class TreeSpeculativeDecoder:
    """Tree-based speculative decoding — the examples/speculative analogue
    (reference speculative.cpp:54-58,195-216: n_seq_dft parallel draft
    branches split on p_draft_split, greedy acceptance).

    The draft explores up to n_seq_dft branches per round: whenever the
    draft's runner-up token carries more than p_split probability, the branch
    forks (COW on the paged draft cache). Every branch is then verified
    against the target with one teacher-forced prefill; the branch with the
    longest accepted prefix wins. Greedy acceptance keeps the output
    bit-identical to plain greedy decoding on the target."""

    def __init__(self, target: Context, draft: Context,
                 params: TreeSpecParams | None = None):
        self.target = target
        self.draft = draft
        self.p = params or TreeSpecParams()
        self.stats = SpecStats()
        self.n_splits = 0

    def generate(self, prompt_tokens: list[int], max_new_tokens: int,
                 eos_ids: set[int] | None = None) -> list[int]:
        p = self.p
        st = self.target.new_seq()
        sd = self.draft.new_seq()
        out: list[int] = []
        try:
            tgt_logits = self.target.prefill(st, list(prompt_tokens))
            self.draft.prefill(sd, list(prompt_tokens))
            self.stats.n_target_calls += 1
            last = int(np.argmax(tgt_logits))
            out.append(last)
            while len(out) < max_new_tokens:
                if eos_ids and last in eos_ids:
                    break
                # --- draft tree ------------------------------------------
                # branch = [fork of sd, proposed tokens, next feed token]
                branches = [[self.draft.fork_seq(sd), [], last]]
                for _ in range(p.n_draft):
                    live = [b for b in branches if b[2] is not None]
                    if not live:
                        break
                    logits = self.draft.decode([b[0] for b in live],
                                               [b[2] for b in live])
                    new_branches = []
                    for b, lg in zip(live, logits):
                        probs = _softmax(np.asarray(lg))
                        order = np.argsort(-probs)
                        t1, t2 = int(order[0]), int(order[1])
                        if probs[t1] < p.p_min:
                            b[2] = None  # dead end: stop extending
                            continue
                        if (len(branches) + len(new_branches) < p.n_seq_dft
                                and probs[t2] > p.p_split):
                            nb = [self.draft.fork_seq(b[0]),
                                  b[1] + [t2], t2]
                            new_branches.append(nb)
                            self.n_splits += 1
                            self.stats.n_drafted += 1  # the forked t2 only
                        b[1] = b[1] + [t1]
                        b[2] = t1
                        self.stats.n_drafted += 1
                    branches.extend(new_branches)
                for b in branches:
                    self.draft.free_seq(b[0])
                # --- verify every branch against the target ---------------
                # (row 0 of any branch's teacher-forced logits is the
                # target's distribution after `last`, so the empty-candidate
                # fallback needs no extra prefill)
                base = st.n_cached
                best = None
                for b in branches:
                    toks = b[1]
                    if not toks:
                        continue
                    logits = self.target.prefill(st, [last] + toks,
                                                 all_logits=True)
                    self.stats.n_target_calls += 1
                    if best is None:
                        best = ([], int(np.argmax(logits[0])))
                    n_acc = 0
                    for i, dt in enumerate(toks):
                        if int(np.argmax(logits[i])) == dt:
                            n_acc += 1
                        else:
                            break
                    cand = (toks[:n_acc], int(np.argmax(logits[n_acc])))
                    if len(cand[0]) > len(best[0]):
                        best = cand
                    SpeculativeDecoder._truncate(st, base, self.target)
                if best is None:  # no branch proposed anything
                    logits = self.target.prefill(st, [last], all_logits=True)
                    self.stats.n_target_calls += 1
                    best = ([], int(np.argmax(logits[-1])))
                    SpeculativeDecoder._truncate(st, base, self.target)
                accepted, bonus = best
                self.stats.n_accepted += len(accepted)
                # commit the winning path into both caches
                self.target.prefill(st, [last] + accepted)
                self.stats.n_target_calls += 1
                self.draft.prefill(sd, [last] + accepted)
                for t in accepted + [bonus]:
                    out.append(t)
                    if eos_ids and t in eos_ids:
                        return out
                    if len(out) >= max_new_tokens:
                        break
                last = out[-1]
            return out
        finally:
            self.target.free_seq(st)
            self.draft.free_seq(sd)
