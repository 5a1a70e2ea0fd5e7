"""N-gram cache + prompt-lookup decoding.

Counterpart of llama_cpp_test_tpu/runtime/ngram_cache.py (host Python over
the port's Context; the verification prefill runs K1 and K2 on CUDA).
The common/ngram-cache.{h,cpp} + examples/lookup analogue: a map from
n-grams (sizes ngram_min..ngram_max) to successor-token counts, updated
from the prompt and from generated text, used to draft tokens for free
(no draft model) which the target then verifies in one prefill — the
same accept/rollback loop as speculative decoding.

Three cache tiers mirror the reference (ngram-cache.h:37-45):
  context — built from the current context window (always present)
  dynamic — persisted across runs, updated with generated text
  static  — built offline from a large corpus (lookup-create analogue)
"""
from __future__ import annotations

import struct
from collections import defaultdict
from typing import Optional

import numpy as np

from .engine import Context


class NGramCache:
    """ngram (tuple of ints) -> {successor token: count}."""

    def __init__(self, ngram_min: int = 1, ngram_max: int = 4):
        self.ngram_min = ngram_min
        self.ngram_max = ngram_max
        self.data: dict[tuple[int, ...], dict[int, int]] = defaultdict(dict)

    def update(self, tokens: list[int], n_new: int | None = None) -> None:
        """Count successors for every ngram ending before each of the last
        n_new tokens (common_ngram_cache_update)."""
        n = len(tokens)
        if n_new is None:
            n_new = n
        start = max(self.ngram_max, n - n_new)
        for i in range(start, n):
            tgt = tokens[i]
            for size in range(self.ngram_min, self.ngram_max + 1):
                if i - size < 0:
                    continue
                key = tuple(tokens[i - size: i])
                d = self.data[key]
                d[tgt] = d.get(tgt, 0) + 1

    def best(self, key: tuple[int, ...]) -> tuple[int, int, int]:
        """(token, count, total) for the most frequent successor of key;
        a tie goes to the successor seen first (dict insertion order)."""
        d = self.data.get(key)
        if not d:
            return -1, 0, 0
        tok = max(d, key=d.get)
        return tok, d[tok], sum(d.values())

    # -- persistence (ngram-cache save/load/merge) ---------------------------

    MAGIC = b"NGCA"

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.MAGIC)
            f.write(struct.pack("<iiq", self.ngram_min, self.ngram_max,
                                len(self.data)))
            for key, d in self.data.items():
                f.write(struct.pack("<i", len(key)))
                f.write(np.asarray(key, "<i4").tobytes())
                f.write(struct.pack("<i", len(d)))
                for tok, cnt in d.items():
                    f.write(struct.pack("<iq", tok, cnt))

    @classmethod
    def load(cls, path: str) -> "NGramCache":
        with open(path, "rb") as f:
            if f.read(4) != cls.MAGIC:
                raise ValueError("not an ngram cache file")
            nmin, nmax, n_entries = struct.unpack("<iiq", f.read(16))
            c = cls(nmin, nmax)
            for _ in range(n_entries):
                (klen,) = struct.unpack("<i", f.read(4))
                key = tuple(np.frombuffer(f.read(4 * klen), "<i4").tolist())
                (nv,) = struct.unpack("<i", f.read(4))
                d = {}
                for _ in range(nv):
                    tok, cnt = struct.unpack("<iq", f.read(12))
                    d[tok] = cnt
                c.data[key] = d
        return c

    def merge(self, other: "NGramCache") -> None:
        """common_ngram_cache_merge: add other's counts into self."""
        for key, d in other.data.items():
            mine = self.data[key]
            for tok, cnt in d.items():
                mine[tok] = mine.get(tok, 0) + cnt


def draft_tokens(inp: list[int], n_draft: int,
                 nc_context: NGramCache,
                 nc_dynamic: Optional[NGramCache] = None,
                 nc_static: Optional[NGramCache] = None) -> list[int]:
    """Propose up to n_draft continuation tokens from the caches
    (common_ngram_cache_draft). Tiered heuristic mirroring the reference:
    prefer context-cache hits validated against the static cache; require
    a minimum hit count and majority share for unvalidated draws."""
    drafted = list(inp)
    out: list[int] = []
    for _ in range(n_draft):
        tok = -1
        for size in range(nc_context.ngram_max, nc_context.ngram_min - 1, -1):
            if len(drafted) < size:
                continue
            key = tuple(drafted[-size:])
            cand, cnt, total = nc_context.best(key)
            if cand < 0:
                continue
            if nc_static is not None:
                s_cand, _, _ = nc_static.best(key)
                if s_cand >= 0 and s_cand != cand:
                    continue  # static corpus disagrees: don't trust it
            # minimum evidence: seen >= 2 times or unanimous single hit
            if cnt * 2 >= total and (cnt >= 2 or total == 1):
                tok = cand
                break
            if nc_dynamic is not None:
                d_cand, d_cnt, d_total = nc_dynamic.best(key)
                if d_cand == cand and (cnt + d_cnt) * 2 >= (total + d_total):
                    tok = cand
                    break
        if tok < 0:
            break
        out.append(tok)
        drafted.append(tok)
    return out


class LookupDecoder:
    """Prompt-lookup decoding (examples/lookup/lookup.cpp): ngram drafts
    verified by the target in one all-logits prefill, rejected KV rolled
    back with Context.truncate_seq."""

    def __init__(self, ctx: Context, n_draft: int = 8,
                 ngram_min: int = 1, ngram_max: int = 4,
                 nc_dynamic: Optional[NGramCache] = None,
                 nc_static: Optional[NGramCache] = None):
        self.ctx = ctx
        self.n_draft = n_draft
        self.nc_context = NGramCache(ngram_min, ngram_max)
        self.nc_dynamic = nc_dynamic
        self.nc_static = nc_static
        self.n_drafted = 0
        self.n_accepted = 0

    def generate(self, prompt_tokens: list[int], max_new_tokens: int,
                 eos_ids: set[int] | None = None) -> list[int]:
        ctx = self.ctx
        s = ctx.new_seq()
        out: list[int] = []
        try:
            self.nc_context.update(prompt_tokens)
            logits = ctx.prefill(s, prompt_tokens)
            last = int(np.argmax(logits))
            out.append(last)
            all_toks = list(prompt_tokens) + [last]
            self.nc_context.update(all_toks, n_new=1)
            while len(out) < max_new_tokens:
                if eos_ids and last in eos_ids:
                    break
                draft = draft_tokens(all_toks, self.n_draft,
                                     self.nc_context, self.nc_dynamic,
                                     self.nc_static)
                self.n_drafted += len(draft)
                block = [last] + draft
                logits = ctx.prefill(s, block, all_logits=True)
                n_acc = 0
                for i, dt in enumerate(draft):
                    if int(np.argmax(logits[i])) == dt:
                        n_acc += 1
                    else:
                        break
                self.n_accepted += n_acc
                bonus = int(np.argmax(logits[n_acc]))
                # roll back the rejected tail's KV
                ctx.truncate_seq(s, s.n_cached - len(block) + 1 + n_acc)
                new = draft[:n_acc] + [bonus]
                for t in new:
                    out.append(t)
                    all_toks.append(t)
                    if eos_ids and t in eos_ids:
                        return out
                    if len(out) >= max_new_tokens:
                        break
                self.nc_context.update(all_toks, n_new=len(new))
                if self.nc_dynamic is not None:
                    self.nc_dynamic.update(all_toks, n_new=len(new))
                last = out[-1]
            return out
        finally:
            ctx.free_seq(s)
