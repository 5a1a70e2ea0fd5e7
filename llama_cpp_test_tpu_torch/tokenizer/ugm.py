"""Copy of llama_cpp_test_tpu/tokenizer/ugm.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

Unigram (UGM) tokenizer — T5 family.

Behavioral port of the reference's UGM Viterbi tokenizer
(llama-vocab.cpp:718 llm_tokenizer_ugm_session): SentencePiece unigram —
walk the normalized text one codepoint at a time, extend every prefix
tokenization with each vocab token matching at that offset (scored by the
token's log-prob), fall back to a single-codepoint unknown token with a
fixed penalty, then backtrack the best path.

Normalization: spaces are escaped to U+2581; a leading escaped space is
added when add_space_prefix. The reference additionally applies the
sentencepiece precompiled_charsmap (XCDA) when present in the GGUF; this
implementation applies the common subset (NFKC) instead.
"""
from __future__ import annotations

import unicodedata

UNKNOWN_PENALTY = 10.0


class UGMTokenizer:
    def __init__(self, vocab):
        self.vocab = vocab
        scores = vocab.scores
        self.scores = scores
        self.max_len = max((len(t) for t in vocab.tokens), default=1)
        tt = vocab.token_types
        normal = []
        if scores is not None and tt is not None:
            from .vocab import TokenType

            for i, t in enumerate(vocab.tokens):
                if int(tt[i]) == int(TokenType.NORMAL):
                    normal.append(float(scores[i]))
        min_score = min(normal) if normal else 0.0
        self.unknown_score = min_score - UNKNOWN_PENALTY

    def _normalize(self, text: str, is_first: bool) -> str:
        t = unicodedata.normalize("NFKC", text)
        t = t.replace(" ", "▁")
        if is_first and self.vocab.add_space_prefix and t and \
                not t.startswith("▁"):
            t = "▁" + t
        return t

    def tokenize(self, text: str, is_first: bool = False) -> list[int]:
        v = self.vocab
        t2i = v.token_to_id
        s = self._normalize(text, is_first)
        n = len(s)
        if n == 0:
            return []
        NEG = float("-inf")
        # best[i] = (score, token_id, start) for the best tokenization of s[:i]
        best = [(NEG, -1, 0)] * (n + 1)
        best[0] = (0.0, -1, 0)
        for i in range(n):
            sc_i = best[i][0]
            if sc_i == NEG:
                continue
            found_single = False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                tid = t2i.get(s[i:j])
                if tid is None:
                    continue
                if j == i + 1:
                    found_single = True
                tok_score = float(self.scores[tid]) if self.scores is not None \
                    else 0.0
                cand = sc_i + tok_score
                if cand > best[j][0]:
                    best[j] = (cand, tid, i)
            if not found_single:
                # unknown single codepoint with penalty
                cand = sc_i + self.unknown_score
                if cand > best[i + 1][0]:
                    best[i + 1] = (cand, v.unk_id, i)
        # backtrack
        out: list[int] = []
        i = n
        while i > 0:
            _, tid, start = best[i]
            out.append(tid)
            i = start
        out.reverse()
        # merge consecutive unknowns (reference merges them into one token)
        merged: list[int] = []
        for tid in out:
            if merged and tid == v.unk_id and merged[-1] == v.unk_id:
                continue
            merged.append(tid)
        return merged

    def token_to_piece(self, token_id: int, special: bool = False) -> str:
        t = self.vocab.tokens[token_id]
        return t.replace("▁", " ")

    def token_to_bytes(self, token_id: int, special: bool = False) -> bytes:
        return self.token_to_piece(token_id, special).encode("utf-8")


class RWKVTokenizer:
    """RWKV world-vocab trie tokenizer (llama-vocab.cpp:1122
    llm_tokenizer_rwkv_session): greedy longest byte-string match over the
    raw vocab entries."""

    def __init__(self, vocab):
        self.vocab = vocab
        self.byte_vocab = {}
        for i, t in enumerate(vocab.tokens):
            self.byte_vocab[_rwkv_token_bytes(t)] = i
        self.max_len = max((len(b) for b in self.byte_vocab), default=1)

    def tokenize(self, text: str, is_first: bool = False) -> list[int]:
        data = text.encode("utf-8")
        out: list[int] = []
        i = 0
        n = len(data)
        while i < n:
            match = None
            for j in range(min(n, i + self.max_len), i, -1):
                tid = self.byte_vocab.get(data[i:j])
                if tid is not None:
                    match = (tid, j)
                    break
            if match is None:
                i += 1  # unmatchable byte: skip (vocab covers all bytes)
                continue
            out.append(match[0])
            i = match[1]
        return out

    def token_to_piece(self, token_id: int, special: bool = False) -> str:
        return self.token_to_bytes(token_id, special).decode(
            "utf-8", errors="replace")

    def token_to_bytes(self, token_id: int, special: bool = False) -> bytes:
        return _rwkv_token_bytes(self.vocab.tokens[token_id])


def _rwkv_token_bytes(t: str) -> bytes:
    """RWKV gguf vocabs store tokens as raw strings (possibly with byte
    escapes already resolved by the converter)."""
    return t.encode("utf-8")
