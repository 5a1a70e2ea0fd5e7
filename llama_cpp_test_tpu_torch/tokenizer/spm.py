"""Copy of llama_cpp_test_tpu/tokenizer/spm.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

SentencePiece-style tokenizer: greedy agglomerative bigram merging.

Algorithm (reference llm_tokenizer_spm, llama-vocab.cpp:107): split the text
into UTF-8 characters, repeatedly merge the adjacent pair whose concatenation
is a vocab token with the highest score (ties -> leftmost), then emit ids;
characters with no vocab entry fall back to byte tokens <0xNN>.
"""
from __future__ import annotations

import heapq

from .vocab import TokenType, Vocab

_WS = "▁"  # '▁'


class SPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def tokenize(self, text: str, is_first: bool = True) -> list[int]:
        if not text:
            return []
        if self.vocab.add_space_prefix and text:
            text = " " + text
        text = text.replace(" ", _WS)

        # initial symbols: utf-8 characters (as python chars)
        syms: list[str | None] = list(text)
        prev = list(range(-1, len(syms) - 1))
        nxt = list(range(1, len(syms) + 1))
        n = len(syms)

        t2i = self.vocab.token_to_id
        scores = self.vocab.scores

        heap: list[tuple[float, int, int, str]] = []

        def try_pair(i: int):
            j = nxt[i]
            if j >= n or syms[i] is None or syms[j] is None:
                return
            merged = syms[i] + syms[j]
            tid = t2i.get(merged)
            if tid is not None and scores is not None:
                # max-heap on score; tie -> smallest left index
                heapq.heappush(heap, (-float(scores[tid]), i, len(merged), merged))

        for i in range(n - 1):
            try_pair(i)

        while heap:
            _, i, mlen, merged = heapq.heappop(heap)
            if syms[i] is None:
                continue
            j = nxt[i]
            if j >= n or syms[j] is None:
                continue
            if len(syms[i]) + len(syms[j]) != mlen or syms[i] + syms[j] != merged:
                continue  # stale entry
            syms[i] = merged
            syms[j] = None
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prev[nxt[j]] = i
            if prev[i] >= 0:
                try_pair(prev[i])
            try_pair(i)

        ids: list[int] = []
        i = 0
        while i < n:
            s = syms[i]
            if s is not None:
                self._resegment(s, ids)
            i = nxt[i] if i < len(nxt) else i + 1
        return ids

    def _resegment(self, s: str, out: list[int]) -> None:
        tid = self.vocab.token_to_id.get(s)
        if tid is not None:
            out.append(tid)
            return
        # fall back to byte tokens
        for b in s.encode("utf-8"):
            bid = self.vocab.byte_tokens.get(b)
            if bid is not None:
                out.append(bid)
            else:
                out.append(self.vocab.unk_id)

    # -- decoding -----------------------------------------------------------

    def token_to_bytes(self, token_id: int, special: bool = False) -> bytes:
        v = self.vocab
        if not (0 <= token_id < v.n_tokens):
            return b""
        tt = TokenType(int(v.token_types[token_id])) if v.token_types is not None else TokenType.NORMAL
        piece = v.tokens[token_id]
        if tt == TokenType.BYTE:
            return bytes([int(piece[1:-1], 16)])
        if tt in (TokenType.CONTROL, TokenType.UNKNOWN):
            return piece.encode() if special else b""
        return piece.replace(_WS, " ").encode("utf-8")

    def token_to_piece(self, token_id: int, special: bool = False) -> str:
        return self.token_to_bytes(token_id, special=True).decode("utf-8", "replace")
