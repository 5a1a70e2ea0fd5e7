"""Copy of llama_cpp_test_tpu/tokenizer/wpm.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

WordPiece tokenizer (BERT family).

Behavioral port of the reference's WPM algorithm (llama-vocab.cpp:602
llm_tokenizer_wpm_session): NFD-normalize, lowercase, drop control chars and
combining marks via lowercase NFD, split words on whitespace with
punctuation/symbol/CJK codepoints as single-char words, prepend the phantom
space marker (U+2581) to each word, then greedy longest-match against the
vocab; a word with any unmatched position collapses to UNK.
"""
from __future__ import annotations

import unicodedata


def _is_chinese_char(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or
        0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F or
        0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF or
        0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WPMTokenizer:
    def __init__(self, vocab):
        self.vocab = vocab
        self.max_len = max((len(t) for t in vocab.tokens), default=1)

    # -- preprocessing (reference preprocess(), llama-vocab.cpp:655) --------
    def _preprocess(self, text: str) -> list[str]:
        # the reference's "NFD" maps each codepoint to the FIRST codepoint of
        # its decomposition (unicode.cpp:603-614) — accents simply vanish
        norm = (unicodedata.normalize("NFD", ch)[0] for ch in text)
        words: list[str] = [""]
        for ch in norm:
            cp = ord(ch)
            cat = unicodedata.category(ch)
            if ch.isspace():
                if words[-1]:
                    words.append("")
                continue
            if cp == 0 or cp == 0xFFFD or cat in ("Cc", "Cf"):
                continue
            s = ch.lower()
            is_punct = cat.startswith("P")
            is_symbol = cat.startswith("S")
            if is_punct or (cp < 0x7F and is_symbol) or _is_chinese_char(cp):
                if words[-1]:
                    words.append("")
                words[-1] = s
                words.append("")
            else:
                words[-1] += s
        if words and not words[-1]:
            words.pop()
        return words

    def tokenize(self, text: str, is_first: bool = False) -> list[int]:
        t2i = self.vocab.token_to_id
        out: list[int] = []
        for word in self._preprocess(text):
            if not word:
                continue
            w = "▁" + word
            n = len(w)
            start = len(out)
            i = 0
            matched_all = True
            while i < n:
                match = None
                for j in range(min(n, i + self.max_len + 1), i, -1):
                    tid = t2i.get(w[i:j])
                    if tid is not None:
                        match = (tid, j)
                        break
                if match is None:
                    matched_all = False
                    del out[start:]
                    break
                out.append(match[0])
                i = match[1]
            if not matched_all or len(out) == start:
                out.append(self.vocab.unk_id)
        return out

    # -- decoding ------------------------------------------------------------
    def token_to_piece(self, token_id: int, special: bool = False) -> str:
        t = self.vocab.tokens[token_id]
        return t.replace("▁", " ")

    def token_to_bytes(self, token_id: int, special: bool = False) -> bytes:
        return self.token_to_piece(token_id, special).encode("utf-8")
