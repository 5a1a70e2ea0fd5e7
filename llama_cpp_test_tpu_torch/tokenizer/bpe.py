"""Copy of llama_cpp_test_tpu/tokenizer/bpe.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

Byte-level BPE tokenizer with per-model pretokenizer regexes.

The analogue of the reference's llm_tokenizer_bpe (llama-vocab.cpp:276):
text is split by a model-specific regex (tokenizer.ggml.pre selects it),
each fragment is byte-mapped into the GPT-2 unicode space, then merged by
merge-rank. Regexes are format facts of each model family.
"""
from __future__ import annotations

import functools
import re
import unicodedata

from .vocab import TokenType, Vocab

# Pretokenizer regex sets, mirroring the reference table
# (llama-vocab.cpp:296-420, LLAMA_VOCAB_PRE_TYPE_* cases). Applied in order;
# text between matches stays as its own fragment. These strings are model
# format facts (most originate in each model's tokenizer.json).
# fmt: off
_GPT2_RE = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"
_LLAMA3_RE = r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
_QWEN2_RE = r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
# written with explicit codepoint escapes: several polytonic-Greek endpoints
# (U+1F7D, U+1FB4, ...) NFC-normalize to basic-Greek codepoints if pasted as
# literal text, silently corrupting the ranges (byte-exact vs the reference
# llama-vocab.cpp DEEPSEEK_LLM class)
_DSEEK_LETTERS = (
    "A-Za-z\u00B5\u00C0-\u00D6\u00D8-\u00F6\u00F8-\u01BA\u01BC-\u01BF"
    "\u01C4-\u0293\u0295-\u02AF\u0370-\u0373\u0376\u0377\u037B-\u037D"
    "\u037F\u0386\u0388-\u038A\u038C\u038E-\u03A1\u03A3-\u03F5\u03F7-"
    "\u0481\u048A-\u052F\u0531-\u0556\u10A0-\u10C5\u13A0-\u13F5\u13F8"
    "-\u13FD\u1C90-\u1CBA\u1CBD-\u1CBF\u1D00-\u1D2B\u1D6B-\u1D77"
    "\u1D79-\u1D9A\u1E00-\u1F15\u1F18-\u1F1D\u1F20-\u1F45\u1F48-"
    "\u1F4D\u1F50-\u1F57\u1F59\u1F5B\u1F5D\u1F5F-\u1F7D\u1F80-\u1FB4"
    "\u1FB6-\u1FBC\u1FBE\u1FC2-\u1FC4\u1FC6-\u1FCC\u1FD0-\u1FD3\u1FD6"
    "-\u1FDB\u1FE0-\u1FEC\u1FF2-\u1FF4\u1FF6-\u1FFC\u2102\u2107\u210A"
    "-\u2113\u2115\u2119-\u211D\u2124\u2126\u2128\u212A-\u212D\u212F-"
    "\u2134\u2139\u213C-\u213F\u2145-\u2149\u214E\u2183\u2184\u2C00-"
    "\u2C7B\u2C7E-\u2CE4\u2CEB-\u2CEE\u2CF2\u2CF3\uA640-\uA66D\uA680-"
    "\uA69B\uA722-\uA76F\uA771-\uA787\uA78B-\uA78E\uAB70-\uABBF\uFB00"
    "-\uFB06\uFB13-\uFB17\uFF21-\uFF3A\uFF41-\uFF5A\U00010400-"
    "\U0001044F\U000104B0-\U000104D3\U000104D8-\U000104FB\U00010C80-"
    "\U00010CB2\U00010CC0-\U00010CF2\U000118A0-\U000118DF\U0001E900-"
    "\U0001E943"
)
_PRE_REGEX = {
    "default": [_GPT2_RE],
    "gpt-2": [_GPT2_RE],
    "mpt": [_GPT2_RE],
    "olmo": [_GPT2_RE],
    "jais": [_GPT2_RE],
    "starcoder": [r"\p{N}", _GPT2_RE],
    "refact": [r"\p{N}", _GPT2_RE],
    "command-r": [r"\p{N}", _GPT2_RE],
    "smollm": [r"\p{N}", _GPT2_RE],
    "codeshell": [r"\p{N}", _GPT2_RE],
    "llama3": [_LLAMA3_RE],
    "llama-v3": [_LLAMA3_RE],
    "llama-bpe": [_LLAMA3_RE],
    "falcon3": [_LLAMA3_RE],
    "qwen2": [_QWEN2_RE],
    "stablelm2": [_QWEN2_RE],
    "deepseek-r1-qwen": [_QWEN2_RE],
    "gpt-4o": [r"[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))*((?=[\p{L}])([a-z]))+(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?|[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^A-Z]))*((?=[\p{L}])([A-Z]))+(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"],
    "falcon": [r"[\p{P}\$\+<=>\^~\|`]+", _GPT2_RE, r"[0-9][0-9][0-9]"],
    "deepseek-llm": [r"[\r\n]", rf"\s?[{_DSEEK_LETTERS}]+", r"\s?[!-/:-~！-／：-～‘-‟　-。]+", r"\s+$", r"[一-龥ࠀ-一가-퟿]+", r"\p{N}+"],
    "deepseek-coder": [r"[\r\n]", r"\s?\p{L}+", r"\s?\p{P}+", r"[一-龥ࠀ-一가-퟿]+", r"\p{N}"],
    "deepseek3-llm": [r"\p{N}{1,3}", r"[一-龥぀-ゟ゠-ヿ]+", r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"],
    "chameleon": [r"<sentinel:[0-9]+>", r"(IMGIMG)((A|B|C|D|E|F|G|H|I){1,4})Z", r"([\t\n]|    |  )", r"\p{N}", _GPT2_RE],
}
# pre types where the whole pretokenized word is looked up in the vocab
# before running merges (tokenizer.json `ignore_merges`)
IGNORE_MERGES_PRES = {"llama3", "llama-v3", "llama-bpe", "falcon3"}
# fmt: on


# The pretokenizer patterns above are written for the `regex` module
# (\p{..} classes, Unicode White_Space for \s). The port compiles them
# with the standard library's `re`: each \p{X} becomes a class of code-point
# ranges built from unicodedata.category, and \s / \S the White_Space set,
# since re's \s also takes U+001C-U+001F. The rest of the syntax (classes,
# lookaheads, {m,n}) is common to both.
_CATEGORIES = {"L": ("Lu", "Ll", "Lt", "Lm", "Lo"), "N": ("Nd", "Nl", "No"),
               "P": ("Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po"),
               "S": ("Sm", "Sc", "Sk", "So"), "M": ("Mn", "Mc", "Me")}
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))


def _escape(c: int) -> str:
    return f"\\u{c:04X}" if c <= 0xFFFF else f"\\U{c:08X}"


def _ranges_class(ranges) -> str:
    """Code-point ranges as the inside of a character class."""
    return "".join(_escape(a) if a == b else f"{_escape(a)}-{_escape(b)}"
                   for a, b in ranges)


@functools.lru_cache(maxsize=1)
def _unicode_classes() -> dict[str, str]:
    """The inside of a character class for each \\p{X} of _CATEGORIES,
    by this Python's unicodedata tables, as compressed code-point ranges
    (one pass over every code point)."""
    of = {c: k for k, cats in _CATEGORIES.items() for c in cats}
    ranges = {k: [] for k in _CATEGORIES}
    cur, start = None, 0
    for c in range(0x110001):
        k = of.get(unicodedata.category(chr(c))) if c <= 0x10FFFF else None
        if k != cur:
            if cur is not None:
                ranges[cur].append((start, c - 1))
            cur, start = k, c
    return {k: _ranges_class(r) for k, r in ranges.items()}


def unicode_class(name: str) -> str:
    """The inside of a character class for \\p{name} (L, N, P, S or M)."""
    return _unicode_classes()[name]


def translate_pattern(pat: str) -> str:
    """A `regex`-module pretokenizer pattern in stdlib `re` syntax."""
    out, i, in_class = [], 0, False
    ws = _ranges_class(_WHITE_SPACE)
    while i < len(pat):
        ch = pat[i]
        if ch == "\\":
            nxt = pat[i + 1]
            if nxt == "p":
                end = pat.index("}", i)
                body = unicode_class(pat[i + 3:end])
                out.append(body if in_class else f"[{body}]")
                i = end + 1
                continue
            if nxt in "sS":
                if in_class and nxt == "S":
                    raise ValueError(f"\\S inside a class: {pat!r}")
                neg = "^" if nxt == "S" else ""
                out.append(ws if in_class else f"[{neg}{ws}]")
                i += 2
                continue
            out.append(pat[i:i + 2])
            i += 2
            continue
        if not in_class and ch == "[":
            in_class = True
            out.append(ch)
            i += 1
            # a ']' right after '[' or '[^' is a literal
            if i < len(pat) and pat[i] == "^":
                out.append("^")
                i += 1
            if i < len(pat) and pat[i] == "]":
                out.append("\\]")
                i += 1
            continue
        if in_class and ch == "]":
            in_class = False
        out.append(ch)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=None)
def compile_pattern(pat: str) -> "re.Pattern":
    return re.compile(translate_pattern(pat))


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte <-> unicode char bijection (format fact)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


class BPETokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.ranks: dict[tuple[str, str], int] = {}
        for i, m in enumerate(vocab.merges or []):
            a, _, b = m.partition(" ")
            self.ranks[(a, b)] = i
        pres = _PRE_REGEX.get(vocab.pre) or _PRE_REGEX["default"]
        self._pats = [compile_pattern(p) for p in pres]

    def _pretokenize(self, text: str) -> list[str]:
        frags = [text]
        for pat in self._pats:
            out = []
            for frag in frags:
                pos = 0
                for m in pat.finditer(frag):
                    if m.start() > pos:
                        out.append(frag[pos : m.start()])
                    out.append(m.group(0))
                    pos = m.end()
                if pos < len(frag):
                    out.append(frag[pos:])
            frags = out
        return frags

    def _bpe(self, word: list[str]) -> list[str]:
        while len(word) > 1:
            best = None
            best_rank = None
            for i in range(len(word) - 1):
                r = self.ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            merged = word[best] + word[best + 1]
            # merge every occurrence of this exact pair left-to-right
            out = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] + word[i + 1] == merged and \
                        self.ranks.get((word[i], word[i + 1])) == best_rank:
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        return word

    def tokenize(self, text: str, is_first: bool = True) -> list[int]:
        if not text:
            return []
        b2u = bytes_to_unicode()
        t2i = self.vocab.token_to_id
        ids: list[int] = []
        for frag in self._pretokenize(text):
            mapped = "".join(b2u[b] for b in frag.encode("utf-8"))
            for piece in self._bpe(list(mapped)):
                tid = t2i.get(piece)
                if tid is not None:
                    ids.append(tid)
                else:
                    for ch in piece:
                        cid = t2i.get(ch)
                        ids.append(cid if cid is not None else self.vocab.unk_id)
        return ids

    # -- decoding -----------------------------------------------------------

    def token_to_bytes(self, token_id: int, special: bool = False) -> bytes:
        v = self.vocab
        if not (0 <= token_id < v.n_tokens):
            return b""
        tt = TokenType(int(v.token_types[token_id])) if v.token_types is not None else TokenType.NORMAL
        piece = v.tokens[token_id]
        if tt in (TokenType.CONTROL, TokenType.UNKNOWN, TokenType.USER_DEFINED):
            return piece.encode() if special or tt == TokenType.USER_DEFINED else b""
        u2b = unicode_to_bytes()
        return bytes(u2b.get(ch, ord("?") if ord(ch) < 256 else 0x3F) for ch in piece)

    def token_to_piece(self, token_id: int, special: bool = False) -> str:
        return self.token_to_bytes(token_id, special=True).decode("utf-8", "replace")
