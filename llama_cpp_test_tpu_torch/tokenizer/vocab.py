"""Copy of llama_cpp_test_tpu/tokenizer/vocab.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

Vocabulary + tokenizer front-end.

Loads tokenizer state from GGUF metadata (tokenizer.ggml.* keys) and
dispatches to the SPM or BPE algorithm. Handles special-token partitioning
(splitting raw text on control/user-defined tokens before running the
subword algorithm — the analogue of tokenizer_st_partition,
reference llama-vocab.cpp:384).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np


class TokenType(enum.IntEnum):
    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


@dataclasses.dataclass
class Vocab:
    model: str  # 'llama' (spm) | 'gpt2' (bpe) | 'bert' (wpm) | ...
    pre: str  # pretokenizer name for bpe ('default', 'llama3', ...)
    tokens: list[str]
    scores: np.ndarray | None
    token_types: np.ndarray | None
    merges: list[str] | None = None
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 0
    pad_id: int = -1
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    # fill-in-the-middle token ids (reference llama.h:1021-1026
    # llama_vocab_fim_pre/suf/mid/pad/rep/sep; -1 = absent)
    fim_pre_id: int = -1
    fim_suf_id: int = -1
    fim_mid_id: int = -1
    fim_pad_id: int = -1
    fim_rep_id: int = -1
    fim_sep_id: int = -1
    # dedicated end-of-turn token (reference llama-vocab special_eot_id;
    # -1 = absent, callers fall back to eos_id)
    eot_id: int = -1

    def __post_init__(self):
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        tt = self.token_types
        self.special_ids = []
        if tt is not None:
            for i, t in enumerate(tt):
                if t in (TokenType.CONTROL, TokenType.USER_DEFINED, TokenType.UNKNOWN):
                    self.special_ids.append(i)
        # byte token lookup for spm fallback: '<0xNN>'
        self.byte_tokens = {}
        for b in range(256):
            tok = f"<0x{b:02X}>"
            i = self.token_to_id.get(tok)
            if i is not None:
                self.byte_tokens[b] = i

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def is_eog(self, token_id: int) -> bool:
        if token_id == self.eos_id:
            return True
        t = self.tokens[token_id] if 0 <= token_id < len(self.tokens) else ""
        return t in ("<|eot_id|>", "<|im_end|>", "<|end|>", "<end_of_turn>",
                     "<|endoftext|>", "</s>", "<|eom_id|>")


def vocab_from_metadata(md: dict) -> Vocab:
    def get(key, default=None):
        v = md.get(key, default)
        return v

    tokens = list(get("tokenizer.ggml.tokens", []))
    scores = get("tokenizer.ggml.scores")
    if scores is not None:
        scores = np.asarray(scores, dtype=np.float32)
    tt = get("tokenizer.ggml.token_type")
    if tt is not None:
        tt = np.asarray(tt, dtype=np.int32)
    merges = get("tokenizer.ggml.merges")
    if merges is not None:
        merges = list(merges)
    model = get("tokenizer.ggml.model", "llama")

    def fim_id(kind: str, names: tuple[str, ...]) -> int:
        """FIM ids: explicit GGUF key first, then well-known token names
        (the reference falls back the same way in load_vocab)."""
        v = get(f"tokenizer.ggml.fim_{kind}_token_id")
        if v is None:  # legacy keys
            legacy = {"pre": "prefix", "suf": "suffix", "mid": "middle"}
            if kind in legacy:
                v = get(f"tokenizer.ggml.{legacy[kind]}_token_id")
        if v is not None:
            return int(v)
        for i, t in enumerate(tokens):
            if t in names:
                return i
        return -1

    fim_pre = fim_id("pre", ("<|fim_prefix|>", "<fim-prefix>", "<PRE>",
                             "<fim_prefix>", "<｜fim▁begin｜>"))
    fim_suf = fim_id("suf", ("<|fim_suffix|>", "<fim-suffix>", "<SUF>",
                             "<fim_suffix>", "<｜fim▁hole｜>"))
    fim_mid = fim_id("mid", ("<|fim_middle|>", "<fim-middle>", "<MID>",
                             "<fim_middle>", "<｜fim▁end｜>"))

    # dedicated end-of-turn id (reference llama-vocab.cpp special_eot_id:
    # explicit key, else well-known turn-terminator token names)
    eot = get("tokenizer.ggml.eot_token_id")
    if eot is not None:
        eot = int(eot)
    else:
        eot = -1
        for i, t in enumerate(tokens):
            if t in ("<|eot_id|>", "<|im_end|>", "<|end|>", "<end_of_turn>",
                     "<|eom_id|>", "<EOT>"):
                eot = i
                break
    return Vocab(
        model=model,
        pre=get("tokenizer.ggml.pre", "default"),
        tokens=tokens,
        scores=scores,
        token_types=tt,
        merges=merges,
        bos_id=int(get("tokenizer.ggml.bos_token_id", 1)),
        eos_id=int(get("tokenizer.ggml.eos_token_id", 2)),
        unk_id=int(get("tokenizer.ggml.unknown_token_id", 0)),
        pad_id=int(get("tokenizer.ggml.padding_token_id", -1)),
        add_bos=bool(get("tokenizer.ggml.add_bos_token", model == "llama")),
        add_eos=bool(get("tokenizer.ggml.add_eos_token", False)),
        add_space_prefix=bool(get("tokenizer.ggml.add_space_prefix", model == "llama")),
        fim_pre_id=fim_pre,
        fim_suf_id=fim_suf,
        fim_mid_id=fim_mid,
        fim_pad_id=fim_id("pad", ("<|fim_pad|>", "<fim-pad>", "<PAD>")),
        fim_rep_id=fim_id("rep", ("<|fim_repo|>", "<fim-repo>", "<REPO>",
                                  "<|repo_name|>")),
        fim_sep_id=fim_id("sep", ("<|file_sep|>",)),
        eot_id=eot,
    )


class Tokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        if vocab.model == "llama":
            from .spm import SPMTokenizer

            self._impl = SPMTokenizer(vocab)
        elif vocab.model == "gpt2":
            from .bpe import BPETokenizer

            self._impl = BPETokenizer(vocab)
        elif vocab.model == "bert":
            from .wpm import WPMTokenizer

            self._impl = WPMTokenizer(vocab)
        elif vocab.model == "t5":
            from .ugm import UGMTokenizer

            self._impl = UGMTokenizer(vocab)
        elif vocab.model == "rwkv":
            from .ugm import RWKVTokenizer

            self._impl = RWKVTokenizer(vocab)
        else:
            raise NotImplementedError(f"tokenizer model {vocab.model!r}")

    # -- encoding ----------------------------------------------------------

    def _partition_specials(self, text: str, parse_special: bool):
        """Split text into (is_special_id | str) fragments.

        Mirrors tokenizer_st_partition (reference llama-vocab.cpp:2161):
        USER_DEFINED tokens are ALWAYS matched on raw text (neox-style
        multi-space tokens in mpt/olmo/stablelm); CONTROL and UNKNOWN only
        when parse_special is set.
        """
        frags: list = [text]
        tt = self.vocab.token_types
        def enabled(i):
            if parse_special or tt is None:
                return True
            return TokenType(int(tt[i])) == TokenType.USER_DEFINED
        specials = sorted(
            ((self.vocab.tokens[i], i) for i in self.vocab.special_ids
             if self.vocab.tokens[i] and enabled(i)),
            key=lambda kv: -len(kv[0]),
        )
        for tok, tid in specials:
            out = []
            for frag in frags:
                if not isinstance(frag, str) or tok not in frag:
                    out.append(frag)
                    continue
                parts = frag.split(tok)
                for j, p in enumerate(parts):
                    if p:
                        out.append(p)
                    if j < len(parts) - 1:
                        out.append(tid)
            frags = out
        return frags

    def encode(self, text: str, add_special: bool = True,
               parse_special: bool = False) -> list[int]:
        ids: list[int] = []
        frags = self._partition_specials(text, parse_special)
        first_str = True
        for frag in frags:
            if isinstance(frag, int):
                ids.append(frag)
                first_str = False
            else:
                ids.extend(self._impl.tokenize(frag, is_first=first_str))
                first_str = False
        if add_special and self.vocab.add_bos:
            if not ids or ids[0] != self.vocab.bos_id:
                ids.insert(0, self.vocab.bos_id)
        if add_special and self.vocab.add_eos:
            ids.append(self.vocab.eos_id)
        return ids

    # -- decoding ----------------------------------------------------------

    def token_to_piece(self, token_id: int, special: bool = False) -> str:
        return self._impl.token_to_piece(token_id, special)

    def decode(self, ids: Sequence[int], special: bool = False) -> str:
        buf = bytearray()
        for i in ids:
            buf.extend(self._impl.token_to_bytes(int(i), special))
        return buf.decode("utf-8", errors="replace")


def load_tokenizer(reader_or_md) -> Tokenizer:
    md = reader_or_md.metadata if hasattr(reader_or_md, "metadata") else reader_or_md
    return Tokenizer(vocab_from_metadata(md))
