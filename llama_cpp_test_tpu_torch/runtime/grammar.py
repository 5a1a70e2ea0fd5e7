"""Copy of llama_cpp_test_tpu/runtime/grammar.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

GBNF grammar-constrained sampling (the llama-grammar analogue,
reference src/llama-grammar.{h,cpp}).

Parses the GBNF dialect (rules, alternatives, sequences, character classes
with ranges and negation, repetition *, +, ?, {m,n}, nested groups, string
literals with escapes) into element lists, then runs the same pushdown
recognizer over UTF-8 codepoints: a set of alternative stacks advances per
character; a token is admissible iff at least one stack survives its whole
piece. Plugs into the sampler chain as GrammarSampler.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

# element types (llama_gretype, llama-grammar.h)
END = 0
ALT = 1
RULE_REF = 2
CHAR = 3
CHAR_NOT = 4
CHAR_RNG_UPPER = 5
CHAR_ALT = 6


@dataclasses.dataclass(frozen=True)
class Elem:
    type: int
    value: int  # codepoint or rule id


class GrammarParser:
    """GBNF text -> {rule_id: [Elem...]} (llama-grammar.cpp parse)."""

    def __init__(self, src: str):
        self.src = src
        self.pos = 0
        self.symbol_ids: dict[str, int] = {}
        self.rules: dict[int, list[Elem]] = {}

    # -- low-level ----------------------------------------------------------

    def _ws(self):
        while self.pos < len(self.src):
            c = self.src[self.pos]
            if c in " \t\r\n":
                self.pos += 1
            elif c == "#":  # comment
                while self.pos < len(self.src) and self.src[self.pos] != "\n":
                    self.pos += 1
            else:
                break

    def _name(self) -> str:
        start = self.pos
        while self.pos < len(self.src) and (
                self.src[self.pos].isalnum() or self.src[self.pos] in "-_"):
            self.pos += 1
        if start == self.pos:
            raise ValueError(f"expected name at {start}: "
                             f"{self.src[start:start+20]!r}")
        return self.src[start:self.pos]

    def _get_symbol(self, name: str) -> int:
        if name not in self.symbol_ids:
            self.symbol_ids[name] = len(self.symbol_ids)
        return self.symbol_ids[name]

    def _gen_symbol(self, base: str) -> int:
        name = f"{base}_{len(self.symbol_ids)}"
        return self._get_symbol(name)

    def _char(self) -> int:
        c = self.src[self.pos]
        if c == "\\":
            self.pos += 1
            e = self.src[self.pos]
            self.pos += 1
            if e == "x":
                v = int(self.src[self.pos:self.pos + 2], 16)
                self.pos += 2
                return v
            if e == "u":
                v = int(self.src[self.pos:self.pos + 4], 16)
                self.pos += 4
                return v
            if e == "U":
                v = int(self.src[self.pos:self.pos + 8], 16)
                self.pos += 8
                return v
            return {"t": 9, "r": 13, "n": 10, "\\": 92, '"': 34, "[": 91,
                    "]": 93, "-": 45}.get(e, ord(e))
        self.pos += 1
        return ord(c)

    # -- grammar structure ----------------------------------------------------

    def parse(self) -> "Grammar":
        self._ws()
        while self.pos < len(self.src):
            self._rule()
            self._ws()
        if "root" not in self.symbol_ids:
            raise ValueError("grammar has no 'root' rule")
        missing = [n for n, i in self.symbol_ids.items()
                   if i not in self.rules]
        if missing:
            raise ValueError(f"undefined rules: {missing}")
        return Grammar(self.rules, self.symbol_ids["root"])

    def _rule(self):
        name = self._name()
        rule_id = self._get_symbol(name)
        self._ws()
        if self.src[self.pos:self.pos + 3] == "::=":
            self.pos += 3
        else:
            raise ValueError(f"expected ::= after {name}")
        self._ws()
        elems = self._alternates(rule_id, name)
        self.rules[rule_id] = elems

    def _alternates(self, rule_id: int, name: str) -> list[Elem]:
        out = self._sequence(name)
        self._ws()
        while self.pos < len(self.src) and self.src[self.pos] == "|":
            self.pos += 1
            self._ws()
            out.append(Elem(ALT, 0))
            out.extend(self._sequence(name))
            self._ws()
        out.append(Elem(END, 0))
        return out

    def _sequence(self, name: str) -> list[Elem]:
        out: list[Elem] = []
        while self.pos < len(self.src):
            self._ws_inline()
            if self.pos >= len(self.src):
                break
            c = self.src[self.pos]
            if c == '"':
                self.pos += 1
                while self.src[self.pos] != '"':
                    out.append(Elem(CHAR, self._char()))
                self.pos += 1
            elif c == "[":
                self.pos += 1
                neg = self.src[self.pos] == "^"
                if neg:
                    self.pos += 1
                first = True
                while self.src[self.pos] != "]":
                    lo = self._char()
                    t = (CHAR_NOT if neg and first else
                         CHAR if first else CHAR_ALT)
                    out.append(Elem(t, lo))
                    first = False
                    if self.src[self.pos] == "-" and \
                            self.src[self.pos + 1] != "]":
                        self.pos += 1
                        hi = self._char()
                        out.append(Elem(CHAR_RNG_UPPER, hi))
                self.pos += 1
            elif c == "(":
                self.pos += 1
                self._ws()
                sub_id = self._gen_symbol(name)
                self.rules[sub_id] = self._alternates(sub_id, name)
                if self.src[self.pos] != ")":
                    raise ValueError(f"expected ) at {self.pos}")
                self.pos += 1
                out.append(Elem(RULE_REF, sub_id))
            elif c.isalnum() or c in "-_":
                ref = self._get_symbol(self._name())
                out.append(Elem(RULE_REF, ref))
            else:
                break
            # repetition operators bind to the last atom
            self._maybe_repeat(out, name)
        return out

    def _ws_inline(self):
        while self.pos < len(self.src) and self.src[self.pos] in " \t":
            self.pos += 1
        if self.pos < len(self.src) and self.src[self.pos] == "#":
            while self.pos < len(self.src) and self.src[self.pos] != "\n":
                self.pos += 1

    def _last_atom(self, out: list[Elem]) -> list[Elem]:
        """Pop the trailing atom (single char class or ref) from out."""
        if not out:
            raise ValueError("repetition with no preceding atom")
        if out[-1].type == RULE_REF or out[-1].type == CHAR:
            return [out.pop()]
        # char class: walk back to its CHAR/CHAR_NOT head
        i = len(out) - 1
        while i >= 0 and out[i].type in (CHAR_ALT, CHAR_RNG_UPPER):
            i -= 1
        atom = out[i:]
        del out[i:]
        return atom

    def _maybe_repeat(self, out: list[Elem], name: str):
        if self.pos >= len(self.src):
            return
        c = self.src[self.pos]
        if c not in "*+?{":
            return
        atom = self._last_atom(out)
        if c == "{":
            self.pos += 1
            start = self.pos
            while self.src[self.pos] not in ",}":
                self.pos += 1
            m = int(self.src[start:self.pos] or 0)
            if self.src[self.pos] == ",":
                self.pos += 1
                start = self.pos
                while self.src[self.pos] != "}":
                    self.pos += 1
                rest = self.src[start:self.pos]
                n = int(rest) if rest else -1
            else:
                n = m
            self.pos += 1
        else:
            self.pos += 1
            m, n = {"*": (0, -1), "+": (1, -1), "?": (0, 1)}[c]
        # expand: m copies + (n-m) optionals, or a recursive star rule
        expanded: list[Elem] = []
        for _ in range(m):
            expanded.extend(atom)
        if n < 0:
            star_id = self._gen_symbol(name)
            # star ::= atom star |
            self.rules[star_id] = (list(atom) + [Elem(RULE_REF, star_id),
                                                 Elem(ALT, 0), Elem(END, 0)])
            expanded.append(Elem(RULE_REF, star_id))
        else:
            for _ in range(n - m):
                opt_id = self._gen_symbol(name)
                self.rules[opt_id] = list(atom) + [Elem(ALT, 0), Elem(END, 0)]
                expanded.append(Elem(RULE_REF, opt_id))
        out.extend(expanded)


def _class_match(elems: list[Elem], i: int, cp: int) -> tuple[bool, int]:
    """Match codepoint against the char class starting at i; returns
    (matched, next_index_after_class)."""
    e = elems[i]
    neg = e.type == CHAR_NOT
    found = False
    lo = e.value
    j = i + 1
    # first range
    if j < len(elems) and elems[j].type == CHAR_RNG_UPPER:
        found |= lo <= cp <= elems[j].value
        j += 1
    else:
        found |= cp == lo
    while j < len(elems) and elems[j].type in (CHAR_ALT, CHAR_RNG_UPPER):
        if elems[j].type == CHAR_ALT:
            lo = elems[j].value
            if j + 1 < len(elems) and elems[j + 1].type == CHAR_RNG_UPPER:
                found |= lo <= cp <= elems[j + 1].value
                j += 2
            else:
                found |= cp == lo
                j += 1
        else:
            j += 1
    return (not found) if neg else found, j


class Grammar:
    """Pushdown recognizer state (llama_grammar advance/accept)."""

    def __init__(self, rules: dict[int, list[Elem]], root: int):
        self.rules = rules
        self.root = root
        self.stacks: list[tuple] = []
        self.reset()

    def reset(self):
        self.stacks = []
        self._push_alternatives((), self.root)

    def _push_alternatives(self, base: tuple, rule_id: int):
        """Push each alternative of rule_id onto base (expanding refs)."""
        elems = self.rules[rule_id]
        start = 0
        for i, e in enumerate(elems):
            if e.type in (ALT, END):
                self._advance_stack(base + ((rule_id, start),))
                start = i + 1

    def _advance_stack(self, stack: tuple):
        """Normalize: expand leading RULE_REFs / drop exhausted frames so the
        top of every stack is a char class (or the stack is empty)."""
        while stack:
            rule_id, idx = stack[-1]
            elems = self.rules[rule_id]
            e = elems[idx]
            if e.type in (ALT, END):
                stack = stack[:-1]
                continue
            if e.type == RULE_REF:
                rest = stack[:-1] + ((rule_id, self._after_atom(rule_id, idx)),)
                # expand each alternative of the referenced rule
                sub = self.rules[e.value]
                start = 0
                for i, se in enumerate(sub):
                    if se.type in (ALT, END):
                        self._advance_stack(rest + ((e.value, start),))
                        start = i + 1
                return
            # char class on top
            if stack not in self.stacks:
                self.stacks.append(stack)
            return
        if stack not in self.stacks:
            self.stacks.append(stack)

    def _after_atom(self, rule_id: int, idx: int) -> int:
        elems = self.rules[rule_id]
        e = elems[idx]
        if e.type == RULE_REF:
            return idx + 1
        # char class: skip trailing alts/ranges
        j = idx + 1
        while j < len(elems) and elems[j].type in (CHAR_ALT, CHAR_RNG_UPPER):
            j += 1
        return j

    def accept_char(self, cp: int) -> bool:
        """Advance all stacks by one codepoint; False if nothing survives."""
        old, self.stacks = self.stacks, []
        for stack in old:
            if not stack:
                continue  # already-complete stack cannot consume more input
            rule_id, idx = stack[-1]
            elems = self.rules[rule_id]
            ok, _ = _class_match(elems, idx, cp)
            if ok:
                nxt = stack[:-1] + ((rule_id, self._after_atom(rule_id, idx)),)
                self._advance_stack(nxt)
        if not self.stacks:
            self.stacks = []
            return False
        # dedupe
        seen = set()
        uniq = []
        for s in self.stacks:
            if s not in seen:
                seen.add(s)
                uniq.append(s)
        self.stacks = uniq
        return True

    def accepts_text(self, text: str) -> bool:
        save = list(self.stacks)
        ok = all(self.accept_char(ord(c)) for c in text)
        self.stacks = save
        return ok

    def can_finish(self) -> bool:
        return any(not s for s in self.stacks) or not self.stacks

    def is_complete(self) -> bool:
        """At least one stack fully consumed (empty)."""
        return any(len(s) == 0 for s in self.stacks)


class GrammarSampler:
    """Sampler-chain element: masks tokens the grammar rejects
    (llama_sampler_init_grammar analogue).

    Lazy mode (llama_sampler_init_grammar_lazy_patterns analogue, reference
    src/llama-grammar.h:124-132): the grammar waits for a trigger before
    constraining — output is buffered, and when a trigger token fires or a
    trigger word/pattern matches the buffered text, the grammar is fed the
    text from the trigger onward and sampling becomes constrained. Used for
    tool-call formats where free text precedes a structured block.
    """

    def __init__(self, grammar_text: str, tokenizer, *, lazy: bool = False,
                 trigger_words: tuple = (), trigger_tokens: tuple = (),
                 trigger_patterns: tuple = ()):
        self.text = grammar_text
        self.tok = tokenizer
        self.grammar = GrammarParser(grammar_text).parse()
        self._piece_cache: dict[int, str] = {}
        self.lazy = bool(lazy)
        self.awaiting_trigger = self.lazy
        self.trigger_buffer = ""
        self.trigger_tokens = tuple(int(t) for t in trigger_tokens)
        # words become anchored patterns like the reference's
        # llama_sampler_init_grammar_lazy (word match anywhere, constrained
        # text starts AT the word)
        import re as _re

        pats = [(_re.compile(p), True) for p in trigger_patterns]
        pats += [(_re.compile(".*?(" + _re.escape(w) + ")", _re.DOTALL),
                  True) for w in trigger_words]
        self.trigger_patterns = pats

    def reset(self):
        self.grammar.reset()
        self.awaiting_trigger = self.lazy
        self.trigger_buffer = ""

    def _feed(self, text: str) -> None:
        for c in text:
            if not self.grammar.accept_char(ord(c)):
                break

    def _check_trigger(self) -> None:
        for pat, _ in self.trigger_patterns:
            mm = pat.match(self.trigger_buffer)
            if mm is not None:
                start = mm.start(1) if mm.groups() else mm.start()
                self.awaiting_trigger = False
                self._feed(self.trigger_buffer[start:])
                self.trigger_buffer = ""
                return

    def _piece(self, tid: int) -> str:
        p = self._piece_cache.get(tid)
        if p is None:
            p = self.tok.token_to_piece(int(tid))
            self._piece_cache[tid] = p
        return p

    def apply(self, st) -> None:
        if self.awaiting_trigger:
            return  # unconstrained until a trigger fires
        eog = getattr(self.tok, "vocab", None)
        keep = np.zeros(len(st.ids), bool)
        for i, tid in enumerate(st.ids):
            piece = self._piece(int(tid))
            if not piece:
                # EOG allowed only when the grammar can complete
                keep[i] = self.grammar.is_complete()
                continue
            keep[i] = self.grammar.accepts_text(piece)
        if keep.any():
            st.logits = np.where(keep, st.logits, -np.inf)
        else:
            # nothing in the candidate set is grammar-legal. On the
            # full-vocab host path this fails OPEN (a stuck grammar must
            # not dead-end generation); candidate-download callers check
            # the flag and fall back to full logits instead
            # (SamplerChain.sample_candidates).
            st.all_rejected = True
        st.sorted_ = False
        st.probs = None

    def accept(self, token: int) -> None:
        piece = self._piece(int(token))
        if self.awaiting_trigger:
            if int(token) in self.trigger_tokens:
                # trigger token: constrained text starts WITH its piece
                self.awaiting_trigger = False
                self.trigger_buffer = ""
                self._feed(piece)
                return
            self.trigger_buffer += piece
            self._check_trigger()
            return
        self._feed(piece)
