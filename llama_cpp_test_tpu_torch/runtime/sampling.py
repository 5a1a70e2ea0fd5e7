"""Copy of llama_cpp_test_tpu/runtime/sampling.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

Sampler chain — the llama-sampling.cpp analogue.

The reference implements a vtable-based chain of samplers that mutate a
candidate array (llama_sampler_chain, reference src/llama-sampling.cpp;
API include/llama.h:1188-1340). Here each sampler is a small class with
`apply(SampleState) -> None`; a chain is a list. Host-side numpy keeps exact
reference semantics (sorting, truncation); a fused jit path can shortcut the
common temp/top-k/top-p chain on device later.

Covered: greedy, dist, temperature (+ext), top-k, top-p, min-p, typical,
XTC, top-n-sigma, mirostat v1/v2, penalties (repeat/freq/presence), DRY,
logit-bias, infill-style EOG guard via grammar hooks (grammar lives in
runtime/grammar.py and plugs in as a sampler).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass
class SampleState:
    """Candidate set flowing through the chain (llama_token_data_array)."""
    logits: np.ndarray          # [n] float32, aligned with ids
    ids: np.ndarray             # [n] int32 token ids
    probs: np.ndarray | None = None
    sorted_: bool = False

    @classmethod
    def from_logits(cls, logits: np.ndarray) -> "SampleState":
        logits = np.asarray(logits, np.float32).reshape(-1)
        return cls(logits=logits.copy(),
                   ids=np.arange(logits.shape[0], dtype=np.int32))

    def sort_desc(self) -> None:
        if not self.sorted_:
            order = np.argsort(-self.logits, kind="stable")
            self.logits = self.logits[order]
            self.ids = self.ids[order]
            self.sorted_ = True
        self.probs = None

    def softmax(self) -> np.ndarray:
        self.sort_desc()
        m = self.logits[0]
        e = np.exp(self.logits - m)
        self.probs = e / e.sum()
        return self.probs

    def truncate(self, k: int) -> None:
        k = max(1, min(k, len(self.logits)))
        self.logits = self.logits[:k]
        self.ids = self.ids[:k]
        self.probs = None


class Sampler:
    def apply(self, st: SampleState) -> None:
        raise NotImplementedError

    def accept(self, token: int) -> None:  # stateful samplers override
        pass

    def reset(self) -> None:
        pass


class Temperature(Sampler):
    def __init__(self, t: float):
        self.t = t

    def apply(self, st):
        if self.t <= 0:
            # argmax-only (reference: temp<=0 -> greedy via -inf others)
            best = int(np.argmax(st.logits))
            keep = st.logits[best]
            st.logits[:] = -np.inf
            st.logits[best] = keep
        else:
            st.logits /= self.t
        st.sorted_ = False if self.t > 0 else st.sorted_


class TemperatureExt(Sampler):
    """Dynamic temperature (entropy-scaled), llama-sampling.cpp temp_ext."""

    def __init__(self, t: float, delta: float = 0.0, exponent: float = 1.0):
        self.t, self.delta, self.exponent = t, delta, exponent

    def apply(self, st):
        if self.delta <= 0 or self.t <= 0:
            Temperature(self.t).apply(st)
            return
        min_temp, max_temp = max(0.0, self.t - self.delta), self.t + self.delta
        p = st.softmax()
        max_ent = math.log(len(p)) if len(p) > 1 else 1.0
        ent = float(-(p * np.log(p + 1e-12)).sum())
        norm = ent / max_ent if max_ent > 0 else 0.0
        dyn = min_temp + (max_temp - min_temp) * (norm ** self.exponent)
        st.logits /= max(dyn, 1e-3)
        st.sorted_ = False


class TopK(Sampler):
    def __init__(self, k: int):
        self.k = k

    def apply(self, st):
        if self.k <= 0:
            return
        st.sort_desc()
        st.truncate(self.k)


class TopP(Sampler):
    def __init__(self, p: float, min_keep: int = 1):
        self.p, self.min_keep = p, min_keep

    def apply(self, st):
        if self.p >= 1.0:
            return
        probs = st.softmax()
        cum = np.cumsum(probs)
        n = int(np.searchsorted(cum, self.p) + 1)
        st.truncate(max(n, self.min_keep))


class MinP(Sampler):
    def __init__(self, p: float, min_keep: int = 1):
        self.p, self.min_keep = p, min_keep

    def apply(self, st):
        if self.p <= 0:
            return
        st.sort_desc()
        probs = st.softmax()
        thresh = self.p * probs[0]
        n = int((probs >= thresh).sum())
        st.truncate(max(n, self.min_keep))


class Typical(Sampler):
    """Locally-typical sampling (llama-sampling.cpp typical)."""

    def __init__(self, p: float, min_keep: int = 1):
        self.p, self.min_keep = p, min_keep

    def apply(self, st):
        if self.p >= 1.0:
            return
        probs = st.softmax()
        ent = float(-(probs * np.log(probs + 1e-12)).sum())
        shifted = np.abs(-np.log(probs + 1e-12) - ent)
        order = np.argsort(shifted, kind="stable")
        probs_o = probs[order]
        cum = np.cumsum(probs_o)
        n = int(np.searchsorted(cum, self.p) + 1)
        n = max(n, self.min_keep)
        keep = order[:n]
        st.logits = st.logits[keep]
        st.ids = st.ids[keep]
        st.sorted_ = False
        st.probs = None


class XTC(Sampler):
    """Exclude-top-choices (llama-sampling.cpp xtc): with probability p,
    remove all but the last candidate whose prob exceeds the threshold."""

    def __init__(self, p: float, threshold: float, min_keep: int = 1,
                 seed: int = 0):
        self.p, self.threshold, self.min_keep = p, threshold, min_keep
        self.rng = np.random.default_rng(seed)

    def apply(self, st):
        if self.p <= 0 or self.threshold > 0.5:
            return
        if self.rng.random() >= self.p:
            return
        probs = st.softmax()
        above = int((probs >= self.threshold).sum())
        if above >= 2:
            drop = above - 1
            st.logits = st.logits[drop:]
            st.ids = st.ids[drop:]
            st.probs = None


class TopNSigma(Sampler):
    """Keep tokens within n standard deviations of the max logit."""

    def __init__(self, n: float):
        self.n = n

    def apply(self, st):
        if self.n <= 0:
            return
        st.sort_desc()
        finite = st.logits[np.isfinite(st.logits)]
        sigma = float(finite.std())
        thresh = st.logits[0] - self.n * sigma
        keep = int((st.logits >= thresh).sum())
        st.truncate(keep)


class Penalties(Sampler):
    """repeat/frequency/presence penalties over the last n tokens
    (llama-sampling.cpp penalties)."""

    def __init__(self, n_last: int = 64, repeat: float = 1.0,
                 freq: float = 0.0, present: float = 0.0):
        self.n_last, self.repeat, self.freq, self.present = (
            n_last, repeat, freq, present)
        self.prev: list[int] = []

    def accept(self, token: int) -> None:
        self.prev.append(token)
        if self.n_last > 0 and len(self.prev) > self.n_last:
            self.prev = self.prev[-self.n_last:]

    def reset(self) -> None:
        self.prev = []

    def apply(self, st):
        if (self.repeat == 1.0 and self.freq == 0.0 and self.present == 0.0) \
                or not self.prev:
            return
        counts: dict[int, int] = {}
        for t in self.prev:
            counts[t] = counts.get(t, 0) + 1
        id_pos = {int(t): i for i, t in enumerate(st.ids)}
        for tok, cnt in counts.items():
            i = id_pos.get(tok)
            if i is None:
                continue
            lg = st.logits[i]
            if self.repeat != 1.0:
                lg = lg / self.repeat if lg > 0 else lg * self.repeat
            lg -= self.freq * cnt + self.present
            st.logits[i] = lg
        st.sorted_ = False
        st.probs = None


class LogitBias(Sampler):
    def __init__(self, bias: dict[int, float]):
        self.bias = bias

    def apply(self, st):
        if not self.bias:
            return
        id_pos = {int(t): i for i, t in enumerate(st.ids)}
        for tok, b in self.bias.items():
            i = id_pos.get(tok)
            if i is not None:
                st.logits[i] += b
        st.sorted_ = False


class DRY(Sampler):
    """DRY (don't-repeat-yourself) sampler: penalize extending a suffix that
    already occurred (llama-sampling.cpp dry, simplified: no sequence-breaker
    restarts mid-word, full token-id matching)."""

    def __init__(self, multiplier: float = 0.0, base: float = 1.75,
                 allowed_length: int = 2, penalty_last_n: int = 512,
                 seq_breakers: Sequence[int] = ()):
        self.multiplier, self.base = multiplier, base
        self.allowed_length = allowed_length
        self.penalty_last_n = penalty_last_n
        self.breakers = set(int(b) for b in seq_breakers)
        self.prev: list[int] = []

    def accept(self, token: int) -> None:
        self.prev.append(token)
        if len(self.prev) > self.penalty_last_n:
            self.prev = self.prev[-self.penalty_last_n:]

    def reset(self) -> None:
        self.prev = []

    def apply(self, st):
        if self.multiplier <= 0 or len(self.prev) < self.allowed_length + 1:
            return
        ctx = self.prev
        n = len(ctx)
        # longest suffix of ctx that also occurs earlier in ctx, and the token
        # that followed the earlier occurrence gets penalized
        penal: dict[int, int] = {}  # next-token -> match length
        max_scan = min(n - 1, self.penalty_last_n)
        for start in range(max_scan):
            # match ctx[start - L .. start) against suffix ctx[n - L .. n)
            L = 0
            while (L < start + 1 and L < n and
                   ctx[start - L] == ctx[n - 1 - L] and
                   ctx[start - L] not in self.breakers):
                L += 1
            if L >= self.allowed_length and start + 1 < n:
                nxt = ctx[start + 1]
                penal[nxt] = max(penal.get(nxt, 0), L)
        if not penal:
            return
        id_pos = {int(t): i for i, t in enumerate(st.ids)}
        for tok, L in penal.items():
            i = id_pos.get(tok)
            if i is not None:
                st.logits[i] -= self.multiplier * (
                    self.base ** (L - self.allowed_length))
        st.sorted_ = False


class MirostatV2(Sampler):
    def __init__(self, tau: float = 5.0, eta: float = 0.1, seed: int = 0):
        self.tau, self.eta = tau, eta
        self.mu = 2.0 * tau
        self.rng = np.random.default_rng(seed)
        self.picked: int | None = None

    def reset(self):
        self.mu = 2.0 * self.tau
        self.picked = None

    def apply(self, st):
        probs = st.softmax()
        surprise = -np.log2(probs + 1e-12)
        keep = int((surprise <= self.mu).sum())
        st.truncate(max(1, keep))
        probs = st.softmax()
        idx = int(self.rng.choice(len(probs), p=probs))
        self.picked = int(st.ids[idx])
        observed = float(-math.log2(probs[idx]))
        self.mu -= self.eta * (observed - self.tau)
        self._keep_only(st, idx)

    @staticmethod
    def _keep_only(st, idx):
        st.logits = st.logits[idx:idx + 1]
        st.ids = st.ids[idx:idx + 1]
        st.probs = None


class MirostatV1(Sampler):
    def __init__(self, tau: float = 5.0, eta: float = 0.1, m: int = 100,
                 n_vocab: int = 32000, seed: int = 0):
        self.tau, self.eta, self.m, self.n_vocab = tau, eta, m, n_vocab
        self.mu = 2.0 * tau
        self.rng = np.random.default_rng(seed)

    def reset(self):
        self.mu = 2.0 * self.tau

    def apply(self, st):
        probs = st.softmax()
        m = min(self.m, len(probs) - 1)
        if m < 2:
            return
        # estimate Zipf exponent s_hat from top-m probabilities
        num = sum(math.log((i + 2) / (i + 1)) *
                  math.log(probs[0] / max(probs[i + 1], 1e-12))
                  for i in range(m - 1))
        den = sum(math.log((i + 2) / (i + 1)) ** 2 for i in range(m - 1))
        s_hat = num / max(den, 1e-12)
        eps = s_hat - 1
        k = ((eps * (2 ** self.mu)) / (1 - self.n_vocab ** (-eps))) ** (1 / s_hat)
        k = int(max(1, min(round(k), len(probs))))
        st.truncate(k)
        probs = st.softmax()
        idx = int(self.rng.choice(len(probs), p=probs))
        observed = float(-math.log2(probs[idx]))
        self.mu -= self.eta * (observed - self.tau)
        MirostatV2._keep_only(st, idx)


class Infill(Sampler):
    """Fill-in-middle sampler (llama_sampler_init_infill, reference
    src/llama-sampling.cpp:2290-2464): softmax the candidates, then
      1. if EOG probability mass is large (3 * p_eog * n > p_txt), keep
         only EOG tokens;
      2. otherwise merge tokens whose text is a prefix of another
         candidate's text into the higher-probability one, drop non-EOG
         candidates below an absolute 0.2 threshold, re-normalize, and
         apply a second 1/(n_non_eog+1) threshold;
      3. if nothing survives, emit EOT.
    Stabilizes infill endings: partial-token continuations can't outvote
    their completed forms."""

    def __init__(self, tokenizer):
        self.tok = tokenizer
        self.vocab = tokenizer.vocab

    def apply(self, st: SampleState) -> None:
        probs = st.softmax()
        is_eog = np.asarray([self.vocab.is_eog(int(t)) for t in st.ids])
        p_eog = float(probs[is_eog].sum())
        p_txt = float(probs[~is_eog].sum())
        if 3.0 * p_eog * len(st.ids) > p_txt:
            keep = np.flatnonzero(is_eog)
            if len(keep) == 0:
                keep = np.asarray([0])
            st.logits = st.logits[keep]
            st.ids = st.ids[keep]
            st.probs = None
            return
        # merge common-prefix candidates into the higher-probability one
        pieces = [self.tok.token_to_piece(int(t)) or "" for t in st.ids]
        p = probs.copy()
        alive = np.ones(len(st.ids), bool)
        n = len(st.ids)
        for i0 in range(n):
            if not alive[i0] or not pieces[i0]:
                continue
            for i1 in range(n):
                if i0 == i1 or not alive[i1] or not alive[i0]:
                    continue
                if len(pieces[i0]) <= len(pieces[i1]) and \
                        pieces[i1].startswith(pieces[i0]):
                    dst, src = (i1, i0) if p[i1] > p[i0] else (i0, i1)
                    p[dst] += p[src]
                    p[src] = 0.0
                    alive[src] = False
        # threshold pass 1: drop non-EOG below 0.2
        keep = alive & (is_eog | (p >= 0.2))
        n_non_eog = int((keep & ~is_eog).sum())
        if n_non_eog == 0:
            # reduce to the dedicated EOT token when the vocab has one,
            # falling back to EOS (reference llama_sampler_infill_apply
            # uses special_eot_id-then-eos order)
            term = self.vocab.eot_id if getattr(self.vocab, "eot_id", -1) \
                not in (-1, None) else self.vocab.eos_id
            st.ids = np.asarray([term], np.int32)
            st.logits = np.asarray([1.0], np.float32)
            st.sorted_ = False
            st.probs = None
            return
        p = np.where(keep, p, 0.0)
        p = p / max(p.sum(), 1e-12)
        # threshold pass 2: relative to surviving non-EOG count
        thold = 1.0 / (n_non_eog + 1)
        keep = keep & (is_eog | (p >= thold))
        idx = np.flatnonzero(keep)
        if len(idx) == 0:
            idx = np.asarray([0])
        st.logits = np.log(np.maximum(p[idx], 1e-30)).astype(np.float32)
        st.ids = st.ids[idx]
        st.sorted_ = False
        st.probs = None


class Dist(Sampler):
    """Terminal sampler: draws from the remaining distribution."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def apply(self, st):
        probs = st.softmax()
        idx = int(self.rng.choice(len(probs), p=probs))
        MirostatV2._keep_only(st, idx)


class Greedy(Sampler):
    def apply(self, st):
        idx = int(np.argmax(st.logits))
        MirostatV2._keep_only(st, idx)


@dataclasses.dataclass
class SamplerParams:
    """common_params_sampling analogue (common/common.h defaults)."""
    seed: int = 0
    n_prev: int = 64
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    typ_p: float = 1.0
    temp: float = 0.8
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_penalty_last_n: int = -1
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    top_n_sigma: float = -1.0
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    logit_bias: dict = dataclasses.field(default_factory=dict)
    grammar: str = ""
    # lazy grammar triggers (llama-grammar.h:124-132): constrain sampling
    # only after a trigger word/pattern/token appears in the output
    grammar_lazy: bool = False
    grammar_trigger_words: tuple = ()
    grammar_trigger_tokens: tuple = ()
    grammar_trigger_patterns: tuple = ()


class SamplerChain:
    """Ordered chain (llama_sampler_chain analogue). Build with from_params
    for the reference's default ordering: penalties -> dry -> top-n-sigma /
    (top-k -> typical -> top-p -> min-p -> xtc -> temp-ext) -> dist."""

    def __init__(self, samplers: list[Sampler]):
        self.samplers = samplers

    @classmethod
    def from_params(cls, p: SamplerParams, n_vocab: int = 32000,
                    grammar_sampler: Sampler | None = None) -> "SamplerChain":
        chain: list[Sampler] = []
        if p.logit_bias:
            chain.append(LogitBias(p.logit_bias))
        chain.append(Penalties(p.penalty_last_n, p.penalty_repeat,
                               p.penalty_freq, p.penalty_present))
        if p.dry_multiplier > 0:
            chain.append(DRY(p.dry_multiplier, p.dry_base,
                             p.dry_allowed_length,
                             p.dry_penalty_last_n if p.dry_penalty_last_n > 0
                             else 512))
        if grammar_sampler is not None:
            chain.append(grammar_sampler)
        if p.mirostat == 1:
            chain.append(Temperature(p.temp))
            chain.append(MirostatV1(p.mirostat_tau, p.mirostat_eta,
                                    n_vocab=n_vocab, seed=p.seed))
        elif p.mirostat == 2:
            chain.append(Temperature(p.temp))
            chain.append(MirostatV2(p.mirostat_tau, p.mirostat_eta,
                                    seed=p.seed))
        elif p.temp <= 0:
            chain.append(Greedy())
        else:
            if p.top_n_sigma >= 0:
                chain.append(TopK(p.top_k))
                chain.append(Temperature(p.temp))
                chain.append(TopNSigma(p.top_n_sigma))
            else:
                chain.append(TopK(p.top_k))
                if p.typ_p < 1.0:
                    chain.append(Typical(p.typ_p))
                chain.append(TopP(p.top_p))
                chain.append(MinP(p.min_p))
                if p.xtc_probability > 0:
                    chain.append(XTC(p.xtc_probability, p.xtc_threshold,
                                     seed=p.seed))
                if p.dynatemp_range > 0:
                    chain.append(TemperatureExt(p.temp, p.dynatemp_range,
                                                p.dynatemp_exponent))
                else:
                    chain.append(Temperature(p.temp))
            chain.append(Dist(p.seed))
        return cls(chain)

    def sample(self, logits: np.ndarray) -> int:
        st = SampleState.from_logits(logits)
        for s in self.samplers:
            s.apply(st)
            if len(st.ids) == 1 and s is self.samplers[-1]:
                break
        tok = int(st.ids[0] if len(st.ids) == 1 else
                  st.ids[int(np.argmax(st.logits))])
        return tok

    def sample_candidates(self, vals: np.ndarray,
                          ids: np.ndarray) -> int | None:
        """Run the chain on a pre-narrowed candidate set (device top-k
        download) instead of full-vocab logits. Semantics match sample()
        for candidate-safe chains (see device_sampling's
        host_candidates_eligible): the reference applies every sampler
        after top_k to the narrowed candidate array anyway. Returns None
        when the chain (e.g. a grammar mask) rejects every candidate —
        the caller falls back to a full-logits step."""
        st = SampleState(logits=np.asarray(vals, np.float32).copy(),
                         ids=np.asarray(ids, np.int32).copy())
        for s in self.samplers:
            # bail BEFORE a downstream sampler (Dist's softmax) sees an
            # all--inf set — a grammar can mask every candidate
            if len(st.ids) == 0 or not np.isfinite(st.logits).any() or \
                    getattr(st, "all_rejected", False):
                return None
            s.apply(st)
        if len(st.ids) == 0 or not np.isfinite(st.logits).any() or \
                getattr(st, "all_rejected", False):
            return None
        return int(st.ids[0] if len(st.ids) == 1 else
                   st.ids[int(np.argmax(st.logits))])

    def accept(self, token: int) -> None:
        for s in self.samplers:
            s.accept(token)

    def reset(self) -> None:
        for s in self.samplers:
            s.reset()
