"""Continuous-batching scheduler — the server_slot/update_slots analogue
(reference examples/server/server.cpp:1220,2794).

Counterpart of llama_cpp_test_tpu/runtime/scheduler.py over the port's
single-device Context, with server-side speculative decoding (draft_ctx),
or over a recurrent state pool (runtime/recurrent.RecurrentContext), whose
capability flags turn windows, candidate sampling and prefix reuse off.

Requests queue up; each gets a slot with its own sequence, sampler chain and
stop conditions. Every `step()`:

  1. assigns queued requests to idle slots, reusing the longest common token
     prefix already in a slot's cache (common_lcp prompt reuse,
     server.cpp:3006-3007);
  2. runs at most one prefill chunk (token-bucketed) for a slot still
     ingesting its prompt — prefill and decode are separate steps, so the
     scheduler interleaves them instead of packing a mixed ubatch;
  3. runs one decode step batched over every generating slot;
  4. samples, checks stop conditions, streams tokens out via callbacks.

Admission control: a request only enters a slot when the block pool has
enough free blocks for its prompt (prevents mid-flight eviction of live
sequences — the find_slot failure mode, llama-context.cpp:1302).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

from .engine import Context, SeqState
from .sampling import SamplerChain, SamplerParams


class SlotState(enum.Enum):
    IDLE = 0
    PROMPT = 1      # ingesting prompt chunks
    GENERATING = 2


@dataclasses.dataclass
class GenRequest:
    """One generation request (server_task analogue)."""
    prompt_tokens: list[int]
    max_tokens: int = 128
    sampling: SamplerParams = dataclasses.field(default_factory=SamplerParams)
    stop_tokens: set[int] = dataclasses.field(default_factory=set)
    stop_strings: list[str] = dataclasses.field(default_factory=list)
    ignore_eos: bool = False  # --ignore-eos analogue
    n_keep: int = 0  # tokens pinned at the context head on context shift
    # called with (token_id, text_piece or None, finished: str | None)
    on_token: Optional[Callable[[int, Optional[str], Optional[str]], None]] = None
    id: int = 0
    # filled by the scheduler:
    output_tokens: list[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    n_prompt: int = 0
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


class Slot:
    def __init__(self, slot_id: int):
        self.id = slot_id
        self.state = SlotState.IDLE
        self.seq: SeqState | None = None
        self.req: GenRequest | None = None
        self.sampler: SamplerChain | None = None
        self.n_prompt_done = 0
        self.next_token: int | None = None
        self.text_buf = ""
        self.cache_tokens: list[int] = []  # tokens whose KV this slot holds
        self.draft_seq: SeqState | None = None  # per-slot draft cache (spec)
        # speculative metrics (server_slot n_draft_total/accepted analogue)
        self.n_drafted = 0
        self.n_draft_accepted = 0

    def reset(self):
        self.state = SlotState.IDLE
        self.req = None
        self.sampler = None
        self.n_prompt_done = 0
        self.next_token = None
        self.text_buf = ""


def common_lcp(a: list[int], b: list[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class Scheduler:
    def __init__(self, ctx: Context, n_slots: int = 8,
                 chunk_size: int = 512, ctx_shift: bool = True,
                 decode_window: int = 16, draft_ctx: Context | None = None,
                 n_draft: int = 8, p_draft_min: float = 0.75,
                 gen_prefill_chunk: int = 128, cache_reuse: int = 0):
        self.ctx = ctx
        # server-side speculative decoding: per-slot draft sequences inside
        # the continuous-batching loop (reference examples/server/
        # server.cpp:1861-1937,3250). Greedy draft + sample-and-accept-n on
        # the target's teacher-forced logits keeps output identical to the
        # non-speculative path for ANY sampler chain.
        self.draft_ctx = draft_ctx
        self.n_draft = n_draft
        self.p_draft_min = p_draft_min
        # context shift keeps long generations alive past n_ctx
        # (server.cpp:2825+)
        self.ctx_shift = ctx_shift
        self.slots = [Slot(i) for i in range(n_slots)]
        self.queue: deque[GenRequest] = deque()
        self.chunk = chunk_size
        # prefill chunk cap while other slots generate (split_equal
        # fairness analogue); = chunk_size disables the cap
        self.gen_prefill_chunk = min(gen_prefill_chunk, chunk_size)
        # minimum interior-chunk length for shifted prompt-cache reuse
        # (the --cache-reuse flag analogue; 0 = exact-prefix reuse only)
        self.cache_reuse = cache_reuse
        # windowed device decode: up to this many decode+sample steps per
        # dispatch when every generating slot's sampler runs on device
        # (device_sampling.eligible): one host sync per window instead of a
        # logits download per token
        self.decode_window = decode_window
        if not getattr(ctx, "supports_windows", True):
            # recurrent contexts (runtime/recurrent.py): a batched decode is
            # already one step; the paged window machinery does not apply
            self.decode_window = 1
        self._step_count = 0
        self._req_ids = itertools.count()
        self.tokenizer = ctx.model.tokenizer
        # metrics (server /metrics analogue)
        self.n_prompt_tokens = 0
        self.n_gen_tokens = 0
        self.t_prompt = 0.0
        self.t_gen = 0.0
        self.n_windows_chained = 0       # speculative next-window dispatches
        self.n_windows_rolled_back = 0   # ... that were abandoned on a stop
        # fast/slow sampling-path counters (device_sampling observability)
        self.n_decode_fast = 0     # tokens decoded via windowed device path
        self.n_decode_slow = 0     # tokens via per-token host sampling
        # slow-path tokens that rode the top-K candidate download (no
        # [B, V] logits transfer) and how often the chain rejected every
        # candidate and re-ran with full logits
        self.n_decode_cand = 0
        self.n_cand_fallback = 0

    # -- submission -----------------------------------------------------------

    def submit(self, req: GenRequest) -> GenRequest:
        # a prompt the context cannot hold is refused here: admitted, its
        # prefill would raise inside step() and end the caller's loop (the
        # reference clips its block table instead; ROADMAP §3, fault 27)
        if len(req.prompt_tokens) > self.ctx.n_ctx:
            raise ValueError(
                f"prompt of {len(req.prompt_tokens)} tokens exceeds "
                f"n_ctx={self.ctx.n_ctx}")
        req.id = next(self._req_ids)
        req.t_submit = time.time()
        req.n_prompt = len(req.prompt_tokens)
        self.queue.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.queue) or any(
            s.state != SlotState.IDLE for s in self.slots)

    # -- the update_slots loop -------------------------------------------------

    def step(self) -> None:
        self._launch_queued()
        self._prefill_one()
        self._decode_all()

    def run(self) -> None:
        while self.has_work():
            self.step()

    def _free_blocks(self) -> int:
        return min(m.num_free() for m in self.ctx.mgrs)

    def _launch_queued(self) -> None:
        for slot in self.slots:
            if not self.queue:
                return
            if slot.state != SlotState.IDLE:
                continue
            req = self.queue[0]
            need = (len(req.prompt_tokens) + req.max_tokens +
                    self.ctx.block_size - 1) // self.ctx.block_size
            # a slot never holds more than n_ctx tokens (the context shift
            # or the n_ctx stop bounds it), so it never needs more than a
            # block table's width; uncapped, a request whose max_tokens
            # outruns the pool waits forever and blocks the queue behind
            # it (the reference's hang; ROADMAP §3, fault 28)
            need = min(need, getattr(self.ctx, "nbmax", need))
            if need > self._free_blocks():
                # reclaim caches kept by idle slots (prefix-reuse holdovers)
                for other in self.slots:
                    if other.state == SlotState.IDLE and other.seq is not None \
                            and other is not slot:
                        self.ctx.free_seq(other.seq)
                        other.seq = None
                        other.cache_tokens = []
                        if need <= self._free_blocks():
                            break
            # the slot's own cache counts too: assignment truncates it to
            # the reused prefix or frees it (the reference counts only the
            # pool's free blocks, so a slot whose cache holds them waits for
            # itself forever; ROADMAP §3, fault 7)
            own = 0 if slot.seq is None else sum(
                isinstance(b, int) for b in slot.seq.table.blocks)
            if need > self._free_blocks() + own:
                return  # admission control: wait for blocks to free up
            self.queue.popleft()
            slot.req = req
            if self.decode_window > 1:
                from . import device_sampling as ds
                from ..common import log

                reasons = ds.ineligible_reasons(req.sampling)
                if reasons:
                    # say WHY throughput is about to drop ~10x: this request
                    # forces every co-batched row onto per-token host
                    # sampling (logits download per token)
                    log.info(
                        "request %d: sampler needs host path (%s) — "
                        "windowed device decode disabled while it runs",
                        req.id, ", ".join(reasons))
            if slot.draft_seq is not None:  # fresh draft cache per request
                self.draft_ctx.free_seq(slot.draft_seq)
                slot.draft_seq = None
            grammar_sampler = None
            if req.sampling.grammar and self.tokenizer is not None:
                from .grammar import GrammarSampler

                sp = req.sampling
                grammar_sampler = GrammarSampler(
                    sp.grammar, self.tokenizer, lazy=sp.grammar_lazy,
                    trigger_words=sp.grammar_trigger_words,
                    trigger_tokens=sp.grammar_trigger_tokens,
                    trigger_patterns=sp.grammar_trigger_patterns)
            slot.sampler = SamplerChain.from_params(
                req.sampling, n_vocab=self.ctx.model.hp.n_vocab,
                grammar_sampler=grammar_sampler)
            # prompt-cache reuse: if this slot's previous sequence shares a
            # prefix, keep that KV (truncate to the common part). With
            # cache_reuse > 0, interior chunks past the prefix are ALSO
            # kept by K-shifting them to their new positions
            # (Context.compact_reuse, the reference's n_cache_reuse path)
            reuse = 0
            if slot.seq is not None and slot.cache_tokens and \
                    getattr(self.ctx, "supports_prefix_reuse", True):
                # never reuse the whole prompt: the last token must be
                # re-decoded to produce logits
                max_keep = len(req.prompt_tokens) - 1
                if self.cache_reuse > 0:
                    reuse = self.ctx.compact_reuse(
                        slot.seq, req.prompt_tokens, self.cache_reuse,
                        max_keep=max_keep)
                else:
                    reuse = min(common_lcp(slot.cache_tokens,
                                           req.prompt_tokens), max_keep)
                    if reuse > 0:
                        slot.seq.table.truncate(reuse)
                        slot.seq.n_cached = reuse
                        slot.seq.tokens = req.prompt_tokens[:reuse]
            if reuse <= 0:
                if slot.seq is not None:
                    self.ctx.free_seq(slot.seq)
                slot.seq = self.ctx.new_seq()
            slot.n_prompt_done = reuse
            slot.cache_tokens = list(req.prompt_tokens)
            slot.state = SlotState.PROMPT

    def _prefill_one(self) -> None:
        for slot in self.slots:
            if slot.state != SlotState.PROMPT:
                continue
            req = slot.req
            t0 = time.time()
            # split_equal analogue (reference llama-batch.cpp): when other
            # slots are mid-generation, cap the prefill chunk so their
            # decode stall stays bounded — fairness over raw prefill
            # throughput (full chunks when nothing else is running)
            chunk_n = self.chunk
            if any(s.state == SlotState.GENERATING and s.next_token is not None
                   for s in self.slots):
                chunk_n = self.gen_prefill_chunk
            chunk = req.prompt_tokens[
                slot.n_prompt_done: slot.n_prompt_done + chunk_n]
            from . import device_sampling as ds

            # TTFT fast path: the final chunk's FIRST token samples from a
            # device top-K download instead of the [V] f32 logits transfer
            final = (slot.n_prompt_done + len(chunk) >=
                     len(req.prompt_tokens))
            use_cand = (final and self.draft_ctx is None and
                        getattr(self.ctx, "supports_candidates", True) and
                        ds.host_candidates_eligible(req.sampling))
            if use_cand:
                vals, ids = self.ctx.prefill(slot.seq, chunk,
                                             top_k=ds.HOST_CANDIDATES_K)
                logits = None
            else:
                logits = self.ctx.prefill(slot.seq, chunk)
            slot.n_prompt_done += len(chunk)
            self.n_prompt_tokens += len(chunk)
            self.t_prompt += time.time() - t0
            if final:
                if self.draft_ctx is not None:
                    # draft model ingests the full prompt (server.cpp:3250
                    # slot.batch_spec prompt sync)
                    slot.draft_seq = self.draft_ctx.new_seq()
                    for i in range(0, len(req.prompt_tokens), self.chunk):
                        self.draft_ctx.prefill(
                            slot.draft_seq,
                            req.prompt_tokens[i:i + self.chunk])
                slot.state = SlotState.GENERATING
                if use_cand:
                    tok = slot.sampler.sample_candidates(vals, ids)
                    if tok is None:
                        # chain rejected every candidate: re-decode the
                        # last prompt token for full logits
                        self.n_cand_fallback += 1
                        pre = slot.seq.n_cached
                        self.ctx.truncate_seq(slot.seq, pre - 1)
                        lg = self.ctx.decode([slot.seq],
                                             [req.prompt_tokens[-1]])[0]
                        tok = slot.sampler.sample(lg)
                    self.n_decode_cand += 1
                    slot.sampler.accept(tok)
                    self._process_token(slot, tok)
                else:
                    self._emit(slot, logits)
            return  # one prefill chunk per step keeps decode latency bounded

    def _window_for(self, gen: list[Slot]) -> int:
        """Window length for this decode round: >1 only when every slot in
        `gen` samples on device and has room for the window (callers pass
        the device-eligible partition)."""
        from . import device_sampling as ds

        # pending prompt work keeps decode latency bounded — but a non-empty
        # queue with NO idle slot can't make progress anyway, so it doesn't
        # force per-token decode (the round-3 gate did, collapsing windowed
        # throughput whenever requests were merely waiting)
        queue_runnable = bool(self.queue) and any(
            s.state == SlotState.IDLE for s in self.slots)
        if self.decode_window <= 1 or queue_runnable or \
                any(s.state == SlotState.PROMPT for s in self.slots):
            return 1
        w = self.decode_window
        most = 0
        for s in gen:
            if not ds.eligible(s.req.sampling) or s.seq.pos_offset:
                return 1
            w = min(w, self.ctx.n_ctx - s.seq.n_cached - 1)
            most = max(most, s.req.max_tokens - len(s.req.output_tokens))
        w = min(w, most)
        if w <= 1:
            return 1
        # round down to a power of two, as the reference does (its every
        # distinct window length is a separate compiled program)
        w = 1 << (w.bit_length() - 1)
        # don't trigger pool eviction: each slot needs blocks for w tokens
        need = sum(
            (s.seq.n_cached + w + self.ctx.block_size - 1)
            // self.ctx.block_size - len(s.seq.table.blocks) for s in gen)
        return w if need <= self._free_blocks() else 1

    def _decode_all(self) -> None:
        gen = [s for s in self.slots
               if s.state == SlotState.GENERATING and s.next_token is not None]
        if not gen:
            return
        # per-slot context shift (server.cpp:2825+): when a generating slot
        # fills the context, discard the older half beyond n_keep and slide
        # the cache down (single-device K-shift path)
        if self.ctx_shift:
            for s in gen:
                if s.seq.n_cached + 1 >= self.ctx.n_ctx:
                    n_keep = min(s.req.n_keep, s.seq.n_cached - 2)
                    n_discard = max((s.seq.n_cached - n_keep) // 2, 1)
                    self.ctx.shift_context(s.seq, n_keep, n_discard)
                    del s.cache_tokens[n_keep:n_keep + n_discard]
                    if s.draft_seq is not None:
                        # re-sync the draft cache to the shifted history:
                        # its positions no longer match the target's, and
                        # an unshifted draft would grow past its block
                        # table (the reference re-syncs the draft prompt
                        # per round, server.cpp:3250)
                        self.draft_ctx.free_seq(s.draft_seq)
                        s.draft_seq = self.draft_ctx.new_seq()
                        for i in range(0, len(s.cache_tokens), self.chunk):
                            self.draft_ctx.prefill(
                                s.draft_seq,
                                s.cache_tokens[i:i + self.chunk])
        if self.draft_ctx is not None:
            self._decode_spec_round(gen)
            return
        # partition by device-sampling eligibility: a grammar/exotic-sampler
        # row only slows ITSELF (one host-sampled token per round) while the
        # eligible rows keep the windowed fast path (round-3 behavior
        # dropped the WHOLE batch to per-token host decode — the 10x cliff)
        from . import device_sampling as ds

        fast = [s for s in gen
                if ds.eligible(s.req.sampling) and not s.seq.pos_offset]
        slow = [s for s in gen if s not in fast]
        if fast and slow:
            w = self._window_for(fast)
            if w > 1:
                self._decode_host_step(slow)
                # no chaining: each round must come back here so the slow
                # rows advance one host token per w fast tokens (chained
                # windows would starve them for the fast rows' whole run)
                self._decode_window_round(fast, w, allow_chain=False)
                return
        w = self._window_for(gen)
        if w > 1:
            self._decode_window_round(gen, w)
            return
        self._decode_host_step(gen)

    def _decode_host_step(self, gen: list[Slot]) -> None:
        """One per-token decode + host-chain sampling step."""
        if not gen:
            return
        from . import device_sampling as ds

        if getattr(self.ctx, "supports_candidates", True) and all(
                ds.host_candidates_eligible(s.req.sampling) for s in gen):
            self._decode_host_step_candidates(gen)
            return
        t0 = time.time()
        logits = self.ctx.decode([s.seq for s in gen],
                                 [s.next_token for s in gen])
        self.t_gen += time.time() - t0
        self.n_gen_tokens += len(gen)
        self.n_decode_slow += len(gen)
        for s, lg in zip(gen, logits):
            s.cache_tokens.append(s.next_token)
            self._emit(s, lg)

    def _decode_host_step_candidates(self, gen: list[Slot]) -> None:
        """Slow-row decode via a device top-K candidate download.

        The host path exists for chains the device can't express (grammar
        being the common one); it downloads [B, V] f32 logits a step. For
        candidate-safe chains (device_sampling.host_candidates_eligible)
        the device returns only the top-K (vals, ids) — 2*K floats/row —
        and the host chain (incl. the grammar pushdown mask) runs on the
        candidate set, which is what the reference chain does after top_k
        anyway (llama-sampling.cpp ordering). If the chain rejects every
        candidate (grammar-legal tokens all below rank K), the step is
        rolled back and redone with full logits."""
        from . import device_sampling as ds

        t0 = time.time()
        pre = [s.seq.n_cached for s in gen]
        toks_in = [s.next_token for s in gen]
        vals, ids = self.ctx.decode([s.seq for s in gen], toks_in,
                                    top_k=ds.HOST_CANDIDATES_K)
        self.t_gen += time.time() - t0
        self.n_gen_tokens += len(gen)
        self.n_decode_slow += len(gen)
        self.n_decode_cand += len(gen)
        for i, s in enumerate(gen):
            s.cache_tokens.append(s.next_token)
            tok = s.sampler.sample_candidates(vals[i], ids[i])
            if tok is None:
                # rare: every downloaded candidate was chain-rejected —
                # discard the step's KV and redo with full logits
                self.n_cand_fallback += 1
                self.ctx.truncate_seq(s.seq, pre[i])
                lg = self.ctx.decode([s.seq], [toks_in[i]])[0]
                tok = s.sampler.sample(lg)
            s.sampler.accept(tok)
            self._process_token(s, tok)

    def _decode_spec_round(self, gen: list[Slot]) -> None:
        """One speculative round for ALL generating slots: batched greedy
        draft proposal (one device dispatch, Context.draft_window), batched
        teacher-forced target verification (one dispatch,
        Context.prefill_batch), then per-slot sample-and-accept-n with the
        slot's own sampler chain — so output is identical to non-speculative
        serving for ANY sampler (the common_sampler_sample_and_accept_n
        analogue; the reference packs per-slot spec batches into one
        llama_decode, server.cpp:3250, common/sampling.h:79-82)."""
        t0 = time.time()
        # window: bounded by every slot's remaining context (the draft loop
        # and verify run the same length for the whole batch)
        k_max = self.n_draft
        for s in gen:
            k_max = min(k_max, self.ctx.n_ctx - s.seq.n_cached - 2,
                        self.draft_ctx.n_ctx - s.draft_seq.n_cached - 1)
        k_max = max(0, k_max)
        lasts = [s.next_token for s in gen]
        drafts: list[list[int]] = [[] for _ in gen]
        bases_d = [s.draft_seq.n_cached for s in gen]
        if k_max > 0:
            dseqs = [s.draft_seq for s in gen]
            toks, ps = self.draft_ctx.draft_window(dseqs, lasts, k_max)
            # truncate each row at its first below-threshold confidence
            for i, s in enumerate(gen):
                keep = 0
                while keep < k_max and ps[keep, i] >= self.p_draft_min:
                    keep += 1
                drafts[i] = [int(t) for t in toks[:keep, i]]
                s.n_drafted += keep
        # batched target verification: row i scores [last_i] + proposal_i;
        # logits[j] is the distribution after feeding j+1 tokens
        bases_t = [s.seq.n_cached for s in gen]
        all_logits = self.ctx.prefill_batch(
            [s.seq for s in gen],
            [[lasts[i]] + drafts[i] for i in range(len(gen))])
        for i, s in enumerate(gen):
            logits = all_logits[i]
            draft_toks = drafts[i]
            last = lasts[i]
            base = bases_t[i]
            toks_out: list[int] = []
            for j in range(len(draft_toks) + 1):
                t_j = int(s.sampler.sample(logits[j]))
                s.sampler.accept(t_j)
                toks_out.append(t_j)
                if j >= len(draft_toks) or t_j != draft_toks[j]:
                    break
            n_acc = len(toks_out) - 1
            s.n_draft_accepted += n_acc
            self.n_gen_tokens += len(toks_out)
            # discard rejected target KV (slot-restorer analogue)
            self.ctx.truncate_seq(s.seq, base + 1 + n_acc)
            feeds = [last] + draft_toks[:n_acc]
            finished_at = None
            for j, tok in enumerate(toks_out):
                s.cache_tokens.append(feeds[j])
                self._process_token(s, tok)
                if s.req is None:
                    finished_at = j
                    break
            if finished_at is not None and finished_at < n_acc:
                self.ctx.truncate_seq(s.seq, base + 1 + finished_at)
                del s.cache_tokens[base + 1 + finished_at:]
            if s.req is None:
                continue  # finished: draft cache freed by _process_token
            # sync the draft cache to the accepted prefix: it must hold
            # exactly [.., last, accepted...] before the next round
            dseq = s.draft_seq
            base_d = bases_d[i]
            n_keep = finished_at if finished_at is not None else n_acc
            want_d = base_d + 1 + n_keep
            if want_d <= dseq.n_cached:
                self.draft_ctx.truncate_seq(dseq, want_d)
            else:
                missing = ([last] + draft_toks)[dseq.n_cached - base_d:
                                                want_d - base_d]
                self.draft_ctx.prefill(dseq, missing)
        self.t_gen += time.time() - t0

    def _can_chain(self, gen: list[Slot], w: int) -> bool:
        """True when the NEXT window can be dispatched before this one's
        results reach the host: no runnable prompt work, and every slot has
        context room, token budget and blocks for w more steps (predicted
        state: the in-flight window's w tokens count as produced)."""
        if any(s.state == SlotState.PROMPT for s in self.slots):
            return False
        if self.queue and any(s.state == SlotState.IDLE for s in self.slots):
            return False
        need = 0
        for s in gen:
            cur = s.seq.n_cached + w  # after the in-flight window lands
            if cur + w + 1 >= self.ctx.n_ctx:
                return False  # would need a context shift mid-chain
            if len(s.req.output_tokens) + w >= s.req.max_tokens:
                return False  # in-flight window exhausts the budget
            need += (cur + w + self.ctx.block_size - 1) \
                // self.ctx.block_size - len(s.seq.table.blocks)
        return need <= self._free_blocks()

    def _decode_window_round(self, gen: list[Slot], w: int,
                             allow_chain: bool = True) -> None:
        """Windowed decode rounds, double-buffered against the device: while
        the host post-processes window k (detokenize, stop strings, budgets)
        the device is already computing window k+1, chained device-side from
        window k's final token/history (Context.decode_window_async carry).
        A chained window speculates that no slot stops; when one does, the
        in-flight window is abandoned and every surviving slot's cache rolls
        back (Context.truncate_seq) — KV written past the stop is discarded,
        like the reference's kv-slot restorer on failed decode."""
        self._step_count += 1
        t0 = time.time()
        # Penalty history = generated tokens only (the host SamplerChain
        # accept()s sampled tokens, never the prompt), minus the token being
        # fed — the device loop pushes each fed token into the ring itself.
        # Base seed fixed at 0: per-row noise is keyed on (row seed, pos) so
        # fixed-seed requests reproduce across scheduler states.
        seqs = [s.seq for s in gen]
        allow_chain = allow_chain and getattr(
            self.ctx, "supports_window_chaining", True)
        handle = self.ctx.decode_window_async(
            seqs, [s.next_token for s in gen],
            [s.req.sampling for s in gen], w, seed=0,
            histories=[s.req.output_tokens[:-1] for s in gen])
        while True:
            nxt = None
            if allow_chain and self._can_chain(gen, w):
                nxt = self.ctx.decode_window_async(seqs, n_steps=w,
                                                   carry=handle)
                self.n_windows_chained += 1
            toks = handle.fetch()
            clean = self._apply_window(gen, toks, w)
            self.t_gen += time.time() - t0
            t0 = time.time()
            if nxt is None:
                return
            if not clean:
                # a slot stopped (or shifted state) mid-window: the chained
                # dispatch is wasted — drop its device results and free the
                # blocks it reserved on every still-live sequence
                self.n_windows_rolled_back += 1
                for s in gen:
                    if s.state == SlotState.GENERATING and s.seq is not None:
                        self.ctx.truncate_seq(s.seq, s.seq.n_cached)
                return
            handle = nxt

    def _apply_window(self, gen: list[Slot], toks: np.ndarray,
                      w: int) -> bool:
        """Host post-processing for one fetched window. Returns False when
        any slot finished (a chained successor window must be abandoned)."""
        clean = True
        for i, s in enumerate(gen):
            n0 = s.seq.n_cached - w  # position of s.next_token pre-window
            for j in range(w):
                tok = int(toks[j, i])
                s.cache_tokens.append(s.next_token)
                self.n_gen_tokens += 1
                self.n_decode_fast += 1
                s.sampler.accept(tok)
                self._process_token(s, tok)
                if s.req is None:  # finished: discard overshoot KV
                    self.ctx.truncate_seq(s.seq, n0 + 1 + j)
                    del s.cache_tokens[n0 + 1 + j:]
                    clean = False
                    break
        return clean

    # -- token processing (process_token analogue, server.cpp:1358) ----------

    def _emit(self, slot: Slot, logits: np.ndarray) -> None:
        tok = slot.sampler.sample(logits)
        slot.sampler.accept(tok)
        self._process_token(slot, tok)

    def _process_token(self, slot: Slot, tok: int) -> None:
        req = slot.req
        if not req.output_tokens:
            req.t_first_token = time.time()
        finished = None
        piece = None
        vocab = self.ctx.model.tokenizer.vocab if self.tokenizer else None
        if self.tokenizer is not None:
            piece = self.tokenizer.token_to_piece(tok)
        if tok in req.stop_tokens or (
                not req.ignore_eos and vocab is not None and vocab.is_eog(tok)):
            finished = "stop"
        else:
            req.output_tokens.append(tok)
            if piece:
                slot.text_buf += piece
                for stop in req.stop_strings:
                    idx = slot.text_buf.find(stop)
                    if idx >= 0:
                        finished = "stop"
                        break
            if finished is None and len(req.output_tokens) >= req.max_tokens:
                finished = "length"
            if finished is None and not self.ctx_shift and \
                    slot.seq.n_cached + 1 > self.ctx.n_ctx:
                finished = "length"  # context full (no shift configured)
        if finished is not None:
            # set completion state BEFORE the callback fires: stream bridges
            # resolve futures from the callback and read req fields
            req.finish_reason = finished
            req.t_done = time.time()
        if req.on_token is not None:
            req.on_token(tok, piece, finished)
        if finished is not None:
            if slot.draft_seq is not None:  # draft caches are not reused
                self.draft_ctx.free_seq(slot.draft_seq)
                slot.draft_seq = None
            slot.reset()  # keep seq + cache_tokens for prefix reuse
        else:
            slot.next_token = tok

    def metrics(self) -> dict:
        return {
            "prompt_tokens_processed": self.n_prompt_tokens,
            "gen_tokens_processed": self.n_gen_tokens,
            "prompt_seconds": round(self.t_prompt, 3),
            "gen_seconds": round(self.t_gen, 3),
            "prompt_tok_per_s": round(
                self.n_prompt_tokens / self.t_prompt, 2) if self.t_prompt else 0,
            "gen_tok_per_s": round(
                self.n_gen_tokens / self.t_gen, 2) if self.t_gen else 0,
            "gen_tokens_fast_path": self.n_decode_fast,
            "gen_tokens_slow_path": self.n_decode_slow,
            "gen_tokens_candidate_path": self.n_decode_cand,
            "candidate_path_fallbacks": self.n_cand_fallback,
            "windows_chained": self.n_windows_chained,
            "windows_rolled_back": self.n_windows_rolled_back,
            "slots_idle": sum(s.state == SlotState.IDLE for s in self.slots),
            "slots_total": len(self.slots),
            "queue_depth": len(self.queue),
            "kv_blocks_free": self._free_blocks(),
            "kv_blocks_total": self.ctx.num_blocks,
        }
