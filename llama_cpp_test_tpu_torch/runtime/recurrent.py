"""Recurrent-state multi-sequence context: mamba and the rwkv families in
the scheduler/server.

Counterpart of llama_cpp_test_tpu/runtime/recurrent.py. The reference
serves state-space models through the SAME llama-server path as
attention models by giving the KV cache a recurrent mode, where each
sequence owns one state cell instead of a token ring
(llama-kv-cache.h:146). This module is that mode: a STATE POOL of
n_seq_max rows on the model's device (conv tail + SSM state per layer, or
the token shifts + wkv matrices), sequences indexed by row, with

  - prefill: a loop over the chunk's tokens through one pool row (the
    reference's masked lax.scan over a token bucket: torch needs no
    padding, and the reference's padded steps leave the state as it is),
  - decode:  gather the B rows, one batched chain step and one batched
    head, scatter the rows back (torch needs no padded batch, so the pool
    has no scratch row).

The surface matches what runtime/scheduler.py needs from the paged
Context (new_seq/free_seq/prefill/decode/shift_context + hparams).
Capability flags keep the scheduler off the paths that do not apply to
recurrent state:

  supports_windows       False — windowed device decode needs the paged
                         KV window machinery; a recurrent decode is
                         already one batched step
  supports_candidates    False — the all-rejected fallback rewinds one
                         token (truncate_seq), and a recurrent state
                         update cannot be undone without checkpointing
  supports_prefix_reuse  False — prompt-cache reuse truncates to an
                         interior position, the same impossibility
  supports_window_chaining False — no windows to chain

Context shift is pure bookkeeping: the state already summarizes the
discarded history, and positions never enter the math.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import upload
from ..models import mamba, rwkv6, rwkv7
from ..models.mamba import RecurrentArch, run_tokens


_CLASSES = {"mamba": (mamba.MambaModel, mamba.MambaContext),
            "rwkv6": (rwkv6.Rwkv6Model, rwkv6.Rwkv6Context),
            "rwkv6qwen2": (rwkv6.Rwkv6Model, rwkv6.Rwkv6Context),
            "rwkv7": (rwkv7.Rwkv7Model, rwkv7.Rwkv7Context),
            "arwkv7": (rwkv7.Rwkv7Model, rwkv7.Rwkv7Context)}


def classes(arch: str) -> tuple:
    """(model class, single-sequence Context class) of a recurrent GGUF
    arch (models/registry.RECURRENT)."""
    if arch not in _CLASSES:
        raise ValueError(f"{arch!r} is not a recurrent arch")
    return _CLASSES[arch]


def arch_of(model) -> RecurrentArch:
    """The RecurrentArch of a loaded recurrent model: its Context's."""
    return classes(model.hp.arch)[1].arch


class _NullMgr:
    """Block-manager stand-in: recurrent state is O(1) per sequence, so
    block-count admission control never binds (slot count is the
    limit)."""

    def num_free(self) -> int:
        return 1 << 30


@dataclasses.dataclass
class _NullTable:
    blocks: tuple = ()

    def release(self) -> None:
        pass


@dataclasses.dataclass
class RecurrentSeq:
    seq_id: int
    row: int                       # state-pool row
    tokens: list
    n_cached: int = 0
    pos_offset: int = 0            # Self-Extend never applies (no rope)
    table: _NullTable = dataclasses.field(default_factory=_NullTable)


class RecurrentContext:
    """Scheduler-compatible context over a recurrent state pool on the
    model's device."""

    supports_windows = False
    supports_candidates = False
    supports_prefix_reuse = False
    supports_window_chaining = False

    def __init__(self, model, n_ctx: int = 4096,
                 n_seq_max: int = 8, **_ignored):
        self.model = model
        self.device = model.device
        self.n_ctx = n_ctx
        self.n_seq_max = n_seq_max
        self.block_size = 1
        self.num_blocks = n_seq_max      # /metrics: state rows, not blocks
        self.mgrs = [_NullMgr()]
        self.arch = arch_of(model)
        self._wt = self.arch.weights_t(model)
        self.pool = self.arch.zero_state(model.hp, self.device, n_seq_max)
        self._free_rows = list(range(n_seq_max))
        self._next_id = 0
        self.seqs: dict[int, RecurrentSeq] = {}

    # -- sequence lifecycle ------------------------------------------------

    def new_seq(self) -> RecurrentSeq:
        if not self._free_rows:
            raise RuntimeError("no free recurrent state rows")
        row = self._free_rows.pop()
        for p in self.pool:
            p[row].zero_()
        s = RecurrentSeq(self._next_id, row, [])
        self._next_id += 1
        self.seqs[s.seq_id] = s
        return s

    def free_seq(self, s: RecurrentSeq) -> None:
        if s.seq_id in self.seqs:
            self.seqs.pop(s.seq_id)
            self._free_rows.append(s.row)

    # -- compute -----------------------------------------------------------

    def _ids(self, ids) -> torch.Tensor:
        return upload(np.asarray(ids, np.int64), self.device)

    def prefill(self, s: RecurrentSeq, tokens: list,
                all_logits: bool = False) -> np.ndarray:
        """tokens through pool row s.row, one chain step each. Returns the
        logits [V] of the last token."""
        if all_logits:
            raise NotImplementedError("recurrent prefill returns the last "
                                      "position only")
        if not len(tokens):
            raise ValueError("prefill: empty token list")
        state = tuple(p[s.row:s.row + 1] for p in self.pool)
        logits, state = run_tokens(self.arch, self._wt, state, tokens,
                                   self.model.hp, self.device)
        for p, st in zip(self.pool, state):
            p[s.row:s.row + 1] = st
        s.tokens.extend(int(t) for t in tokens)
        s.n_cached += len(tokens)
        return logits.cpu().numpy()

    def decode(self, seqs: list, tokens: list) -> np.ndarray:
        """One token for each of B sequences: their pool rows gathered, one
        batched chain step and head, the rows scattered back. Returns
        logits [B, V]."""
        rows = self._ids([s.row for s in seqs])
        state = tuple(p[rows] for p in self.pool)
        x, state = self.arch.chain(self._wt, state, self._ids(tokens),
                                   hp=self.model.hp)
        for p, st in zip(self.pool, state):
            p[rows] = st
        for s, t in zip(seqs, tokens):
            s.tokens.append(int(t))
            s.n_cached += 1
        return self.arch.head(self._wt, x, hp=self.model.hp).cpu().numpy()

    # -- maintenance -------------------------------------------------------

    def shift_context(self, s: RecurrentSeq, n_keep: int,
                      n_discard: int) -> None:
        """Drop history bookkeeping; the state already summarizes it and
        positions never enter the recurrence."""
        del s.tokens[n_keep:n_keep + n_discard]
        s.n_cached -= n_discard

    def truncate_seq(self, s: RecurrentSeq, n: int) -> None:
        raise NotImplementedError(
            "recurrent state cannot rewind (supports_candidates=False "
            "keeps the scheduler off every truncating path)")
