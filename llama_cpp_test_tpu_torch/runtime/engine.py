"""Inference engine: prefill/decode steps over the paged KV cache.

Counterpart of llama_cpp_test_tpu/runtime/engine.py (single device):

  Model     — weights + hparams on a device (llama_model analogue)
  Context   — KV pools + block manager + per-sequence state (llama_context)
  generate()— llama-cli style greedy/sampled loop

PyTorch runs eagerly, so the reference's jitted step functions become the
plain function `_forward`. Token counts are still padded to TOKEN_BUCKETS
and decode batches to powers of two, as the reference does; these are the
shapes a later CUDA-graph capture will use.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Sequence as Seq

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.reader import open_gguf
from ..models import hparams as hparams_mod
from ..models import llama as llama_mod
from ..models.hparams import HParams
from ..models.llama import LlamaWeights, load_weights
from ..weights import to_device
from . import kv_cache
from .block_manager import BlockManager, SequenceBlockTable
from .kv_cache import KVPools


def _bucket(n: int, buckets: Seq[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


TOKEN_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _forward(w: LlamaWeights, pools: KVPools, tokens, positions, block_table,
             rows, slots, kv_len, *, hp: HParams, decode: bool,
             plain: bool = False) -> torch.Tensor:
    """Embed, run all layers (writing KV in place), no final norm (lm_head
    applies it). rows/slots: flat token rows of the batch whose KV is kept
    and their global slot ids. Returns hidden [B, T, C]."""
    x = llama_mod.embed(w, tokens)
    scale = hparams_mod.attn_scale_of(hp)
    cap = hp.attn_softcap
    for li, lw in enumerate(w.layers):
        window = hparams_mod.layer_window(hp, li)

        def attend(q, k_cur, v_cur, _li=li, _window=window):
            if pools.quantized:
                # q8_0 KV: quantizing scatter; decode through K3's q8
                # variant, prefill through the dequantizing gather
                ks, vs = pools.k_scale[_li], pools.v_scale[_li]
                kv_cache.write_kv_q8(pools.k[_li], ks, k_cur, rows, slots)
                kv_cache.write_kv_q8(pools.v[_li], vs, v_cur, rows, slots)
                if decode:
                    return kv_cache.attend_decode_q8(
                        q, pools.k[_li], ks, pools.v[_li], vs, block_table,
                        kv_len, scale, _window, cap, plain=plain)
                return kv_cache.attend_gathered(
                    q, kv_cache.gather_kv_q8(pools.k[_li], ks, block_table),
                    kv_cache.gather_kv_q8(pools.v[_li], vs, block_table),
                    positions, kv_len, scale, _window, cap)
            kv_cache.write_kv(pools.k[_li], k_cur, rows, slots)
            kv_cache.write_kv(pools.v[_li], v_cur, rows, slots)
            if decode:
                return kv_cache.attend_decode(
                    q, pools.k[_li], pools.v[_li], block_table, kv_len, scale,
                    _window, cap, plain=plain)
            return kv_cache.attend_prefill(
                q, pools.k[_li], pools.v[_li], block_table, positions, kv_len,
                scale, _window, cap, plain=plain)

        x = llama_mod.forward_layer(x, lw, hp, positions, w.rope_inv_freq,
                                    w.rope_mscale, attend, plain=plain)
    return x


class Model:
    """Loaded weights on a device (llama_model analogue). The tokenizer is
    not ported yet: `tokenizer` is None and callers pass token ids."""

    def __init__(self, path: str, hp: HParams | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.path = path
        t0 = time.time()
        self.reader = open_gguf(path)
        self.hp, w = load_weights(self.reader, hp)
        self.weights = to_device(w, self.device)
        self.load_seconds = time.time() - t0
        self.tokenizer = None

    @classmethod
    def from_weights(cls, hp: HParams, w: LlamaWeights,
                     device: str | torch.device | None = None) -> "Model":
        """A Model over host planes loaded elsewhere (weights.py converts
        them), with no file behind it."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.path = None
        self.reader = None
        self.hp = hp
        self.weights = to_device(w, self.device)
        self.load_seconds = 0.0
        self.tokenizer = None
        return self

    def n_vocab(self) -> int:
        return self.hp.n_vocab


@dataclasses.dataclass
class SeqState:
    """One sequence's host-side state (server slot analogue)."""
    seq_id: int
    tokens: list[int]
    table: SequenceBlockTable
    n_cached: int = 0  # tokens whose KV is in the pools


class Context:
    """KV pools + block manager + step dispatch (llama_context analogue).

    plain=True runs the plain PyTorch version of every kernel (the check a
    run on the card is held against); the default runs the kernels."""

    def __init__(self, model: Model, n_ctx: int = 2048, n_seq_max: int = 8,
                 block_size: int = 16, num_blocks: int | None = None,
                 kv_type: str = "bf16", plain: bool = False):
        self.model = model
        self.device = model.device
        self.w = model.weights
        self.n_ctx = n_ctx
        self.block_size = block_size
        self.plain = plain
        if num_blocks is None:
            num_blocks = max(n_seq_max * (n_ctx // block_size), 8)
        self.num_blocks = num_blocks
        self.mgr = BlockManager(num_blocks)
        self.pools = kv_cache.new_kv_pools(model.hp, num_blocks, block_size,
                                           device=self.device, kv_type=kv_type)
        self.seqs: dict[int, SeqState] = {}
        self._next_id = 0
        self.nbmax = n_ctx // block_size

    # -- sequence management ------------------------------------------------

    def new_seq(self) -> SeqState:
        s = SeqState(self._next_id, [],
                     SequenceBlockTable(self.mgr, self.block_size))
        self._next_id += 1
        self.seqs[s.seq_id] = s
        return s

    def free_seq(self, s: SeqState) -> None:
        s.table.release()
        self.seqs.pop(s.seq_id, None)

    # -- steps ----------------------------------------------------------------

    def _table_arr(self, seqs: Seq[SeqState]) -> np.ndarray:
        bt = np.zeros((len(seqs), self.nbmax), np.int32)
        for i, s in enumerate(seqs):
            blocks = s.table.resident_blocks()[: self.nbmax]
            bt[i, : len(blocks)] = blocks
        return bt

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _step(self, tok, pos, bt, slot_arr, kv_len, decode: bool):
        """Upload one step's host arrays and run the forward. Padding rows
        (slot -1) are dropped from the KV scatter here, on the host."""
        flat = slot_arr.reshape(-1)
        keep = np.nonzero(flat >= 0)[0]
        return _forward(
            self.w, self.pools, self._to_dev(tok), self._to_dev(pos),
            self._to_dev(bt), self._to_dev(keep.astype(np.int64)),
            self._to_dev(flat[keep].astype(np.int64)), self._to_dev(kv_len),
            hp=self.model.hp, decode=decode, plain=self.plain)

    def _check_room(self, s: SeqState, n: int) -> None:
        if s.n_cached + n > self.n_ctx:
            raise ValueError(
                f"sequence {s.seq_id}: {s.n_cached} + {n} tokens exceed "
                f"n_ctx={self.n_ctx} (context shift is not ported yet)")

    def prefill(self, s: SeqState, tokens: list[int],
                all_logits: bool = False) -> np.ndarray:
        """Append tokens to the sequence and run prefill. Returns last-token
        logits [V] (or [T, V] when all_logits), float32 numpy."""
        n = len(tokens)
        if n == 0:
            raise ValueError("prefill: empty token list")
        self._check_room(s, n)
        t0 = s.n_cached
        slots = s.table.append_tokens(n)
        tb = _bucket(n, TOKEN_BUCKETS)
        if n > tb:
            raise ValueError(f"prefill: {n} tokens exceed the largest bucket")
        tok = np.zeros((1, tb), np.int32)
        tok[0, :n] = tokens
        pos = np.zeros((1, tb), np.int32)
        pos[0, :n] = np.arange(t0, t0 + n)
        slot_arr = np.full((1, tb), -1, np.int32)
        slot_arr[0, :n] = slots
        bt = self._table_arr([s])
        kv_len = np.asarray([t0 + n], np.int32)
        s.tokens.extend(tokens)
        s.n_cached += n
        with torch.inference_mode():
            x = self._step(tok, pos, bt, slot_arr, kv_len, decode=False)
            hp, plain = self.model.hp, self.plain
            if all_logits:
                logits = llama_mod.lm_head(self.w, hp, x, plain)[0, :n]
            else:
                logits = llama_mod.lm_head(self.w, hp, x[:, n - 1:n],
                                           plain)[0, 0]
            return logits.float().cpu().numpy()

    def decode(self, seqs: Seq[SeqState], tokens: Seq[int]) -> np.ndarray:
        """One decode step for a batch of sequences. Returns logits [B, V]
        in the caller's order."""
        b = len(seqs)
        for s in seqs:
            self._check_room(s, 1)
        slot_list = [s.table.append_tokens(1)[0] for s in seqs]
        # pad the batch to a power of two, as the reference buckets it
        bsz = 1 << (max(b, 1) - 1).bit_length()
        tok = np.zeros((bsz, 1), np.int32)
        pos = np.zeros((bsz, 1), np.int32)
        slot_arr = np.full((bsz, 1), -1, np.int32)
        bt = np.zeros((bsz, self.nbmax), np.int32)
        kv_len = np.ones((bsz,), np.int32)
        bt[:b] = self._table_arr(seqs)
        for i, s in enumerate(seqs):
            tok[i, 0] = tokens[i]
            pos[i, 0] = s.n_cached
            slot_arr[i, 0] = slot_list[i]
            kv_len[i] = s.n_cached + 1
        for s, t in zip(seqs, tokens):
            s.tokens.append(int(t))
            s.n_cached += 1
        with torch.inference_mode():
            x = self._step(tok, pos, bt, slot_arr, kv_len, decode=True)
            logits = llama_mod.lm_head(self.w, self.model.hp, x,
                                       self.plain)[:b, 0]
            return logits.float().cpu().numpy()


def generate(ctx: Context, prompt_tokens: list[int], max_new_tokens: int,
             sampler: Callable[[np.ndarray], int] | None = None,
             eos_ids: set[int] | None = None) -> Iterator[int]:
    """llama-cli style generation loop (greedy by default)."""
    if sampler is None:
        sampler = lambda logits: int(np.argmax(logits))
    s = ctx.new_seq()
    try:
        logits = ctx.prefill(s, prompt_tokens)
        for _ in range(max_new_tokens):
            tok = sampler(logits)
            if eos_ids and tok in eos_ids:
                break
            yield tok
            logits = ctx.decode([s], [tok])[0]
    finally:
        ctx.free_seq(s)
