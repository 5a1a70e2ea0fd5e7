"""Inference engine: prefill/decode steps over the paged KV cache.

Counterpart of llama_cpp_test_tpu/runtime/engine.py (single device):

  Model     — weights + hparams + tokenizer on a device (llama_model)
  Context   — KV pools + block manager + per-sequence state (llama_context)
  generate()— llama-cli style greedy/sampled loop with context shift

PyTorch runs eagerly, so the reference's jitted step functions become the
plain function `_forward`, and its lax.scan decode windows a Python loop
over device tensors that reaches the host only at WindowHandle.fetch().
Token counts are still padded to TOKEN_BUCKETS and decode batches to
powers of two, as the reference does; these are the shapes a later
CUDA-graph capture will use.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Sequence as Seq

import numpy as np
import torch

from ..device import resolve_device, upload
from ..gguf.reader import open_gguf
from ..models import hparams as hparams_mod
from ..models import llama as llama_mod
from ..models.hparams import HParams
from ..models.llama import LlamaWeights, load_weights
from ..tokenizer import load_tokenizer
from ..weights import to_device
from . import device_sampling as ds
from . import kv_cache
from .block_manager import BlockManager, HostSwapStore, SequenceBlockTable
from .kv_cache import KVPools


def _bucket(n: int, buckets: Seq[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


TOKEN_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _forward(w: LlamaWeights, pools: KVPools, tokens, positions, block_table,
             rows, slots, kv_len, *, hp: HParams, decode: bool, n_ctx: int,
             plain: bool = False, rope_delta=None,
             causal: bool = True, tap: list | None = None,
             x_embd=None, mrope_pos=None) -> torch.Tensor:
    """Embed, run all layers (writing KV in place), no final norm (lm_head
    applies it). rows/slots: flat token rows of the batch whose KV is kept
    and their global slot ids. Returns hidden [B, T, C].

    positions are cache-index positions (mask order); rope_delta [B] is an
    optional per-row offset added for the RoPE rotation only, nonzero after
    Self-Extend (SeqState.pos_offset). causal=False (a prefill for embed)
    lets every token attend the whole chunk: the mask positions become
    kv_len - 1 on every row, while rope keeps the true positions. tap, a
    list, receives the embedding and every layer's output (tracing).

    A window that cannot bind is no window in the dispatch: a key s is
    masked iff s <= pos - window, and every mask position is below n_ctx
    (the Context checks it), so a layer whose window is >= n_ctx attends
    as a global layer does and its decode takes K3, not the gather path.
    Its rope table stays the sliding layers' one.

    An encoder or a file without rope positions adds its token-type row,
    learned position rows and embedding LayerNorm at the embedding
    (embed_input); an ALiBi file's slopes, made once a step, bias every
    layer's attention, which then takes the gather path on every device,
    as in the reference; jina-bert-v2's bias is symmetric about the true
    query positions (the mask positions of its non-causal rows are all
    kv_len - 1). Each layer runs at its own head counts, and a layer that
    does not attend (deci) writes no KV.

    x_embd [B, T, C] (image features, models/clip and
    models/qwen2vl_vision) replaces the token-embedding lookup, rounded to
    bf16 as the reference rounds it; the extras of an encoder or a file
    without rope positions still apply. mrope_pos [B, T, 3], qwen2vl's
    image streams, ropes q and k in place of the rope positions."""
    if x_embd is None:
        x = llama_mod.embed_input(w, hp, tokens, positions)
    else:
        x = x_embd.to(torch.bfloat16)
        if hp.pos_embd != "rope" or hp.post_norm:
            x = llama_mod.embed_extras(w, hp, x, positions)
    if tap is not None:
        tap.append(x)
    rope_pos = positions if rope_delta is None else \
        positions + rope_delta[:, None]
    mask_pos = positions if causal else \
        (kv_len - 1)[:, None].expand(positions.shape).contiguous()
    scale = hparams_mod.attn_scale_of(hp)
    cap = hp.attn_softcap
    alibi = llama_mod.alibi_of(hp, x.device)
    al_sym = positions if hp.alibi_sym else None
    for li, lw in enumerate(w.layers):
        window = hparams_mod.layer_window(hp, li)

        def attend(q, k_cur, v_cur, _li=li,
                   _window=window if window < n_ctx else 0):
            if pools.quantized:
                # q8_0 KV: quantizing scatter; decode through K3's q8
                # variant, prefill through the dequantizing gather
                ks, vs = pools.k_scale[_li], pools.v_scale[_li]
                kv_cache.write_kv_q8(pools.k[_li], ks, k_cur, rows, slots)
                kv_cache.write_kv_q8(pools.v[_li], vs, v_cur, rows, slots)
                if decode:
                    return kv_cache.attend_decode_q8(
                        q, pools.k[_li], ks, pools.v[_li], vs, block_table,
                        kv_len, scale, _window, cap, plain=plain,
                        alibi=alibi)
                return kv_cache.attend_gathered(
                    q, kv_cache.gather_kv_q8(pools.k[_li], ks, block_table),
                    kv_cache.gather_kv_q8(pools.v[_li], vs, block_table),
                    mask_pos, kv_len, scale, _window, cap, alibi, al_sym)
            kv_cache.write_kv(pools.k[_li], k_cur, rows, slots)
            kv_cache.write_kv(pools.v[_li], v_cur, rows, slots)
            if decode:
                return kv_cache.attend_decode(
                    q, pools.k[_li], pools.v[_li], block_table, kv_len, scale,
                    _window, cap, plain=plain, alibi=alibi)
            return kv_cache.attend_prefill(
                q, pools.k[_li], pools.v[_li], block_table, mask_pos, kv_len,
                scale, _window, cap, plain=plain, alibi=alibi,
                alibi_sym_pos=al_sym)

        x = llama_mod.forward_layer(x, lw, hp, rope_pos,
                                    w.inv_freq_for(window), w.rope_mscale,
                                    attend, plain=plain, li=li,
                                    mrope_pos=mrope_pos)
        if tap is not None:
            tap.append(x)
    return x


def _pool(x: torch.Tensor, n_valid: int, n_skip: int,
          pooling: str) -> torch.Tensor:
    """x [T, C] f32 final-normed hidden states, the first n_valid real ->
    the L2-normalized pooled embedding [C]: mean over positions in
    [n_skip, n_valid), the first position (cls) or the last valid one."""
    if pooling == "mean":
        t = torch.arange(x.shape[0], device=x.device)
        valid = ((t < n_valid) & (t >= n_skip))[:, None]
        denom = valid.float().sum().clamp(min=1.0)
        emb = torch.where(valid, x, 0.0).sum(dim=0) / denom
    elif pooling == "cls":
        emb = x[0]
    else:  # last
        emb = x[max(n_valid - 1, 0)]
    return emb / torch.linalg.vector_norm(emb).clamp(min=1e-12)


class Model:
    """Loaded weights + tokenizer on a device (llama_model analogue).

    kv_overrides: metadata overrides applied before the hparams are read
    (--override-kv); '*.' keys resolve to the model's arch."""

    def __init__(self, path: str, hp: HParams | None = None,
                 device: str | torch.device | None = None,
                 kv_overrides: dict | None = None):
        from ..common import log

        self.device = resolve_device(device)
        self.path = path
        t0 = time.time()
        self.reader = open_gguf(path)
        if kv_overrides:
            arch = self.reader.metadata.get("general.architecture", "llama")
            for k, v in kv_overrides.items():
                if k.startswith("*."):
                    k = f"{arch}{k[1:]}"
                log.info("kv override: %s = %r", k, v)
                self.reader.metadata[k] = v
        self.hp, w = load_weights(self.reader, hp)
        self.weights = to_device(w, self.device)
        self.load_seconds = time.time() - t0
        log.info("model %s: arch=%s n_layer=%d n_vocab=%d (load %.1fs)",
                 path.rsplit("/", 1)[-1], self.hp.arch, self.hp.n_layer,
                 self.hp.n_vocab, self.load_seconds)
        # as the reference: a file whose tokenizer cannot be built serves
        # token ids only (the CLI then refuses it)
        try:
            self.tokenizer = load_tokenizer(self.reader)
        except Exception:
            self.tokenizer = None

    @classmethod
    def from_weights(cls, hp: HParams, w: LlamaWeights,
                     device: str | torch.device | None = None) -> "Model":
        """A Model over host planes loaded elsewhere (weights.py converts
        them), with no file and no tokenizer behind it."""
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


def fit_n_ctx(model: Model, n_ctx: int) -> int:
    """n_ctx cut to the rows of a learned position table (BERT-base's 512,
    GPT-2's 1024), for the entry points that open a Context of a fixed
    size (the server, cli.embedding, cli.retrieval, cli.gritlm): a
    Context past the table is refused here, where the reference opens it
    and gives NaN past the table (ROADMAP §3, fault 15)."""
    table = model.weights.pos_embd
    if table is None or n_ctx <= table.shape[0]:
        return n_ctx
    from ..common import log

    log.info("n_ctx %d cut to the %d rows of the learned position table",
             n_ctx, table.shape[0])
    return table.shape[0]


@dataclasses.dataclass
class SeqState:
    """One sequence's host-side state (server slot analogue)."""
    seq_id: int
    tokens: list[int]
    table: SequenceBlockTable
    n_cached: int = 0  # tokens whose KV is in the pools
    # RoPE position of the next token minus n_cached: 0 while positions are
    # contiguous; Self-Extend makes it negative (llama_kv_cell.delta)
    pos_offset: int = 0


@dataclasses.dataclass
class WindowHandle:
    """An in-flight windowed decode (Context.decode_window_async).

    Host sequence state (SeqState.tokens / n_cached) is applied at fetch()
    time, not dispatch time: a CHAINED window's sampled tokens exist only on
    the device until its predecessor is fetched. Fetch in chain order."""
    seqs: list
    n_steps: int
    rowmap: np.ndarray              # caller order -> batch row
    bsz: int
    params: Any                     # DeviceSamplerParams (reused by chains)
    keep: torch.Tensor              # [n_valid] valid batch rows, device
    key: tuple[int, int]            # key_data of the window seed
    pos0: np.ndarray                # [bsz] first decoded position
    fed: list[int] | None = None    # fed token per seq (first window only)
    prev: "WindowHandle | None" = None
    toks_dev: Any = None            # [n_steps, bsz] device
    hist_dev: Any = None            # [bsz, HIST_LEN] device
    _result: np.ndarray | None = None

    def fetch(self) -> np.ndarray:
        """Sync this window's tokens to the host and apply sequence state.
        Returns [n_steps, B] int32 in caller order."""
        if self._result is None:
            toks = self.toks_dev.cpu().numpy().astype(np.int32)
            fed = self.fed
            if fed is None:
                if self.prev is None or self.prev._result is None:
                    raise RuntimeError(
                        "fetch a chained window only after its predecessor")
                fed = [int(self.prev._result[-1, self.rowmap[i]])
                       for i in range(len(self.seqs))]
            for i, s in enumerate(self.seqs):
                row = self.rowmap[i]
                s.tokens.append(fed[i])
                s.tokens.extend(int(t) for t in toks[:-1, row])
                s.n_cached += self.n_steps
            self._result = toks
            self.prev = None  # release the chain
        return self._result[:, self.rowmap]


class Context:
    """KV pools + block manager + step dispatch (llama_context analogue).

    plain=True runs the plain PyTorch version of every kernel (the check a
    run on the card is held against); the default runs the kernels."""

    def __init__(self, model: Model, n_ctx: int = 2048, n_seq_max: int = 8,
                 block_size: int = 16, num_blocks: int | None = None,
                 kv_type: str = "bf16", plain: bool = False):
        self.model = model
        self.device = model.device
        # long rope (phi3): the long table iff this Context is longer than
        # the pretraining window, as the reference Context picks it; a view
        # of the model's weights, so two Contexts may differ
        self.w = model.weights
        if (self.w.rope_inv_freq_long is not None
                and model.hp.rope_orig_ctx > 0
                and n_ctx > model.hp.rope_orig_ctx):
            self.w = dataclasses.replace(
                self.w, rope_inv_freq=self.w.rope_inv_freq_long)
        table = self.w.pos_embd
        if table is not None and n_ctx > table.shape[0]:
            # the reference's row lookup fills positions past the learned
            # table with NaN (jnp.take), so its logits there are NaN
            # (ROADMAP §3, fault 15); refuse such a Context instead
            raise ValueError(
                f"n_ctx {n_ctx} exceeds the learned position table of "
                f"{table.shape[0]} rows (arch {model.hp.arch}); use "
                f"n_ctx <= {table.shape[0]}")
        self.kv_type = kv_type
        self.n_ctx = n_ctx
        self.block_size = block_size
        self.plain = plain
        # block-table width: enough blocks for n_ctx tokens (the reference
        # floors n_ctx / block_size, which drops a sequence's last block
        # from attention when block_size does not divide n_ctx; ROADMAP §3)
        self.nbmax = -(-n_ctx // block_size)
        if num_blocks is None:
            num_blocks = max(n_seq_max * self.nbmax, 8)
        self.num_blocks = num_blocks
        # host swap backing (swapBlocks): over-committed blocks move to the
        # host instead of corrupting live sequences
        store = HostSwapStore(self._read_block, self._write_block)
        self.mgrs = [BlockManager(num_blocks, swap_store=store)]
        self.pools = kv_cache.new_kv_pools(model.hp, num_blocks, block_size,
                                           device=self.device, kv_type=kv_type)
        self.seqs: dict[int, SeqState] = {}
        self._next_id = 0
        # abort callback (ggml_abort_callback analogue): checked at every
        # engine entry; a True return raises DecodeAborted (code 2)
        self.abort_callback = None

    def _check_abort(self) -> None:
        if self.abort_callback is not None and self.abort_callback():
            from .errors import DecodeAborted

            raise DecodeAborted("decode aborted by callback")

    @property
    def mgr(self) -> BlockManager:
        return self.mgrs[0]

    # -- host swap data plane (HostSwapStore callbacks) -----------------------

    def _read_block(self, blk: int) -> tuple:
        """Device -> host copy of one physical block across all layers."""
        return tuple(t.cpu() for t in kv_cache.gather_block(self.pools, blk))

    def _write_block(self, data: tuple, blk: int) -> None:
        """Host -> device restore of a swapped block."""
        kv_cache.scatter_block(self.pools, data, blk)

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

    def fork_seq(self, s: SeqState) -> SeqState:
        """COW fork (seq_cp analogue): the child shares s's blocks until
        either writes to one, and keeps s's Self-Extend pos_offset (the
        reference's fork leaves it at 0)."""
        child = SeqState(self._next_id, list(s.tokens), s.table.fork(),
                         s.n_cached, pos_offset=s.pos_offset)
        self._next_id += 1
        self.seqs[child.seq_id] = child
        return child

    # -- position edits on the live cache (K-shift) --------------------------

    def _seq_slot(self, s: SeqState, i: int) -> int:
        return s.table.blocks[i // self.block_size] * self.block_size + \
            i % self.block_size

    def _apply_shift(self, s: SeqState, src: list[int], dst: list[int],
                     delta: list[int]) -> None:
        if self.model.hp.pos_embd != "rope":
            # K holds no rotation to re-base (learned positions are in its
            # values); the reference's Self-Extend and prompt-cache reuse
            # rotate it all the same (ROADMAP §3, fault 16)
            raise NotImplementedError(
                "a K-shift requires rope positions (arch "
                f"{self.model.hp.arch} uses {self.model.hp.pos_embd} ones)")
        s.table.ensure_resident()
        # un-share any COW blocks first: the shift mutates pool data in place
        for bi in range(len(s.table.blocks)):
            s.table._ensure_writable(bi)
        self._drain_copies([s])
        hp = self.model.hp
        with torch.inference_mode():
            kv_cache.apply_shift(self.pools, self._to_dev(np.asarray(src)),
                                 self._to_dev(np.asarray(dst)),
                                 self._to_dev(np.asarray(delta, np.int32)),
                                 [self.w.inv_freq_for(
                                     hparams_mod.layer_window(hp, li))
                                  for li in range(hp.n_layer)],
                                 # an MLA K ropes its pe tail only
                                 hp.head_dim - hp.rope_dim if hp.n_lora_kv
                                 else 0)

    def shift_context(self, s: SeqState, n_keep: int, n_discard: int) -> None:
        """Context shift: drop tokens [n_keep, n_keep+n_discard), slide the
        tail down and re-rotate its K by -n_discard (llama-cli: seq_rm +
        seq_add(-n_discard) + K-shift)."""
        n = s.n_cached
        if n_discard <= 0 or n_keep + n_discard > n:
            raise ValueError("shift_context: bad n_keep/n_discard")
        if self.model.hp.pos_embd != "rope":
            # as the reference: learned positions live in K's values
            raise NotImplementedError(
                "context shift requires rope positions (arch "
                f"{self.model.hp.arch} uses {self.model.hp.pos_embd} ones)")
        s.table.ensure_resident()
        src = [self._seq_slot(s, i) for i in range(n_keep + n_discard, n)]
        dst = [self._seq_slot(s, i) for i in range(n_keep, n - n_discard)]
        if src:
            self._apply_shift(s, src, dst, [-n_discard] * len(src))
        s.tokens = s.tokens[:n_keep] + s.tokens[n_keep + n_discard:]
        s.n_cached = n - n_discard
        s.table.truncate(s.n_cached)
        # moved tokens keep their relative rope spacing, so pos_offset holds

    def compact_reuse(self, s: SeqState, new_tokens: list[int],
                      n_reuse_min: int, max_keep: int | None = None) -> int:
        """Chunked prompt-cache reuse (the n_cache_reuse path): keep the
        longest common prefix in place, K-shift interior cached chunks of >=
        n_reuse_min matching tokens down to their new positions, discard the
        rest. On return the cache holds new_tokens[:ret] at contiguous
        positions; max_keep caps the kept prefix. Returns 0 after
        self_extend. A file without rope positions keeps the common prefix
        only: its K cannot be re-based (the reference rotates it all the
        same, ROADMAP §3, fault 16)."""
        if s.pos_offset:
            return 0
        if self.model.hp.pos_embd != "rope":
            n_reuse_min = 0
        old = s.tokens
        n_old = s.n_cached
        limit = len(new_tokens) if max_keep is None else min(
            max_keep, len(new_tokens))
        lcp = 0
        while lcp < min(n_old, limit) and old[lcp] == new_tokens[lcp]:
            lcp += 1
        head_c, head_p = lcp, lcp
        src: list[int] = []
        dst: list[int] = []
        delta: list[int] = []
        if n_reuse_min > 0 and head_c < n_old and head_p < limit:
            s.table.ensure_resident()
            while head_c < n_old and head_p < limit:
                n_match = 0
                while (head_c + n_match < n_old and
                       head_p + n_match < limit and
                       old[head_c + n_match] == new_tokens[head_p + n_match]):
                    n_match += 1
                if n_match >= n_reuse_min:
                    if head_c != head_p:
                        for t in range(n_match):
                            src.append(self._seq_slot(s, head_c + t))
                            dst.append(self._seq_slot(s, head_p + t))
                            delta.append(head_p - head_c)
                    head_c += n_match
                    head_p += n_match
                else:
                    head_c += 1
        total = head_p
        if src:
            self._apply_shift(s, src, dst, delta)
        s.tokens = list(new_tokens[:total])
        s.n_cached = total
        s.table.truncate(total)
        return total

    def self_extend(self, s: SeqState, n_keep: int, group: int) -> None:
        """Self-Extend grouped attention: compress cached rope positions
        beyond n_keep by `group` (llama_kv_self_seq_add + seq_div). Slots
        stay put; only K's rotation is re-based, and later tokens continue
        from the compressed position through SeqState.pos_offset."""
        n = s.n_cached
        if group <= 1 or n_keep >= n:
            return
        s.table.ensure_resident()
        off = s.pos_offset
        src, delta = [], []
        base = n_keep + off
        last_new = base - 1
        for i in range(n_keep, n):
            old_p = i + off
            new_p = base + (old_p - base) // group
            last_new = new_p
            if new_p != old_p:
                src.append(self._seq_slot(s, i))
                delta.append(new_p - old_p)
        if src:
            self._apply_shift(s, src, src, delta)
        s.pos_offset = last_new + 1 - n

    def truncate_seq(self, s: SeqState, n: int) -> None:
        """Roll the sequence's cache back to n tokens (frees trailing
        blocks): the windowed decode discards KV written past a stop."""
        if n > s.n_cached:
            raise ValueError("truncate_seq: n > n_cached")
        s.table.truncate(n)
        s.tokens = s.tokens[:n]
        s.n_cached = n

    # -- steps ----------------------------------------------------------------

    def _table_arr(self, seqs: Seq[SeqState]) -> np.ndarray:
        bt = np.zeros((len(seqs), self.nbmax), np.int32)
        for i, s in enumerate(seqs):
            blocks = s.table.resident_blocks()[: self.nbmax]
            bt[i, : len(blocks)] = blocks
        return bt

    def _drain_copies(self, seqs: Seq[SeqState]) -> None:
        """Apply the COW copies the block tables queued, before any write
        to the pools."""
        copies = []
        for s in seqs:
            copies.extend(s.table.pending_copies)
            s.table.pending_copies = []
        if copies:
            src, dst = np.asarray(copies, np.int64).T
            with torch.inference_mode():
                kv_cache.apply_copies(self.pools, self._to_dev(src),
                                      self._to_dev(dst))

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return upload(a, self.device)

    def _step(self, tok, pos, bt, slot_arr, kv_len, decode: bool, rd=None,
              causal: bool = True, tap: list | None = None, x_embd=None,
              mrope_pos=None):
        """Upload one step's host arrays and run the forward. Padding rows
        (slot -1) are dropped from the KV scatter here, on the host.
        x_embd (a device tensor) replaces the token rows; mrope_pos is a
        host array of M-RoPE streams."""
        if int(kv_len.max()) > self.n_ctx:
            # the dispatch drops windows >= n_ctx on this bound
            raise RuntimeError(f"kv_len {int(kv_len.max())} past n_ctx "
                               f"{self.n_ctx}")
        flat = slot_arr.reshape(-1)
        keep = np.nonzero(flat >= 0)[0]
        return _forward(
            self.w, self.pools, self._to_dev(tok), self._to_dev(pos),
            self._to_dev(bt), self._to_dev(keep.astype(np.int64)),
            self._to_dev(flat[keep].astype(np.int64)), self._to_dev(kv_len),
            hp=self.model.hp, decode=decode, n_ctx=self.n_ctx,
            plain=self.plain,
            rope_delta=None if rd is None else self._to_dev(rd),
            causal=causal, tap=tap, x_embd=x_embd,
            mrope_pos=None if mrope_pos is None else self._to_dev(mrope_pos))

    def _check_room(self, s: SeqState, n: int) -> None:
        if s.n_cached + n > self.n_ctx:
            raise ValueError(
                f"sequence {s.seq_id}: {s.n_cached} + {n} tokens exceed "
                f"n_ctx={self.n_ctx} (shift the context first)")

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return llama_mod.lm_head(self.w, self.model.hp, x, self.plain)

    def _chunk(self, s: SeqState, n: int, what: str) -> tuple:
        """Reserve n slots at the end of s and build one chunk's host
        arrays, padded to its TOKEN_BUCKETS size tb: (tb, positions
        t0..t0+n, slot ids with -1 padding, the block table, kv_len)."""
        if n == 0:
            raise ValueError(f"{what}: empty token list")
        self._check_room(s, n)
        tb = _bucket(n, TOKEN_BUCKETS)
        if n > tb:
            raise ValueError(f"{what}: {n} tokens exceed the largest bucket")
        t0 = s.n_cached
        slots = s.table.append_tokens(n)
        self._drain_copies([s])
        pos = np.zeros((1, tb), np.int32)
        pos[0, :n] = np.arange(t0, t0 + n)
        slot_arr = np.full((1, tb), -1, np.int32)
        slot_arr[0, :n] = slots
        return (tb, pos, slot_arr, self._table_arr([s]),
                np.asarray([t0 + n], np.int32))

    def prefill(self, s: SeqState, tokens: list[int],
                all_logits: bool = False, top_k: int = 0):
        """Append tokens to the sequence and run prefill. Returns last-token
        logits [V] (or [T, V] when all_logits), float32 numpy.

        top_k > 0: return (vals [top_k], ids [top_k]) instead, the
        candidate download that replaces the [V] logits transfer."""
        self._check_abort()
        if top_k > 0 and all_logits:
            raise NotImplementedError("prefill(top_k=...) is last-position only")
        n = len(tokens)
        if all_logits and s.pos_offset:
            raise NotImplementedError("all_logits after self_extend")
        tb, pos, slot_arr, bt, kv_len = self._chunk(s, n, "prefill")
        tok = np.zeros((1, tb), np.int32)
        tok[0, :n] = tokens
        rd = np.asarray([s.pos_offset], np.int32) if s.pos_offset else None
        s.tokens.extend(tokens)
        s.n_cached += n
        with torch.inference_mode():
            x = self._step(tok, pos, bt, slot_arr, kv_len, False, rd)
            if all_logits:
                return self._logits(x)[0, :n].float().cpu().numpy()
            logits = self._logits(x[:, n - 1:n])[0, 0].float()
            if top_k > 0:
                vals, ids = ds.top_k(logits[None], top_k)
                return (vals[0].cpu().numpy(),
                        ids[0].to(torch.int32).cpu().numpy())
            return logits.cpu().numpy()

    def prefill_embeds(self, s: SeqState, embeds,
                       placeholder_token: int = -1,
                       mrope_pos: np.ndarray | None = None) -> np.ndarray:
        """Prefill pre-computed input embeddings [T, C] (image features
        from models/clip.encode_image or models/qwen2vl_vision
        .encode_image; a numpy array or a tensor) instead of tokens, the
        llava_eval_image_embed analogue. s.tokens records
        `placeholder_token` for these positions, whose mask positions are
        t0..t0+T. mrope_pos [T, 3]: qwen2vl's image streams, which rope q
        and k in place of the positions; the caller then sets
        s.pos_offset so the following text ropes at the compressed
        position (qwen2vl-cli.cpp). Returns last-position logits [V].

        The streams carry the compressed position already, so an image
        with them may follow one (s.pos_offset nonzero); the reference
        refuses it there and so cannot take a second qwen2vl image
        (ROADMAP §3, fault 25). Without streams a nonzero pos_offset
        (Self-Extend) raises, as in the reference."""
        self._check_abort()
        if s.pos_offset and mrope_pos is None:
            raise NotImplementedError("prefill_embeds after self_extend")
        hp = self.model.hp
        n = embeds.shape[0]
        if embeds.shape[-1] != hp.n_embd:
            raise ValueError(f"prefill_embeds: embeddings of width "
                             f"{embeds.shape[-1]}, the model's is "
                             f"{hp.n_embd}")
        tb, pos, slot_arr, bt, kv_len = self._chunk(s, n, "prefill_embeds")
        mr = None
        if mrope_pos is not None:
            mr = np.zeros((1, tb, 3), np.int32)
            mr[0, :n] = np.asarray(mrope_pos, np.int32)
        s.tokens.extend([placeholder_token] * n)
        s.n_cached += n
        with torch.inference_mode():
            e = (embeds if isinstance(embeds, torch.Tensor)
                 else torch.from_numpy(np.array(embeds, np.float32)))
            x_embd = torch.zeros((1, tb, hp.n_embd), dtype=torch.float32,
                                 device=self.device)
            x_embd[0, :n] = e.to(self.device, torch.float32)
            x = self._step(np.zeros((1, tb), np.int32), pos, bt, slot_arr,
                           kv_len, False, x_embd=x_embd, mrope_pos=mr)
            return self._logits(x[:, n - 1:n])[0, 0].float().cpu().numpy()

    def prefill_nll(self, s: SeqState, tokens: list[int]) -> np.ndarray:
        """Prefill `tokens` and return the negative log-likelihood of
        tokens[i+1] given the prefix through tokens[i], float32 [n-1] (the
        perplexity path). Every position's logits go through the lm head
        (K1's GEMM on the card); the log-softmax and the target gather
        stay on the device, and only the n-1 values come back."""
        self._check_abort()
        n = len(tokens)
        if n < 2:
            raise ValueError("prefill_nll needs >= 2 tokens")
        if s.pos_offset:
            raise NotImplementedError("prefill_nll after self_extend")
        tb, pos, slot_arr, bt, kv_len = self._chunk(s, n, "prefill_nll")
        tok = np.zeros((1, tb), np.int32)
        tok[0, :n] = tokens
        s.tokens.extend(tokens)
        s.n_cached += n
        with torch.inference_mode():
            x = self._step(tok, pos, bt, slot_arr, kv_len, False)
            logp = torch.log_softmax(self._logits(x)[0, :n - 1].float(), -1)
            tgt = self._to_dev(np.asarray(tokens[1:], np.int64))
            nll = -torch.gather(logp, 1, tgt[:, None])[:, 0]
            return nll.cpu().numpy()

    def _rows(self, b: int) -> int:
        """Decode batch rows for b sequences: the next power of two (the
        reference's LLAMA_TPU_DECODE_PAD minimum is 1 by default)."""
        return 1 << (max(b, 1) - 1).bit_length()

    def decode(self, seqs: Seq[SeqState], tokens: Seq[int], top_k: int = 0):
        """One decode step for a batch of sequences. Returns logits [B, V]
        in the caller's order; top_k > 0 returns (vals [B, top_k],
        ids [B, top_k]) instead (the host chain's candidate download)."""
        self._check_abort()
        b = len(seqs)
        for s in seqs:
            self._check_room(s, 1)
        slot_list = [s.table.append_tokens(1)[0] for s in seqs]
        self._drain_copies(seqs)
        bsz = self._rows(b)
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
        rd = None
        if any(s.pos_offset for s in seqs):
            rd = np.zeros((bsz,), np.int32)
            rd[:b] = [s.pos_offset for s in seqs]
        for s, t in zip(seqs, tokens):
            s.tokens.append(int(t))
            s.n_cached += 1
        with torch.inference_mode():
            x = self._step(tok, pos, bt, slot_arr, kv_len, True, rd)
            logits = self._logits(x)[:b, 0].float()
            if top_k > 0:
                vals, ids = ds.top_k(logits, top_k)
                return vals.cpu().numpy(), ids.to(torch.int32).cpu().numpy()
            return logits.cpu().numpy()

    def prefill_batch(self, seqs: Seq[SeqState],
                      rows: Seq[list[int]]) -> list[np.ndarray]:
        """Teacher-forced batched prefill returning ALL-position logits
        [T_i, V] per sequence (ragged rows padded, sliced on return): the
        batched verification pass of speculative decoding."""
        self._check_abort()
        b = len(seqs)
        if any(s.pos_offset for s in seqs):
            raise NotImplementedError("prefill_batch after self_extend")
        lens = [len(r) for r in rows]
        if min(lens) == 0:
            raise ValueError("prefill_batch: empty token list")
        for s, n in zip(seqs, lens):
            self._check_room(s, n)
        tb = _bucket(max(lens), TOKEN_BUCKETS)
        slot_rows = [s.table.append_tokens(n) for s, n in zip(seqs, lens)]
        self._drain_copies(seqs)
        bsz = self._rows(b)
        tok = np.zeros((bsz, tb), np.int32)
        pos = np.zeros((bsz, tb), np.int32)
        slot_arr = np.full((bsz, tb), -1, np.int32)
        bt = np.zeros((bsz, self.nbmax), np.int32)
        kv_len = np.ones((bsz,), np.int32)
        bt[:b] = self._table_arr(seqs)
        for i, s in enumerate(seqs):
            n = lens[i]
            tok[i, :n] = rows[i]
            pos[i, :n] = np.arange(s.n_cached, s.n_cached + n)
            slot_arr[i, :n] = slot_rows[i]
            kv_len[i] = s.n_cached + n
        for s, toks_i in zip(seqs, rows):
            s.tokens.extend(toks_i)
            s.n_cached += len(toks_i)
        with torch.inference_mode():
            x = self._step(tok, pos, bt, slot_arr, kv_len, False)
            logits = self._logits(x).float().cpu().numpy()
        return [logits[i, : lens[i]] for i in range(b)]

    def embed(self, tokens: list[int], pooling: str | None = None,
              causal: bool | None = None, n_skip: int = 0) -> np.ndarray:
        """Pooled, L2-normalized embedding of a token sequence [n_embd]
        (float32 numpy): one prefill of a scratch sequence, the final norm,
        then mean, cls or last pooling over the positions >= n_skip.
        causal=False runs bidirectional attention (gritlm's embedding mode).
        pooling/causal default to the model's hparams (decoders: causal
        mean)."""
        self._check_abort()
        hp = self.model.hp
        if pooling is None:
            pooling = hp.pooling if hp.pooling != "none" else "mean"
        if causal is None:
            causal = hp.causal
        n = len(tokens)
        if n == 0:
            raise ValueError("embed: empty token list")
        tb = _bucket(n, TOKEN_BUCKETS)
        if n > tb:
            raise ValueError(f"embed: {n} tokens exceed the largest bucket")
        s = self.new_seq()
        try:
            slots = s.table.append_tokens(n)
            self._drain_copies([s])
            tok = np.zeros((1, tb), np.int32)
            tok[0, :n] = tokens
            pos = np.zeros((1, tb), np.int32)
            pos[0, :n] = np.arange(n)
            slot_arr = np.full((1, tb), -1, np.int32)
            slot_arr[0, :n] = slots
            with torch.inference_mode():
                x = self._step(tok, pos, self._table_arr([s]), slot_arr,
                               np.asarray([n], np.int32), False,
                               causal=causal)
                x = llama_mod.final_norm(self.w, hp, x).float()[0]
                emb = _pool(x, n, n_skip, pooling)
                return emb.cpu().numpy()
        finally:
            self.free_seq(s)

    # -- windowed decode -------------------------------------------------------

    def _window_rows(self, seqs: Seq[SeqState], n_steps: int
                     ) -> tuple[int, np.ndarray]:
        """Reserve n_steps tokens of blocks for every sequence and apply
        the COW copies; return (batch rows, block tables [bsz, nbmax])."""
        for s in seqs:
            self._check_room(s, n_steps)
            s.table.append_tokens(n_steps)
        self._drain_copies(seqs)
        bsz = self._rows(len(seqs))
        bt = np.zeros((bsz, self.nbmax), np.int32)
        bt[: len(seqs)] = self._table_arr(seqs)
        return bsz, bt

    def _window_loop(self, tok, pos, bt, keep, n_steps: int, pick):
        """n_steps decode steps on device tensors, with no host sync: tok
        [bsz] int32 fed tokens, pos [bsz] int32 their positions, bt
        [bsz, nbmax] int32 block tables, keep [n] int64 the valid rows
        (the others' KV writes drop). Slots come from the tables on the
        device, as the reference's window body derives them. pick(logits
        [bsz, V] f32, tok, pos) -> next tokens [bsz]. Returns the tokens
        [n_steps, bsz] int64."""
        bs = self.block_size
        out = torch.empty((n_steps, tok.shape[0]), dtype=torch.int64,
                          device=self.device)
        kpos = None
        for j in range(n_steps):
            kpos = pos[keep].long()
            slots = bt[keep, kpos // bs].long() * bs + kpos % bs
            # _window_rows checked the room, so pos + 1 <= n_ctx
            x = _forward(self.w, self.pools, tok[:, None], pos[:, None], bt,
                         keep, slots, pos + 1, hp=self.model.hp, decode=True,
                         n_ctx=self.n_ctx, plain=self.plain)
            nxt = pick(self._logits(x)[:, 0].float(), tok, pos)
            out[j] = nxt
            tok, pos = nxt.to(torch.int32), pos + 1
        return out

    def decode_window_async(self, seqs: Seq[SeqState],
                            tokens: Seq[int] | None = None,
                            samplers: Seq[Any] | None = None,
                            n_steps: int = 16, seed: int = 0,
                            histories: Seq[list[int]] | None = None,
                            carry: "WindowHandle | None" = None
                            ) -> WindowHandle:
        """Queue n_steps batched decode+sample steps on the device WITHOUT
        waiting; handle.fetch() syncs and applies host state. Pass the
        previous (unfetched) handle as `carry` to chain the next window on
        the device: its fed tokens and penalty history are the previous
        window's device tensors. A chained window speculates that no
        sequence stops mid-window; callers roll back with truncate_seq."""
        self._check_abort()
        if any(s.pos_offset for s in seqs):
            raise NotImplementedError("decode_window after self_extend")
        bsz, bt = self._window_rows(seqs, n_steps)
        if carry is not None:
            if carry.seqs is not seqs and list(carry.seqs) != list(seqs):
                raise ValueError("carry must cover the same sequences")
            handle = WindowHandle(
                seqs=list(seqs), n_steps=n_steps, rowmap=carry.rowmap,
                bsz=carry.bsz, params=carry.params, keep=carry.keep,
                key=carry.key, pos0=carry.pos0 + carry.n_steps, prev=carry)
            tok0 = carry.toks_dev[-1].to(torch.int32)
            hist0 = carry.hist_dev
        else:
            b = len(seqs)
            tok0 = np.zeros((bsz,), np.int32)
            pos0 = np.zeros((bsz,), np.int32)
            tok0[:b] = tokens
            pos0[:b] = [s.n_cached for s in seqs]
            hist_rows = [list(s.tokens) if histories is None
                         else list(histories[i]) for i, s in enumerate(seqs)]
            from .sampling import SamplerParams

            greedy = SamplerParams(temp=0.0)
            params = ds.DeviceSamplerParams.from_rows(
                [sp if sp is not None else greedy for sp in samplers], bsz,
                self.device)
            handle = WindowHandle(
                seqs=list(seqs), n_steps=n_steps, rowmap=np.arange(b),
                bsz=bsz, params=params,
                keep=self._to_dev(np.arange(b, dtype=np.int64)),
                key=ds.key_data(seed), pos0=pos0,
                fed=[int(t) for t in tokens])
            tok0 = self._to_dev(tok0)
            hist0 = self._to_dev(ds.make_history(hist_rows, bsz))
        hist = [hist0]

        def pick(logits, tok, pos):
            # per-row noise keyed on (key, row seed, position): fixed-seed
            # requests reproduce regardless of window phase or co-batching
            hist[0] = ds.push_history(hist[0], tok)
            return ds.sample_tokens(logits, handle.params, hist[0],
                                    handle.key, pos)

        with torch.inference_mode():
            handle.toks_dev = self._window_loop(
                tok0, self._to_dev(handle.pos0), self._to_dev(bt),
                handle.keep, n_steps, pick)
        handle.hist_dev = hist[0]
        return handle

    def decode_window(self, seqs: Seq[SeqState], tokens: Seq[int],
                      samplers: Seq[Any], n_steps: int, seed: int = 0,
                      histories: Seq[list[int]] | None = None) -> np.ndarray:
        """n_steps batched decode+sample steps with one sync at the end.

        tokens[i] is sequence i's next input token; samplers[i] a
        SamplerParams that device_sampling.eligible accepts (None: greedy).
        histories[i] seeds row i's penalty ring (pass the GENERATED tokens
        only to match the host SamplerChain; default s.tokens). Returns
        [n_steps, B] int32. All n_steps tokens' KV but the last is cached on
        return; callers that stop early truncate_seq back."""
        return self.decode_window_async(
            seqs, tokens, samplers, n_steps, seed, histories).fetch()

    def draft_window(self, seqs: Seq[SeqState], tokens: Seq[int],
                     n_steps: int) -> tuple[np.ndarray, np.ndarray]:
        """Batched greedy proposal loop for speculative drafting: feeds
        tokens[i] to sequence i and generates n_steps greedy successors with
        one sync, returning ([n_steps, B] tokens, [n_steps, B] softmax
        probability of each). All n_steps tokens' KV is cached; callers roll
        back unaccepted tails with truncate_seq."""
        self._check_abort()
        b = len(seqs)
        bsz, bt = self._window_rows(seqs, n_steps)
        tok0 = np.zeros((bsz,), np.int32)
        pos0 = np.zeros((bsz,), np.int32)
        tok0[:b] = tokens
        pos0[:b] = [s.n_cached for s in seqs]
        probs = torch.empty((n_steps, bsz), dtype=torch.float32,
                            device=self.device)
        step = [0]

        def pick(logits, tok, pos):
            nxt = torch.argmax(logits, dim=-1)
            lse = torch.logsumexp(logits, dim=-1)
            probs[step[0]] = torch.exp(
                torch.gather(logits, 1, nxt[:, None])[:, 0] - lse)
            step[0] += 1
            return nxt

        with torch.inference_mode():
            toks = self._window_loop(
                self._to_dev(tok0), self._to_dev(pos0), self._to_dev(bt),
                self._to_dev(np.arange(b, dtype=np.int64)), n_steps, pick)
            toks = toks.cpu().numpy().astype(np.int32)
            ps = probs.cpu().numpy()
        for i, s in enumerate(seqs):
            s.tokens.append(int(tokens[i]))
            s.tokens.extend(int(t) for t in toks[:-1, i])
            s.n_cached += n_steps
        return toks[:, :b], ps[:, :b]


def generate(ctx: Context, prompt_tokens: list[int], max_new_tokens: int,
             sampler: Callable[[np.ndarray], int] | None = None,
             eos_ids: set[int] | None = None,
             n_keep: int = 0, ctx_shift: bool = True) -> Iterator[int]:
    """llama-cli style generation loop (greedy by default), with context
    shift past n_ctx: keep n_keep head tokens, discard half of the rest,
    K-shift the tail down."""
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
            if ctx_shift and s.n_cached + 1 >= ctx.n_ctx:
                nk = min(n_keep, s.n_cached - 2)
                ctx.shift_context(s, nk, max((s.n_cached - nk) // 2, 1))
            logits = ctx.decode([s], [tok])[0]
    finally:
        ctx.free_seq(s)
