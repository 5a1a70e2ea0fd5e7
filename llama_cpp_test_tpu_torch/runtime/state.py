"""Sequence state save/restore — the session-file analogue.

Counterpart of llama_cpp_test_tpu/runtime/state.py (llama_state_seq_get_data
/ set_data re-shaped for the paged cache): a saved sequence is its token
list plus, per layer, the K/V of exactly n_cached positions, gathered from
the pools through the block table. Restore allocates fresh blocks and
scatters the values back. Used for prompt-cache session files
(cli/main.py --prompt-cache) and the server's slot save/restore.

Format: the reference's npz, with the same magic, version and keys (meta,
k{layer}, v{layer} as float32 [KV, n, D], KV the layer's own head count,
so openelm's and deci's layers keep their own shapes), so a bf16 session
file saved by either package restores in the other.

A q8_0 pool saves its dequantized values (plane * scale) under those keys
and restores them through the quantizing write, which gives back the same
int8 planes and each scale within one float32 ulp. (The reference gathers
the int8 planes alone and writes them back as bf16 values, so a q8_0
sequence restores under whatever scales its fresh blocks held.)
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import kv_cache
from .engine import Context, SeqState

MAGIC = "llamacpp-tpu-seq"
MAGIC_CTX = "llamacpp-tpu-ctx"
VERSION = 1


def _gather_seq_arrays(ctx: Context, s: SeqState, prefix: str = "") -> dict:
    """Per-layer float32 K/V [KV_l, n_cached, D] via the block table, read
    to the host in one copy each for K and V (the layers concatenated
    flat, then split on the host)."""
    blocks = ctx._to_dev(np.asarray(s.table.resident_blocks(), np.int64))
    arrays = {}
    with torch.inference_mode():
        for name, per_layer in zip("kv", kv_cache.gather_seq(
                ctx.pools, blocks, s.n_cached)):
            flat = torch.cat([t.reshape(-1) for t in per_layer]).cpu().numpy()
            off = 0
            for li, t in enumerate(per_layer):
                arrays[f"{prefix}{name}{li}"] = \
                    flat[off:off + t.numel()].reshape(t.shape)
                off += t.numel()
    return arrays


def _write(path: str, meta: dict, arrays: dict) -> int:
    # through a file object: np.savez appends '.npz' to a bare path
    with open(path, "wb") as f:
        np.savez_compressed(f, meta=json.dumps(meta), **arrays)
    return os.path.getsize(path)


def _read(path: str, magic: str, what: str):
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if meta.get("magic") != magic:
        raise ValueError(f"{path}: not a {what} state file")
    if meta.get("version") != VERSION:
        raise ValueError(f"{path}: unsupported version {meta.get('version')}")
    return data, meta


def _restore(ctx: Context, data, prefix: str, n: int) -> SeqState:
    """A new sequence in ctx holding the n saved positions of `prefix`."""
    s = ctx.new_seq()
    slots = s.table.append_tokens(n)
    ctx._drain_copies([s])
    n_layer = ctx.model.hp.n_layer
    load = lambda name: [ctx._to_dev(np.asarray(
        data[f"{prefix}{name}{li}"], np.float32)) for li in range(n_layer)]
    with torch.inference_mode():
        kv_cache.scatter_seq(ctx.pools, load("k"), load("v"),
                             ctx._to_dev(np.asarray(slots, np.int64)))
    s.n_cached = n
    return s


def save_seq_state(ctx: Context, s: SeqState, path: str) -> int:
    """Returns bytes written. The Self-Extend offset is not kept, as in
    the reference."""
    meta = {
        "magic": MAGIC,
        "version": VERSION,
        "tokens": [int(t) for t in s.tokens],
        "n_cached": int(s.n_cached),
        "model": ctx.model.path,
    }
    return _write(path, meta, _gather_seq_arrays(ctx, s))


def load_seq_state(ctx: Context, path: str) -> SeqState:
    """Allocates a new sequence in ctx and restores its cache."""
    data, meta = _read(path, MAGIC, "sequence")
    if meta.get("model") and meta["model"] != ctx.model.path:
        # a session from a different model would inject foreign KV
        raise ValueError(
            f"{path}: session was saved from {meta['model']!r}, not "
            f"{ctx.model.path!r} — refusing to restore")
    s = _restore(ctx, data, "", int(meta["n_cached"]))
    s.tokens = [int(t) for t in meta["tokens"]]
    return s


# ---------------------------------------------------------------------------
# full-context state blob (GGSN analogue)


def save_state(ctx: Context, path: str) -> int:
    """Save the whole context — every live sequence's tokens, position
    offset and cached K/V — in one blob (llama_state_save_file analogue).
    Restore with load_state into a context of the same model and config.
    Returns bytes written."""
    seqs = sorted(ctx.seqs.values(), key=lambda s: s.seq_id)
    arrays, metas = {}, []
    for i, s in enumerate(seqs):
        arrays.update(_gather_seq_arrays(ctx, s, prefix=f"s{i}_"))
        metas.append({"seq_id": s.seq_id,
                      "tokens": [int(t) for t in s.tokens],
                      "n_cached": int(s.n_cached),
                      "pos_offset": int(s.pos_offset),
                      "group": 0})
    meta = {"magic": MAGIC_CTX, "version": VERSION, "model": ctx.model.path,
            "n_ctx": ctx.n_ctx, "block_size": ctx.block_size, "seqs": metas,
            "next_id": ctx._next_id}
    return _write(path, meta, arrays)


def load_state(ctx: Context, path: str) -> list[SeqState]:
    """Restore a full-context blob into ctx (which must hold no live
    sequences), every sequence with its saved seq_id. Returns the
    sequences in saved order."""
    data, meta = _read(path, MAGIC_CTX, "context")
    if ctx.seqs:
        raise ValueError("load_state: context already has live sequences")
    if meta["block_size"] != ctx.block_size or meta["n_ctx"] != ctx.n_ctx:
        raise ValueError("load_state: context config mismatch "
                         f"(saved n_ctx={meta['n_ctx']} "
                         f"block_size={meta['block_size']})")
    out = []
    for i, sm in enumerate(meta["seqs"]):
        s = _restore(ctx, data, f"s{i}_", int(sm["n_cached"]))
        ctx.seqs.pop(s.seq_id, None)
        s.seq_id = int(sm["seq_id"])
        s.tokens = [int(t) for t in sm["tokens"]]
        s.pos_offset = int(sm["pos_offset"])
        ctx.seqs[s.seq_id] = s
        out.append(s)
    ctx._next_id = max(int(meta.get("next_id", 0)),
                       max((s.seq_id + 1 for s in out), default=0))
    return out
