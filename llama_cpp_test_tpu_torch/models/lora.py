"""LoRA adapters (the llama-adapter analogue).

Counterpart of llama_cpp_test_tpu/models/lora.py. Loads a LoRA GGUF
(tensors `<base>.lora_a` [r, K] / `<base>.lora_b` [N, r], metadata
adapter.lora.alpha) and attaches the low-rank pairs to the model's
LayerWeights, so every projection computes y = W x + scale * B (A x) with
scale = alpha / r (models/llama.lora_delta). The base projection stays on
its kernel (K1 on CUDA); the update is two small torch matmuls beside it.

lora_b rows of attn_q and attn_k are permuted as the loader permutes the
base rows (NORM-layout GGUF rows -> half-split rope, at the layer's own
head counts; a NEOX arch's rows stay as they are), so the update lands in
the same space. (The reference permutes at the global counts, which
raises on a deci layer with fewer KV heads, ROADMAP §3 fault 21.) An MLA
file's plain attn_q (deepseek2-lite) has only each head's pe tail
permuted, as the loader permutes it (the reference permutes whole heads,
fault 23).

merge_lora() bakes an adapter into a dense GGUF (the export-lora tool),
on the host in numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter
from ..weights import lora_to_torch
from .hparams import HParams, hparams_from_metadata
from .llama import LlamaWeights, _mla_q_perm, _unpermute_rows

# LayerWeights field <-> GGUF tensor base name
_TARGETS = {
    "wq": "attn_q.weight", "wk": "attn_k.weight", "wv": "attn_v.weight",
    "wo": "attn_output.weight", "w_gate": "ffn_gate.weight",
    "w_up": "ffn_up.weight", "w_down": "ffn_down.weight",
}


@dataclasses.dataclass
class LoraPair:
    a: Any  # [r, K] float32
    b: Any  # [N, r] float32
    scale: float


@dataclasses.dataclass
class LoraAdapter:
    """name -> LoraPair, keyed by the full GGUF tensor name
    (blk.N.attn_q.weight)."""
    pairs: dict
    alpha: float
    rank: int


def load_lora(path: str, hp: HParams, permute: bool = True) -> LoraAdapter:
    """Read an adapter's pairs as float32 numpy. permute=True puts the
    attn_q/attn_k lora_b rows of a NORM-rope arch in the loader's
    half-split layout (what the forward needs); merge_lora passes False to
    stay in the file's rows."""
    with GGUFReader(path) as r:
        alpha = float(r.metadata.get("adapter.lora.alpha", 16.0))
        tensors = {name: r.dequantize(name, np.float32) for name in r.tensors}
    heads = {"attn_q.weight": hp.n_head_of, "attn_k.weight": hp.n_head_kv_of}

    def perm_of(base: str):
        """The loader's row map of base's layer, or None."""
        parts = base.split(".", 2)
        if not permute or hp.rope_type != "norm" or parts[-1] not in heads:
            return None
        if hp.n_lora_kv:
            return _mla_q_perm(hp)
        return _unpermute_rows(heads[parts[-1]](int(parts[1])), hp.head_dim,
                               hp.rope_dim)

    pairs: dict[str, LoraPair] = {}
    rank = 0
    for name, a in tensors.items():
        if not name.endswith(".lora_a"):
            continue
        base = name[: -len(".lora_a")]
        b = tensors.get(base + ".lora_b")
        if b is None:
            continue
        rank = a.shape[0]
        perm = perm_of(base)
        if perm is not None:
            b = b[perm]
        pairs[base] = LoraPair(a=a, b=b, scale=alpha / max(rank, 1))
    if not pairs:
        raise ValueError(f"{path}: no lora_a/lora_b tensor pairs found")
    return LoraAdapter(pairs=pairs, alpha=alpha, rank=rank)


def _device(weights: LlamaWeights):
    return weights.rope_inv_freq.device


def attach_lora(weights: LlamaWeights, adapter: LoraAdapter,
                user_scale: float = 1.0) -> LlamaWeights:
    """Set every layer's .lora from one adapter (on the weights' device,
    A and B rounded to bf16); layers it does not touch get none."""
    dev = _device(weights)
    for li, lw in enumerate(weights.layers):
        lora = {}
        for field, suffix in _TARGETS.items():
            pair = adapter.pairs.get(f"blk.{li}.{suffix}")
            if pair is not None:
                lora[field] = lora_to_torch(
                    (pair.a, pair.b, pair.scale * user_scale), dev)
        lw.lora = lora
    return weights


def attach_loras(weights: LlamaWeights,
                 scaled: list[tuple[LoraAdapter, float]]) -> LlamaWeights:
    """Attach several adapters at once (the server's /lora-adapters). Pairs
    that target the same tensor are stacked along the rank axis with the
    scales folded into B, so y = W x + sum_i s_i * B_i (A_i x) stays one
    low-rank update: A' = concat_r(A_i), B' = concat_r(s_i * scale_i * B_i),
    scale' = 1. An adapter at scale 0 is left out."""
    dev = _device(weights)
    for li, lw in enumerate(weights.layers):
        lora = {}
        for field, suffix in _TARGETS.items():
            parts = []
            for adapter, s in scaled:
                pair = adapter.pairs.get(f"blk.{li}.{suffix}")
                if s != 0.0 and pair is not None:
                    parts.append((pair.a, pair.b * (pair.scale * s)))
            if parts:
                lora[field] = lora_to_torch(
                    (np.concatenate([p[0] for p in parts], axis=0),
                     np.concatenate([p[1] for p in parts], axis=1), 1.0), dev)
        lw.lora = lora
    return weights


def merge_lora(src_model: str, lora_path: str, dst: str,
               user_scale: float = 1.0) -> int:
    """Bake a LoRA into a dense GGUF (F16 matrices, F32 vectors), in the
    file's own row order. Returns the number of merged tensors."""
    with GGUFReader(src_model) as r:
        hp = hparams_from_metadata(r.metadata)
        adapter = load_lora(lora_path, hp, permute=False)
        w = GGUFWriter(dst)
        for key, val in r.metadata.items():
            w.add_kv(key, val)
        merged = 0
        for name in r.tensors:
            dense = r.dequantize(name, np.float32)
            pair = adapter.pairs.get(name)
            if pair is not None and dense.ndim == 2:
                delta = (pair.b @ pair.a) * (pair.scale * user_scale)
                dense = dense + delta.reshape(dense.shape)
                merged += 1
            tgt = GGMLType.F16 if dense.ndim >= 2 else GGMLType.F32
            w.add_tensor(name, dense, ggml_type=tgt)
        w.write()
    return merged
