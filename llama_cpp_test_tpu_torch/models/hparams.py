"""Model hyperparameters parsed from GGUF metadata.

Counterpart of llama_cpp_test_tpu/models/hparams.py, trimmed to the llama
decoder of this port: dense, or Mixtral-style MoE with softmax top-k
routing. Fields that select paths the port does not carry yet (sigmoid or
sparsemixer gating, shared experts, sliding window, softcaps) are parsed
so the loader can refuse them instead of running a different model.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HParams:
    arch: str = "llama"
    n_vocab: int = 32000
    n_ctx_train: int = 2048
    n_embd: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_head_kv: int = 32
    n_ff: int = 11008
    head_dim: int = 128  # attention.key_length (n_embd/n_head unless set)
    rms_eps: float = 1e-5
    rope_dim: int = 128
    rope_freq_base: float = 10000.0
    rope_scaling: str = "none"  # none | linear | yarn
    rope_scale_factor: float = 1.0
    rope_orig_ctx: int = 0
    rope_attn_factor: float = 1.0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    # MoE
    n_expert: int = 0
    n_expert_used: int = 0
    # renormalize the selected top-k routing weights: true for llama
    # (Mixtral), the one arch the loader accepts
    norm_topk: bool = True
    n_expert_shared: int = 0
    expert_weights_scale: float = 1.0  # routed output multiplier
    expert_gating: str = "softmax"     # softmax | sigmoid | sparsemixer
    sliding_window: int = 0
    attn_scale: float = 0.0     # 0 = default 1/sqrt(head_dim)
    attn_softcap: float = 0.0
    final_softcap: float = 0.0


def hparams_from_metadata(md: dict) -> HParams:
    arch = md.get("general.architecture", "llama")

    def g(suffix, default):
        v = md.get(f"{arch}.{suffix}", default)
        if isinstance(default, float):
            return float(v)
        if isinstance(default, int):
            return int(v)
        return v

    n_embd = g("embedding_length", 4096)
    n_head = g("attention.head_count", 32)
    head_dim = g("attention.key_length", n_embd // max(n_head, 1))
    n_vocab = g("vocab_size", 0)
    if not n_vocab:
        toks = md.get("tokenizer.ggml.tokens")
        n_vocab = len(toks) if toks is not None else 32000
    return HParams(
        arch=arch,
        n_vocab=n_vocab,
        n_ctx_train=g("context_length", 2048),
        n_embd=n_embd,
        n_layer=g("block_count", 32),
        n_head=n_head,
        n_head_kv=g("attention.head_count_kv", n_head),
        n_ff=g("feed_forward_length", 11008),
        head_dim=head_dim,
        rms_eps=g("attention.layer_norm_rms_epsilon", 1e-5),
        rope_dim=g("rope.dimension_count", head_dim),
        rope_freq_base=g("rope.freq_base", 10000.0),
        rope_scaling=str(md.get(f"{arch}.rope.scaling.type", "none") or "none"),
        rope_scale_factor=g("rope.scaling.factor", 1.0),
        rope_orig_ctx=g("rope.scaling.original_context_length", 0),
        rope_attn_factor=g("rope.scaling.attn_factor", 1.0),
        n_expert=g("expert_count", 0),
        n_expert_used=g("expert_used_count", 0),
        norm_topk=arch == "llama",
        n_expert_shared=g("expert_shared_count", 0),
        expert_weights_scale=g("expert_weights_scale", 1.0),
        expert_gating=("sparsemixer" if arch == "phimoe"
                       else "sigmoid" if int(g("expert_gating_func", 1)) == 2
                       else "softmax"),
        sliding_window=g("attention.sliding_window", 0),
        attn_softcap=g("attn_logit_softcapping", 0.0),
        final_softcap=g("final_logit_softcapping", 0.0),
    )


def attn_scale_of(hp: HParams) -> float:
    """Attention logit scale: hp.attn_scale override or 1/sqrt(head_dim)."""
    return hp.attn_scale if hp.attn_scale > 0 else 1.0 / math.sqrt(hp.head_dim)


def layer_window(hp: HParams, li: int) -> int:
    """Per-layer sliding window: 0 = global attention for this layer. The
    llama arch slides every layer or none (the reference's swa_pattern 1)."""
    return max(hp.sliding_window, 0)
