"""Model hyperparameters parsed from GGUF metadata.

Counterpart of llama_cpp_test_tpu/models/hparams.py, trimmed to the
sequential llama body of this port (models/registry.PORTED): dense, or
Mixtral-style MoE with softmax top-k routing, and the gemma and qwen
quirk axes (NEOX rope, GeGLU, embedding scale, sliding-window patterns
with their own rope base, softcaps). Fields that select paths the port
does not carry yet (sigmoid or sparsemixer gating, shared experts) are
parsed so the loader can refuse them instead of running a different
model.
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
    # renormalize the selected top-k routing weights: true for Mixtral;
    # the archs that do not (qwen2moe, olmoe, deepseek) are refused
    norm_topk: bool = True
    n_expert_shared: int = 0
    expert_weights_scale: float = 1.0  # routed output multiplier
    expert_gating: str = "softmax"     # softmax | sigmoid | sparsemixer
    sliding_window: int = 0
    # with sliding_window set, layer li is global when (li + 1) %
    # swa_pattern == 0 (gemma2: 2, gemma3: 6); 1 = every layer slides
    swa_pattern: int = 1
    # rope base of the sliding-window layers (gemma3: 10000 beside the
    # global 1e6); 0 = rope_freq_base
    rope_freq_base_swa: float = 0.0
    # attention scale override; 0 = 1/sqrt(head_dim) (gemma 27B: by
    # layer count, 1/sqrt(n_embd / n_head))
    attn_scale: float = 0.0
    attn_softcap: float = 0.0   # tanh cap on attention logits (gemma2: 50)
    final_softcap: float = 0.0  # tanh cap on output logits (gemma2: 30)
    # GGUF rope convention: "norm" rows are un-permuted at load so the
    # half-split rotation applies; "neox" rows are half-split already
    rope_type: str = "norm"
    act_fn: str = "silu"        # gated-FFN activation: silu | gelu (GeGLU)
    embd_scale: float = 1.0     # embedding multiplier (gemma: sqrt(n_embd))
    # embedding defaults (Context.embed): attention causality (false only
    # for the bert family, which the loader refuses) and the pooling of
    # GGUF {arch}.pooling_type (llama.h enum)
    causal: bool = True
    pooling: str = "last"


# the ported archs whose GGUF Q/K rows are NEOX (half-split); the others
# are NORM (reference hparams.py's neox set, trimmed to the port's archs)
_NEOX = ("gemma", "gemma2", "gemma3", "qwen2", "qwen3")


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
    n_layer = g("block_count", 32)
    gemma_like = arch in ("gemma", "gemma2", "gemma3")
    swa_pattern = {"gemma2": 2, "gemma3": g("attention.sliding_window_pattern",
                                            6)}.get(arch, 1)
    # the 27B gemmas scale attention by 1/sqrt(n_embd / n_head), found by
    # layer count as the reference finds them
    attn_scale = 0.0
    if (arch, n_layer) in (("gemma2", 46), ("gemma3", 62)):
        attn_scale = 1.0 / math.sqrt(n_embd / max(n_head, 1))
    return HParams(
        arch=arch,
        n_vocab=n_vocab,
        n_ctx_train=g("context_length", 2048),
        n_embd=n_embd,
        n_layer=n_layer,
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
        norm_topk=arch not in ("qwen2moe", "olmoe", "deepseek"),
        n_expert_shared=g("expert_shared_count", 0),
        expert_weights_scale=g("expert_weights_scale", 1.0),
        expert_gating=("sparsemixer" if arch == "phimoe"
                       else "sigmoid" if int(g("expert_gating_func", 1)) == 2
                       else "softmax"),
        sliding_window=g("attention.sliding_window", 0),
        swa_pattern=max(1, swa_pattern),
        rope_freq_base_swa=(g("rope.local_freq_base", 10000.0)
                            if arch == "gemma3" else 0.0),
        attn_scale=attn_scale,
        attn_softcap=g("attn_logit_softcapping",
                       50.0 if arch == "gemma2" else 0.0),
        final_softcap=g("final_logit_softcapping",
                        30.0 if arch == "gemma2" else 0.0),
        rope_type="neox" if arch in _NEOX else "norm",
        act_fn="gelu" if gemma_like else "silu",
        embd_scale=(math.sqrt(n_embd) if gemma_like
                    else g("embedding_scale", 1.0)),
        causal=arch not in ("bert", "nomic-bert", "jina-bert-v2"),
        # mean unless the file says otherwise, as the reference reads it
        pooling={0: "none", 1: "mean", 2: "cls", 3: "last"}.get(
            int(g("pooling_type", 1)), "mean"),
    )


def attn_scale_of(hp: HParams) -> float:
    """Attention logit scale: hp.attn_scale override or 1/sqrt(head_dim)."""
    return hp.attn_scale if hp.attn_scale > 0 else 1.0 / math.sqrt(hp.head_dim)


def layer_window(hp: HParams, li: int) -> int:
    """Per-layer sliding window: 0 = global attention for this layer."""
    if hp.sliding_window <= 0:
        return 0
    if hp.swa_pattern > 1 and (li + 1) % hp.swa_pattern == 0:
        return 0
    return hp.sliding_window
