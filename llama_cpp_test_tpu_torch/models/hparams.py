"""Model hyperparameters parsed from GGUF metadata.

Counterpart of llama_cpp_test_tpu/models/hparams.py, trimmed to the
llama body of this port (models/registry.PORTED): dense, or MoE with
softmax, sigmoid (DeepSeek-V3) or sparsemixer (phimoe) routing, with or
without renormalized top-k weights, shared experts, deepseek's leading
dense layers and the selection bias; deepseek2's and minicpm3's MLA
attention (the q and kv LoRA ranks, the value head dim, the YaRN
magnitude folded into the attention scale); the gemma and qwen quirk axes (NEOX rope,
GeGLU, embedding scale, sliding-window patterns with their own rope base,
softcaps); and the LayerNorm and parallel-residual axes of the phi,
stablelm, starcoder2, gptneox, falcon, command-r, granite, olmo and
nemotron archs (norm type, parallel residual, non-gated GELU and squared
ReLU FFNs, the mup scales, QKV clamping, long-rope scaling); the position
axes (pos_embd: rope, learned absolute positions for gpt2 and starcoder,
or none with an ALiBi bias for bloom, mpt, jais, refact and the 13B-class
baichuan, whose slopes follow alibi_max_bias and alibi_style; cohere2's
global layers without rope, nope_global); and the small switches of the
other llama-body archs (jais's 1/d_head attention scale, cohere2's
inverted logit scale and 3:1 sliding windows, mpt's exact erf GELU); the
bert-family encoders (post-norm layers, non-causal attention, jina's
symmetric ALiBi); per-layer geometry (openelm's and deci's per-layer head
counts and FFN widths, GGUF arrays under the scalar keys); chameleon's
swin norms; and qwen2vl's M-RoPE sections.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


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
    rope_scaling: str = "none"  # none | linear | yarn | longrope (phi3:
    #                             the factor tables ride the weights)
    rope_scale_factor: float = 1.0
    rope_orig_ctx: int = 0
    rope_attn_factor: float = 1.0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    # MoE
    n_expert: int = 0
    n_expert_used: int = 0
    n_ff_exp: int = 0
    # renormalize the selected top-k routing weights: true for Mixtral,
    # false for qwen2moe, olmoe and deepseek, deepseek2's by its
    # expert_weights_norm key
    norm_topk: bool = True
    n_layer_dense_lead: int = 0        # deepseek: leading dense layers
    n_expert_shared: int = 0
    expert_weights_scale: float = 1.0  # routed output multiplier
    expert_gating: str = "softmax"     # softmax | sigmoid | sparsemixer
    router_jitter: float = 0.01        # phimoe's sparsemixer threshold
    # MLA attention (deepseek2, minicpm3): the q and kv LoRA ranks (0 =
    # a plain attn_q / standard attention), the value head dim where it
    # differs from head_dim (0 = head_dim), and deepseek2's YaRN
    # magnitude multiplier, folded into attn_scale (not the rope tables)
    n_lora_q: int = 0
    n_lora_kv: int = 0
    head_dim_v: int = 0
    rope_yarn_log_mul: float = 0.0
    sliding_window: int = 0
    # with sliding_window set, layer li is global when (li + 1) %
    # swa_pattern == 0 (gemma2: 2, gemma3: 6); 1 = every layer slides
    swa_pattern: int = 1
    # rope base of the sliding-window layers (gemma3: 10000 beside the
    # global 1e6); 0 = rope_freq_base
    rope_freq_base_swa: float = 0.0
    # attention scale override; 0 = 1/sqrt(head_dim) (gemma 27B: by
    # layer count, 1/sqrt(n_embd / n_head); granite: attention.scale)
    attn_scale: float = 0.0
    # olmo clip_qkv: q, k and v clamped to +-clamp_kqv; 0 = off
    clamp_kqv: float = 0.0
    attn_softcap: float = 0.0   # tanh cap on attention logits (gemma2: 50)
    final_softcap: float = 0.0  # tanh cap on output logits (gemma2: 30)
    # GGUF rope convention: "norm" rows are un-permuted at load so the
    # half-split rotation applies; "neox" rows are half-split already
    rope_type: str = "norm"
    # FFN activation: silu | gelu (tanh approximation; GeGLU when gated)
    # | gelu_erf (the exact GELU: mpt, bert, jina's GeGLU) | relu2 (nemotron's squared ReLU,
    # non-gated)
    act_fn: str = "silu"
    embd_scale: float = 1.0     # embedding multiplier (gemma: sqrt(n_embd))
    # granite's mup multipliers: each branch output times residual_scale,
    # the logits DIVIDED by logits_scale (command-r stores a multiplier,
    # read here as its inverse)
    residual_scale: float = 1.0
    logits_scale: float = 1.0
    # x + attn(norm(x)) + ffn(norm'(x)) (phi2, falcon, gptneox,
    # command-r; stablelm by its use_parallel_residual key)
    parallel_residual: bool = False
    norm_type: str = "rms"      # rms | ln (LayerNorm, weight and bias
    #                             each optional; olmo has neither)
    # embedding defaults (Context.embed): attention causality (false only
    # for the bert-family encoders) and the pooling of
    # GGUF {arch}.pooling_type (llama.h enum)
    causal: bool = True
    pooling: str = "last"
    # positions: "rope"; "learned" absolute rows added to the embedding
    # (gpt2, starcoder); "none" (the ALiBi archs)
    pos_embd: str = "rope"
    # ALiBi: slope_h * kv_index added to the attention logits, the slopes
    # by alibi_style ("bloom": the power-of-two heads, then the rest at
    # half the step; "mpt": from the next power of two, odd ones first)
    alibi: bool = False
    alibi_max_bias: float = 8.0
    alibi_style: str = "bloom"
    # cohere2: the global (window 0) layers take no rope
    nope_global: bool = False
    # the bert-family encoders: LayerNorm over the residual sums (x =
    # LN(x + attn(x)); x = LN(x + ffn(x))), no final norm, no LM head
    post_norm: bool = False
    # jina-bert-v2: the symmetric form of ALiBi, -slope_h * |i - j|
    alibi_sym: bool = False
    # chameleon-34B: no pre-norms; the attention and FFN norms apply to
    # the branch outputs (the sandwich post-norm slots)
    swin_norm: bool = False
    # per-layer geometry (openelm, deci): head_count, head_count_kv and
    # feed_forward_length as GGUF arrays, one entry a layer; () = uniform
    # (the scalar fields, then the arrays' maxima, apply to every layer).
    # deci writes an attention-free layer as n_head 0 and a linear-attention
    # layer as n_head > 0 with n_head_kv 0
    n_head_layers: tuple = ()
    n_head_kv_layers: tuple = ()
    n_ff_layers: tuple = ()
    # qwen2vl M-RoPE frequency sections (t, h, w) over the rope half-dims:
    # image tokens rope each frequency with its section's position stream;
    # equal streams (text) reduce to NEOX rope ({arch}.rope.dimension_sections)
    mrope_sections: tuple = ()

    @property
    def v_dim(self) -> int:
        """Value head dim (head_dim except on the MLA archs)."""
        return self.head_dim_v or self.head_dim

    @property
    def uniform_layers(self) -> bool:
        """True when every layer has the scalar head counts and FFN width."""
        return not (self.n_head_layers or self.n_head_kv_layers
                    or self.n_ff_layers)

    def n_head_of(self, li: int) -> int:
        return self.n_head_layers[li] if self.n_head_layers else self.n_head

    def n_head_kv_of(self, li: int) -> int:
        return (self.n_head_kv_layers[li] if self.n_head_kv_layers
                else self.n_head_kv)

    def n_ff_of(self, li: int) -> int:
        return self.n_ff_layers[li] if self.n_ff_layers else self.n_ff


# the ported archs whose GGUF Q/K rows are NEOX (half-split); the others
# are NORM (reference hparams.py's neox set, trimmed to the port's archs).
# orion is NEOX as in the reference, which follows the model and the GGUF
# rows (its converter leaves them unpermuted) rather than llama.cpp's
# runtime (reference hparams.py, the note beside its neox set)
_NEOX = ("gemma", "gemma2", "gemma3", "qwen2", "qwen2vl", "qwen3", "falcon",
         "stablelm", "olmo2", "phi2", "phi3", "starcoder2", "gptneox",
         "nemotron", "orion", "qwen", "exaone", "codeshell", "bitnet",
         "bert", "nomic-bert", "openelm", "grok", "dbrx", "qwen2moe",
         "qwen3moe", "olmoe", "phimoe", "minicpm3")
# the ported LayerNorm archs (reference hparams.py's norm_type "ln" set)
_LN = ("phi2", "falcon", "gptneox", "stablelm", "command-r", "starcoder2",
       "nemotron", "olmo", "orion", "codeshell", "cohere2", "gpt2",
       "starcoder", "bloom", "mpt", "jais", "bert", "nomic-bert",
       "jina-bert-v2", "dbrx", "phimoe")
_ENCODERS = ("bert", "nomic-bert", "jina-bert-v2")
_PARALLEL = ("phi2", "falcon", "gptneox", "command-r", "cohere2", "plamo")
_GELU = ("gemma", "gemma2", "gemma3", "phi2", "falcon", "gptneox",
         "starcoder2", "gpt2", "starcoder", "codeshell", "bloom", "grok")
_LEARNED = ("gpt2", "starcoder", "bert")
_ALIBI = ("bloom", "mpt", "jais", "refact", "jina-bert-v2")
# the exact erf GELU (mpt; bert's FFN and jina's GeGLU, as their models
# define them)
_GELU_ERF = ("mpt", "bert", "jina-bert-v2")


def hparams_from_metadata(md: dict) -> HParams:
    arch = md.get("general.architecture", "llama")

    def g(suffix, default):
        v = md.get(f"{arch}.{suffix}", default)
        if isinstance(default, float):
            return float(v)
        if isinstance(default, bool):
            return bool(v)
        if isinstance(default, int):
            return int(v)
        return v

    n_embd = g("embedding_length", 4096)

    def arr(suffix) -> tuple:
        """A key's per-layer int array, or () where it is a scalar or
        absent (llama.cpp's get_key_or_arr)."""
        v = md.get(f"{arch}.{suffix}")
        if v is None or isinstance(v, (int, float, np.integer, np.floating)):
            return ()
        a = np.asarray(v)
        return tuple(int(x) for x in a.reshape(-1)) if a.ndim else ()

    n_head_layers = arr("attention.head_count")
    n_head_kv_layers = arr("attention.head_count_kv")
    n_ff_layers = arr("feed_forward_length")
    n_head = (max(n_head_layers) if n_head_layers
              else g("attention.head_count", 32))
    head_dim = g("attention.key_length", n_embd // max(n_head, 1))
    n_vocab = g("vocab_size", 0)
    if not n_vocab:
        toks = md.get("tokenizer.ggml.tokens")
        n_vocab = len(toks) if toks is not None else 32000
    n_layer = g("block_count", 32)
    gemma_like = arch in ("gemma", "gemma2", "gemma3")
    swa_pattern = {"gemma2": 2, "gemma3": g("attention.sliding_window_pattern",
                                            6), "cohere2": 4}.get(arch, 1)
    # the 27B gemmas scale attention by 1/sqrt(n_embd / n_head), found by
    # layer count as the reference finds them
    attn_scale = 0.0
    if (arch, n_layer) in (("gemma2", 46), ("gemma3", 62)):
        attn_scale = 1.0 / math.sqrt(n_embd / max(n_head, 1))
    if arch in ("granite", "granitemoe"):
        attn_scale = g("attention.scale", attn_scale)
    if arch == "jais":     # mup attention: 1/d_head, not 1/sqrt(d_head)
        attn_scale = 1.0 / head_dim
    # the 13B-class baichuan is ALiBi: by layer count, as llama.cpp finds
    # it, or by an explicit max_alibi_bias key (a file cut in depth)
    alibi = arch in _ALIBI or (arch == "baichuan" and (
        n_layer >= 40 or g("attention.max_alibi_bias", 0.0) > 0))
    # deepseek2: the YaRN magnitude m = attn_factor * (1 + log_mul *
    # ln(factor)) scales the attention as m^2 / sqrt(head_dim), and its
    # rope runs at magnitude 1 (layers.rope_freqs)
    scaling = str(md.get(f"{arch}.rope.scaling.type", "none") or "none")
    yarn_log_mul = g("rope.scaling.yarn_log_multiplier", 0.0)
    if arch == "deepseek2":
        factor, m = g("rope.scaling.factor", 1.0), 1.0
        if scaling == "yarn" and factor > 1.0:
            m = g("rope.scaling.attn_factor", 1.0) * (
                1.0 + yarn_log_mul * math.log(factor))
        attn_scale = m * m / math.sqrt(head_dim)
    return HParams(
        arch=arch,
        n_vocab=n_vocab,
        n_ctx_train=g("context_length", 2048),
        n_embd=n_embd,
        n_layer=n_layer,
        n_head=n_head,
        n_head_kv=(max(n_head_kv_layers) if n_head_kv_layers
                   else g("attention.head_count_kv", n_head)),
        n_ff=(max(n_ff_layers) if n_ff_layers
              else g("feed_forward_length", 11008)),
        n_head_layers=n_head_layers,
        n_head_kv_layers=n_head_kv_layers,
        n_ff_layers=n_ff_layers,
        head_dim=head_dim,
        # a LayerNorm arch stores a plain layer_norm_epsilon
        rms_eps=g("attention.layer_norm_rms_epsilon",
                  g("attention.layer_norm_epsilon", 1e-5)),
        rope_dim=g("rope.dimension_count", head_dim),
        rope_freq_base=g("rope.freq_base", 10000.0),
        rope_scaling=scaling,
        rope_scale_factor=g("rope.scaling.factor", 1.0),
        rope_orig_ctx=g("rope.scaling.original_context_length", 0),
        rope_attn_factor=g("rope.scaling.attn_factor", 1.0),
        n_expert=g("expert_count", 0),
        n_expert_used=g("expert_used_count", 0),
        n_ff_exp=g("expert_feed_forward_length", 0),
        norm_topk=(bool(g("expert_weights_norm", False))
                   if arch == "deepseek2"
                   else arch not in ("qwen2moe", "olmoe", "deepseek")),
        n_layer_dense_lead=g("leading_dense_block_count", 0),
        n_expert_shared=g("expert_shared_count", 0),
        expert_weights_scale=g("expert_weights_scale", 1.0),
        expert_gating=("sparsemixer" if arch == "phimoe"
                       else "sigmoid" if int(g("expert_gating_func", 1)) == 2
                       else "softmax"),
        router_jitter=g("router_jitter", 0.01),
        n_lora_q=g("attention.q_lora_rank", 0),
        n_lora_kv=g("attention.kv_lora_rank", 0),
        # minicpm3 files omit value_length: its v head is n_embd / n_head
        head_dim_v=g("attention.value_length",
                     n_embd // max(n_head, 1) if arch == "minicpm3" else 0),
        rope_yarn_log_mul=yarn_log_mul,
        sliding_window=g("attention.sliding_window", 0),
        swa_pattern=max(1, swa_pattern),
        rope_freq_base_swa=(g("rope.local_freq_base", 10000.0)
                            if arch == "gemma3" else 0.0),
        attn_scale=attn_scale,
        clamp_kqv=g("attention.clamp_kqv", 0.0),
        # grok-1: 30 * tanh(logits / 30), as the model computes it
        attn_softcap=g("attn_logit_softcapping",
                       50.0 if arch == "gemma2" else
                       30.0 if arch == "grok" else 0.0),
        final_softcap=g("final_logit_softcapping",
                        30.0 if arch == "gemma2" else 0.0),
        rope_type="neox" if arch in _NEOX else "norm",
        act_fn=("relu2" if arch == "nemotron" else
                "gelu_erf" if arch in _GELU_ERF else
                "gelu" if arch in _GELU else "silu"),
        embd_scale=(math.sqrt(n_embd) if gemma_like
                    else g("embedding_scale", 1.0)),
        residual_scale=g("residual_scale", 1.0),
        logits_scale=(1.0 / g("logit_scale", 1.0)
                      if arch in ("command-r", "cohere2")
                      else g("logit_scale", 1.0)),
        # stablelm files carry the flag; elsewhere it is the arch's
        parallel_residual=g("use_parallel_residual", arch in _PARALLEL),
        norm_type="ln" if arch in _LN else "rms",
        post_norm=arch in _ENCODERS,
        causal=arch not in _ENCODERS,
        # mean unless the file says otherwise, as the reference reads it
        pooling={0: "none", 1: "mean", 2: "cls", 3: "last"}.get(
            int(g("pooling_type", 1)), "mean"),
        pos_embd=("learned" if arch in _LEARNED else
                  "none" if alibi else "rope"),
        alibi=alibi,
        alibi_sym=arch == "jina-bert-v2",
        alibi_max_bias=g("attention.max_alibi_bias", 8.0),
        alibi_style="mpt" if arch == "mpt" else "bloom",
        nope_global=arch == "cohere2",
        swin_norm=bool(g("swin_norm", False)),
        # the first three entries (converters write a fourth, 0)
        mrope_sections=tuple(
            int(x) for x in np.asarray(
                md.get(f"{arch}.rope.dimension_sections", []))[:3]),
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
