"""LLaMA-family model (dense or MoE, the gemma and qwen quirk axes, the
LayerNorm and parallel-residual archs, the position axes: learned
positions and ALiBi, the bert-family encoders, per-layer geometry and
MLA attention): GGUF weight loading + forward pass.

Counterpart of the llama body of llama_cpp_test_tpu/models/llama.py for
the archs of models/registry.PORTED. A sequential layer: pre-norm (RMS or
LayerNorm with bias; olmo's LN has no weights, olmo2 and chameleon-34B
have no pre-norms) -> fused QKV (+ Q/K/V biases; clamped for olmo) -> QK
norms (per-head RMS [head_dim], per-head LayerNorms [H, head_dim] with
optional biases, or olmo2's RMS over the flat q and k) -> RoPE (the
layer's table, partial when rope_dim < head_dim; none on a file without
rope positions or on cohere2's global layers; qwen2vl's image tokens by
their M-RoPE streams) -> paged attention (window,
softcap, ALiBi bias) -> bitnet's RMS sub-norm -> wo (+ bias) -> post norm
-> residual scale -> residual; then the FFN half: norm -> fused gate|up
(+ gate and up biases) -> SwiGLU or GeGLU -> bitnet's RMS sub-norm, or a
non-gated up (+ bias) -> GELU (tanh or erf) or squared ReLU, or, in a MoE
layer, routing over the experts (moe_ffn: softmax or sigmoid top-k,
DeepSeek-V3's selection bias, phimoe's sparsemixer) -> down (+ bias) ->
the shared experts -> residual scale -> post norm -> residual. An MLA
layer (deepseek2, minicpm3) projects q, the compressed kv and its shared
rope key instead of q, k and v (mla_qkv); arctic's layer adds a dense
MLP beside the experts. The head counts and the FFN
width are the layer's own (openelm, deci); deci's attention-free layer
is its FFN half alone, and its linear-attention layer replaces attention
by wo on the normed input. A parallel layer (phi2, falcon, gptneox,
command-r, cohere2, plamo) feeds attention and the FFN from the layer
input's norms and adds both to it. A post-norm layer (bert, nomic-bert,
jina-bert-v2) attends from the layer input and LayerNorms each residual
sum. The embedding takes the token-type row (the encoders), the learned
position rows (gpt2, starcoder, bert) and the embedding LayerNorm
(embed_extras). Final norm (none on an encoder) + lm head (+ bias) /
logits scale + final softcap; an encoder has no LM head. Loading is numpy
(host planes); weights.py moves them to a device.

Every dense projection goes through ops/qmatmul (kernel K1 on CUDA), every
expert projection through ops/gmm (kernel K4). `plain=True` selects the
plain PyTorch version of every kernel instead; it exists so a run on the
card can be held against the plain path.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from ..gguf.reader import GGUFReader
from ..ops import gmm as gmm_mod
from ..ops import layers
from ..ops.qmatmul import qgather, qmm, qmm_plain, qmm_split, qmm_split_plain
from ..quant.repack import QTensor, fuse_qtensors, repack
from .hparams import HParams, hparams_from_metadata
from .registry import check_arch


@dataclasses.dataclass
class LayerWeights:
    # None: olmo (weightless LN), olmo2 and chameleon-34B (no pre-norm),
    # the encoders (post-norm), deci's attention-free layers
    attn_norm: Any
    wo: QTensor | None       # None: deci's attention-free layers
    ffn_norm: Any            # None: olmo, olmo2, parallel layers with one norm
    w_down: QTensor | None = None
    # fused q|k|v and gate|up planes, built at load when the source tensors
    # share a quant type; the separate planes otherwise
    wqkv: QTensor | None = None
    wq: QTensor | None = None
    wk: QTensor | None = None
    wv: QTensor | None = None
    w_gateup: QTensor | None = None
    w_gate: QTensor | None = None
    w_up: QTensor | None = None
    # MoE: router [n_expert, n_embd] and expert stacks whose planes carry
    # a leading E axis; gate and up stay separate, as the reference keeps
    # them by default
    gate_inp: QTensor | None = None
    gate_exps: QTensor | None = None
    up_exps: QTensor | None = None
    down_exps: QTensor | None = None
    # the shared experts (qwen2moe, deepseek, deepseek2), gated by
    # sigmoid(x . gate_inp_shexp) where that [n_embd] vector exists;
    # DeepSeek-V3's expert-selection bias [n_expert]; arctic's norm of the
    # MoE branch, whose layer carries a dense MLP beside the experts
    gate_shexp: QTensor | None = None
    up_shexp: QTensor | None = None
    down_shexp: QTensor | None = None
    gate_inp_shexp: Any = None
    exp_probs_b: Any = None
    ffn_norm_exps: Any = None
    # MLA attention (deepseek2, minicpm3): the low-rank q (wq_a -> RMS ->
    # wq_b; a plain wq otherwise), the compressed kv with the shared rope
    # key (wkv_a [kv_lora_rank + rope_dim]) and its RMS norm, and the
    # up-projection wkv_b [H * (nope + v_dim)]
    wq_a: QTensor | None = None
    wq_b: QTensor | None = None
    attn_q_a_norm: Any = None
    wkv_a: QTensor | None = None
    attn_kv_a_norm: Any = None
    wkv_b: QTensor | None = None
    # Q/K/V biases (qwen2, phi2, stablelm, starcoder2, gptneox) and the QK
    # norms, float32: RMS weights [head_dim] shared by the heads (qwen3,
    # gemma3), per-head LayerNorm weights [H, head_dim] (stablelm-2-12B,
    # Command R+), or RMS weights over the flat q and k [H * head_dim]
    # (olmo2)
    bq: Any = None
    bk: Any = None
    bv: Any = None
    attn_q_norm: Any = None
    attn_k_norm: Any = None
    # the biases of per-head QK LayerNorms [H, head_dim] (chameleon)
    attn_q_norm_b: Any = None
    attn_k_norm_b: Any = None
    # LayerNorm biases; falcon-40B's second norm feeding the FFN branch;
    # the output-projection and non-gated FFN biases, float32
    attn_norm_b: Any = None
    ffn_norm_b: Any = None
    attn_norm_2: Any = None
    attn_norm_2_b: Any = None
    bo: Any = None
    b_gate: Any = None       # jais's biased SwiGLU
    b_up: Any = None
    b_down: Any = None
    # bitnet: RMS norms of the attention output before wo and of the
    # SwiGLU product before ffn_down
    attn_sub_norm: Any = None
    ffn_sub_norm: Any = None
    # sandwich norms on the attention and FFN branch outputs before the
    # residual adds (gemma2, gemma3)
    attn_post_norm: Any = None
    ffn_post_norm: Any = None
    # the encoders' LayerNorms of the residual sums, after attention and
    # after the FFN (weight and bias)
    attn_out_norm: Any = None
    attn_out_norm_b: Any = None
    layer_out_norm: Any = None
    layer_out_norm_b: Any = None
    # LoRA pairs: field name (wq, wk, wv, wo, w_gate, w_up, w_down) ->
    # (A [r, K], B [N, r], scale), A and B float32 holding bf16 values
    # (models/lora.py)
    lora: dict = dataclasses.field(default_factory=dict)
    # control vector: [n_embd] float32 added to the layer output
    # (models/cvec.py)
    cvec: Any = None


@dataclasses.dataclass
class LlamaWeights:
    tok_embd: QTensor        # layout 'rows' (row gathers)
    output_norm: Any
    # lm head (token_embd planes when tied); None on an encoder
    output: QTensor | None
    layers: list[LayerWeights]
    rope_inv_freq: Any
    rope_mscale: float
    # the sliding-window layers' table where their base differs (gemma3:
    # 10000 beside the global 1e6), else None
    rope_inv_freq_swa: Any = None
    # phi3's long-rope table (base frequencies / rope_factors_long);
    # rope_inv_freq then holds the short one, and a Context over more than
    # rope_orig_ctx tokens serves the long one
    rope_inv_freq_long: Any = None
    # LayerNorm bias of the final norm and the lm head's bias (phi2)
    output_norm_b: Any = None
    output_b: Any = None
    # the learned absolute position rows [n_ctx_train, C] (gpt2,
    # starcoder, bert), the token-type rows [n_types, C] (the encoders)
    # and the embedding LayerNorm (bloom, the encoders), float32
    pos_embd: Any = None
    type_embd: Any = None
    tok_norm: Any = None
    tok_norm_b: Any = None
    # cohere2: the global (window 0) layers take no rope
    nope_global: bool = False

    def inv_freq_for(self, window: int):
        """The rope table of a layer with sliding window `window` (0 =
        global); None where the layer takes no rope (cohere2's global
        layers)."""
        if window == 0 and self.nope_global:
            return None
        if window > 0 and self.rope_inv_freq_swa is not None:
            return self.rope_inv_freq_swa
        return self.rope_inv_freq


# ---------------------------------------------------------------------------
# loading

_DENSE_FFN = {"ffn_gate.weight", "ffn_up.weight", "ffn_down.weight"}
# a non-gated FFN, or phi3's [gate|up] rows in one ffn_up (2 * n_ff wide)
_UP_DOWN_FFN = {"ffn_up.weight", "ffn_down.weight"}
_MOE_FFN = {"ffn_gate_inp.weight", "ffn_gate_exps.weight",
            "ffn_up_exps.weight", "ffn_down_exps.weight"}
# a MoE layer's shared experts (with qwen2moe's gate vector, optional),
# DeepSeek-V3's selection bias and arctic's MoE-branch norm
_SHEXP = {"ffn_gate_shexp.weight", "ffn_up_shexp.weight",
          "ffn_down_shexp.weight"}
_MOE_EXTRAS = _SHEXP | {"ffn_gate_inp_shexp.weight", "exp_probs_b.bias",
                        "ffn_norm_exps.weight"}
_QKV = {"attn_q.weight", "attn_k.weight", "attn_v.weight"}
# MLA: the compressed kv set beside a plain attn_q or the low-rank q set
_MLA_KV = {"attn_kv_a_mqa.weight", "attn_kv_a_norm.weight",
           "attn_kv_b.weight"}
_MLA_Q = {"attn_q_a.weight", "attn_q_a_norm.weight", "attn_q_b.weight"}
_MLA_SETS = ({"attn_q.weight"} | _MLA_KV, _MLA_Q | _MLA_KV)
_BIASES = {"attn_q.bias": "bq", "attn_k.bias": "bk", "attn_v.bias": "bv"}
# the QK norms, the sandwich norms under both GGUF names, the LayerNorm
# biases, falcon-40B's second norm, the other projection biases and
# bitnet's sub-norms
_QUIRK_VECTORS = {"attn_q_norm.weight": "attn_q_norm",
                  "attn_k_norm.weight": "attn_k_norm",
                  "attn_q_norm.bias": "attn_q_norm_b",
                  "attn_k_norm.bias": "attn_k_norm_b",
                  "attn_post_norm.weight": "attn_post_norm",
                  "post_attention_norm.weight": "attn_post_norm",
                  "ffn_post_norm.weight": "ffn_post_norm",
                  "post_ffw_norm.weight": "ffn_post_norm",
                  "attn_norm.bias": "attn_norm_b",
                  "ffn_norm.bias": "ffn_norm_b",
                  "attn_norm_2.weight": "attn_norm_2",
                  "attn_norm_2.bias": "attn_norm_2_b",
                  "attn_output.bias": "bo",
                  "ffn_gate.bias": "b_gate",
                  "ffn_up.bias": "b_up",
                  "ffn_down.bias": "b_down",
                  "attn_sub_norm.weight": "attn_sub_norm",
                  "ffn_sub_norm.weight": "ffn_sub_norm",
                  "attn_output_norm.weight": "attn_out_norm",
                  "attn_output_norm.bias": "attn_out_norm_b",
                  "layer_output_norm.weight": "layer_out_norm",
                  "layer_output_norm.bias": "layer_out_norm_b"}
_LAYER_TENSORS = {"attn_norm.weight", "attn_qkv.weight", "attn_qkv.bias",
                  "attn_output.weight", "ffn_norm.weight"} | _QKV | \
    _DENSE_FFN | _MOE_FFN | _MOE_EXTRAS | _MLA_KV | _MLA_Q | \
    set(_BIASES) | set(_QUIRK_VECTORS)
_TOP_TENSORS = {"token_embd.weight", "output_norm.weight", "output.weight",
                "output_norm.bias", "output.bias",
                "rope_factors_short.weight", "rope_factors_long.weight"}
# the embedding extras the forward adds (embed_extras), by the file's
# position mode, or "post_norm" on an encoder: the learned position rows
# only where the positions are learned, the token-type rows on an
# encoder, the embedding LayerNorm on an encoder or a file without rope
# positions (bloom)
_EMBED_EXTRAS = {"position_embd.weight": ("learned",),
                 "token_types.weight": ("post_norm",),
                 "token_embd_norm.weight": ("learned", "none", "post_norm"),
                 "token_embd_norm.bias": ("learned", "none", "post_norm")}
# the layer tensors a sequential gated FFN alone applies
_SEQUENTIAL_GATED = ("ffn_gate.bias", "attn_sub_norm.weight",
                     "ffn_sub_norm.weight")
# the LayerNorms of an encoder's residual sums, and what an encoder's
# post-norm layer does not apply (pre-norms, QK norms, branch norms)
_POST_NORMS = {"attn_output_norm.weight", "attn_output_norm.bias",
               "layer_output_norm.weight", "layer_output_norm.bias"}
# the same names in a pre-norm layer: grok's norms of the attention and
# MoE branch outputs (the sandwich post-norm slots), dbrx's pre-MoE norm
# (the ffn_norm slot)
_BRANCH_NORMS = {"grok": {"attn_output_norm.weight",
                          "layer_output_norm.weight"},
                 "dbrx": {"attn_output_norm.weight"}}
_PRE_NORM_ONLY = ({"attn_norm.weight", "ffn_norm.weight"}
                  | set(_QUIRK_VECTORS)) - _POST_NORMS - set(_BIASES) - {
    "attn_output.bias", "ffn_up.bias", "ffn_down.bias", "ffn_gate.bias"}
# the archs whose files may lack norm tensors: olmo's LayerNorms have no
# weights, olmo2 norms only the branch outputs (reference load_weights)
_NORMLESS = ("olmo", "olmo2")


def attention_free(hp: HParams, li: int) -> bool:
    """deci's attention-free layer (n_head 0): the block is its FFN."""
    return hp.n_head_of(li) == 0


def linear_attention(hp: HParams, li: int) -> bool:
    """deci's linear-attention layer (n_head > 0, n_head_kv 0 in a file of
    per-layer geometry): wo on the normed input replaces attention."""
    return (not hp.uniform_layers and hp.n_head_of(li) > 0
            and hp.n_head_kv_of(li) == 0)


def attends(hp: HParams, li: int) -> bool:
    """Whether layer li attends (and writes its KV pool)."""
    return not (attention_free(hp, li) or linear_attention(hp, li))


def _repack_2d(reader: GGUFReader, name: str,
               row_perm: np.ndarray | None = None,
               layout: str = "t", tile_n: int = 256) -> QTensor:
    info = reader.tensors[name]
    # ggml ne = (K, N): ne[0] is the contraction dim (row length)
    k, n = info.shape[0], info.shape[1] if len(info.shape) > 1 else 1
    raw = reader.tensor_bytes(name)
    if row_perm is not None:
        # block quantization is per-row, so permuting output rows is a pure
        # byte-row shuffle of the packed data
        row_bytes = raw.size // n
        raw = np.ascontiguousarray(raw.reshape(n, row_bytes)[row_perm])
    return repack(raw, info.ggml_type, n, k, layout=layout, tile_n=tile_n)


def _repack_3d(reader: GGUFReader, name: str) -> QTensor:
    """Expert-stacked tensor, ggml ne = (K, N, E) -> one QTensor whose
    planes are stacked on a leading E axis. The experts repack in parallel
    (numpy releases the GIL): a Mixtral layer holds 24 of them."""
    info = reader.tensors[name]
    k, n, e = info.shape
    raw = reader.tensor_bytes(name)
    per = raw.size // e
    with ThreadPoolExecutor(max_workers=min(e, os.cpu_count() or 1)) as ex:
        qts = list(ex.map(lambda i: repack(raw[i * per:(i + 1) * per],
                                           info.ggml_type, n, k), range(e)))
    q0 = qts[0]
    stack = lambda xs: None if xs[0] is None else np.stack(xs)
    return QTensor(q0.kind, q0.shape, q0.n_orig, q0.group,
                   stack([q.qs for q in qts]), stack([q.scale for q in qts]),
                   stack([q.min_ for q in qts]), q0.lut, q0.ggml_type)


def _unpermute_rows(n_head: int, head_dim: int,
                    rope_dim: int | None = None) -> np.ndarray:
    """GGUF NORM-layout Q/K rows -> half-split layout, so half-split rope
    applies: out_row[h*d + j] = in_row[h*d + 2j],
    out_row[h*d + d/2 + j] = in_row[h*d + 2j + 1]."""
    d = head_dim
    rd = rope_dim if rope_dim else d
    idx = np.empty(n_head * d, np.int64)
    for h in range(n_head):
        base = h * d
        idx[base:base + rd // 2] = base + 2 * np.arange(rd // 2)
        idx[base + rd // 2:base + rd] = base + 2 * np.arange(rd // 2) + 1
        idx[base + rd:base + d] = base + np.arange(rd, d)
    return idx


def _mla_q_perm(hp: HParams) -> np.ndarray:
    """An MLA q projection's rows: each head's nope rows as they are, its
    trailing rope_dim pe rows from the NORM layout to half-split (the
    permutation common to q_pe and k_pe cancels in their product)."""
    dk, rd = hp.head_dim, hp.rope_dim
    idx = np.arange(hp.n_head * dk, dtype=np.int64)
    sub = _unpermute_rows(1, rd)
    for h in range(hp.n_head):
        base = h * dk + dk - rd
        idx[base:base + rd] = base + sub
    return idx


def _mla_kva_perm(hp: HParams) -> np.ndarray:
    """attn_kv_a_mqa's rows: the kv_lora_rank compressed rows as they are,
    the shared pe tail from the NORM layout to half-split."""
    idx = np.arange(hp.n_lora_kv + hp.rope_dim, dtype=np.int64)
    idx[hp.n_lora_kv:] = hp.n_lora_kv + _unpermute_rows(1, hp.rope_dim)
    return idx


def _f32(reader: GGUFReader, name: str) -> np.ndarray:
    return reader.dequantize(name, np.float32)


def _check_qk_norm(name: str, shape: tuple, hp: HParams, li: int) -> None:
    """A QK norm the forward carries: [head_dim] RMS weights on a NEOX
    arch, per-head LayerNorm weights [H, head_dim] (ggml (head_dim, H)) on
    any, or RMS weights over the flat q or k [H * head_dim] on a NEOX arch
    (olmo2), H the layer's own head count. The reference permutes only the
    2-D weights of a NORM-rope file as it un-permutes the rows they
    scale."""
    heads = hp.n_head_of(li) if "attn_q_norm" in name else hp.n_head_kv_of(li)
    d = hp.head_dim
    if shape not in ((d,), (heads * d,), (d, heads)):
        raise NotImplementedError(
            f"{name} of shape {shape}: this port carries per-head QK norms "
            f"of shape ({d},) or ({d}, {heads}) and flat ones of shape "
            f"({heads * d},)")
    if len(shape) == 1 and hp.rope_type == "norm":
        raise NotImplementedError(
            f"{name} in a NORM-rope file: this port carries 1-D QK norms "
            "on NEOX-rope archs")
    if len(shape) == 1 and hp.parallel_residual:
        # the reference's parallel layer takes any QK norm for a LayerNorm
        raise NotImplementedError(
            f"{name} of shape {shape} in a parallel-residual file: this "
            "port carries per-head LayerNorm weights there")


def _ffn_sets(hp: HParams, i: int, names: set) -> list:
    """The FFN tensor sets layer i may carry: the gated set or a non-gated
    up and down in a dense file; in a MoE file the expert set, the gated
    set in deepseek's leading dense layers, and the expert set with the
    gated set beside it in arctic's layers (with its ffn_norm_exps)."""
    if not hp.n_expert:
        return [_DENSE_FFN, _UP_DOWN_FFN]
    if i < hp.n_layer_dense_lead:
        return [_DENSE_FFN]
    if "ffn_norm_exps.weight" in names:
        return [_MOE_FFN | _DENSE_FFN]
    return [_MOE_FFN]


def _check_moe_extras(hp: HParams, i: int, names: set) -> None:
    """The shared experts (all three planes, qwen2moe's gate vector
    optional), the selection bias and arctic's norm only in a MoE layer;
    a file that counts shared experts carries them in every MoE layer."""
    moe = "ffn_gate_inp.weight" in names
    extras = names & _MOE_EXTRAS
    shexp = extras - {"exp_probs_b.bias", "ffn_norm_exps.weight"}
    if (extras and not moe) or (shexp and not _SHEXP <= shexp) or (
            moe and hp.n_expert_shared and not _SHEXP <= names):
        raise NotImplementedError(
            f"blk.{i} tensors {sorted(extras)} (expert_shared_count "
            f"{hp.n_expert_shared}): this port carries ffn_gate_shexp, "
            "ffn_up_shexp and ffn_down_shexp together (with an optional "
            "ffn_gate_inp_shexp), exp_probs_b and ffn_norm_exps in MoE "
            "layers only")


def _check_layer(reader: GGUFReader, hp: HParams, i: int,
                 names: set) -> None:
    """Refuse a layer whose tensors the forward of its kind would not
    apply, or which lacks one it needs."""
    t = reader.tensors
    ffn = names & (_DENSE_FFN | _MOE_FFN)
    if ffn not in _ffn_sets(hp, i, names):
        raise NotImplementedError(
            f"blk.{i} FFN tensors {sorted(ffn)}: this port carries "
            + ("the expert set (the gated set in the leading dense layers "
               "and beside the experts with ffn_norm_exps)" if hp.n_expert
               else "the gated set or a non-gated up and down")
            + " in every layer")
    _check_moe_extras(hp, i, names)
    gated = "ffn_gate.weight" in names or (
        "ffn_up.weight" in names and
        t[f"blk.{i}.ffn_up.weight"].shape[-1] == 2 * hp.n_ff_of(i))
    odd = [n for n in _SEQUENTIAL_GATED if n in names
           and (hp.parallel_residual or hp.post_norm or not gated)]
    if hp.post_norm:
        odd += sorted(names & _PRE_NORM_ONLY)
        if not {"attn_output_norm.weight",
                "layer_output_norm.weight"} <= names:
            raise KeyError(f"blk.{i}: attn_output_norm and "
                           "layer_output_norm are required in a post-norm "
                           f"layer (arch {hp.arch})")
    else:
        odd += sorted(names & _POST_NORMS - _BRANCH_NORMS.get(hp.arch, set()))
        if hp.arch == "dbrx" and {"attn_output_norm.weight",
                                  "ffn_norm.weight"} <= names:
            odd.append("attn_output_norm.weight")
    for w in ("attn_q_norm", "attn_k_norm"):
        if f"{w}.bias" in names and (
                hp.parallel_residual or f"{w}.weight" not in names or
                t[f"blk.{i}.{w}.bias"].shape != t[f"blk.{i}.{w}.weight"].shape
                or len(t[f"blk.{i}.{w}.weight"].shape) != 2):
            odd.append(f"{w}.bias")
    if odd:
        raise NotImplementedError(
            f"blk.{i} tensors outside the layouts of the ported archs: "
            f"{odd} apply only in another kind of layer")
    attn = names & (_QKV | {"attn_qkv.weight"} | _MLA_Q | _MLA_KV)
    if not attends(hp, i):
        # deci: an attention-free layer has no attention tensors, a
        # linear-attention layer its norm and wo alone
        lin = linear_attention(hp, i)
        extra = names & (_QKV | {"attn_qkv.weight", "attn_qkv.bias"}
                         | set(_BIASES) | {"attn_output.bias"})
        if not lin:
            extra |= names & {"attn_norm.weight", "attn_output.weight"}
        if extra or (lin and not {"attn_norm.weight",
                                  "attn_output.weight"} <= names):
            raise NotImplementedError(
                f"blk.{i}: a {'linear' if lin else 'free'}-attention layer "
                f"(n_head {hp.n_head_of(i)}, n_head_kv {hp.n_head_kv_of(i)})"
                f" with tensors {sorted(names - ffn)}: this port carries "
                + ("attn_norm and attn_output" if lin else "its FFN")
                + " alone there")
        if "ffn_norm.weight" not in names:
            raise KeyError(f"blk.{i}: ffn_norm.weight missing")
        return
    if attn not in (_MLA_SETS if hp.n_lora_kv else
                    (_QKV, {"attn_qkv.weight"})):
        raise NotImplementedError(
            f"blk.{i} attention tensors {sorted(attn)}: this port "
            + ("carries the MLA sets (attn_q or attn_q_a, attn_q_a_norm "
               "and attn_q_b; attn_kv_a_mqa, attn_kv_a_norm and attn_kv_b)"
               f" at kv_lora_rank {hp.n_lora_kv}" if hp.n_lora_kv else
               "carries attn_q, attn_k and attn_v or a fused attn_qkv"))
    # dbrx's pre-MoE norm is its attn_output_norm
    ffn_normed = "ffn_norm.weight" in names or (
        hp.arch == "dbrx" and "attn_output_norm.weight" in names)
    if hp.arch not in _NORMLESS and not hp.post_norm and (
            "attn_norm.weight" not in names or not (
                ffn_normed or hp.parallel_residual)):
        raise KeyError(f"blk.{i}: a norm tensor is missing (arch "
                       f"{hp.arch} requires pre-norms)")


def _check_supported(reader: GGUFReader, hp: HParams) -> None:
    """Refuse what this port does not carry, instead of running another
    model than the file describes."""
    check_arch(hp.arch)
    if hp.n_expert and hp.expert_gating == "sparsemixer" and \
            hp.n_expert_used != 2:
        # the sparsemixer makes two picks whatever the count says
        raise NotImplementedError(
            f"sparsemixer routing with expert_used_count "
            f"{hp.n_expert_used}: it routes each token to 2 experts")
    if hp.n_lora_kv and (not hp.uniform_layers or
                         not 0 < hp.rope_dim < hp.head_dim or
                         hp.v_dim > hp.head_dim):
        raise NotImplementedError(
            f"MLA at head dim {hp.head_dim}, rope dim {hp.rope_dim}, value "
            f"dim {hp.v_dim}: this port carries a roped tail of each head "
            "and a value dim of at most the head dim, on uniform layers")
    if hp.n_expert and not 0 < hp.n_expert_used <= hp.n_expert:
        raise ValueError(f"expert_used_count {hp.n_expert_used} of "
                         f"{hp.n_expert} experts")
    for key, arr in (("head_count", hp.n_head_layers),
                     ("head_count_kv", hp.n_head_kv_layers),
                     ("feed_forward_length", hp.n_ff_layers)):
        if arr and len(arr) != hp.n_layer:
            raise ValueError(f"{hp.arch}.{key}: {len(arr)} entries for "
                             f"{hp.n_layer} layers")
    for li in range(hp.n_layer):
        h, kvh = hp.n_head_of(li), hp.n_head_kv_of(li)
        if attends(hp, li) and (kvh <= 0 or h % kvh):
            raise NotImplementedError(
                f"blk.{li}: {h} query heads on {kvh} KV heads")
    modes = {hp.pos_embd} | ({"post_norm"} if hp.post_norm else set())
    unknown = []
    have = [set() for _ in range(hp.n_layer)]
    for name in reader.tensors:
        if name in _TOP_TENSORS or modes & set(_EMBED_EXTRAS.get(name, ())):
            continue
        parts = name.split(".", 2)
        if parts[0] == "blk" and len(parts) == 3 and parts[2] in _LAYER_TENSORS:
            if int(parts[1]) < hp.n_layer:
                have[int(parts[1])].add(parts[2])
            continue
        unknown.append(name)
    if hp.post_norm:
        unknown += [n for n in ("output.weight", "output.bias",
                                "output_norm.weight", "output_norm.bias")
                    if n in reader.tensors]
    if unknown:
        raise NotImplementedError(
            "tensors outside the layouts of the ported archs: "
            f"{sorted(unknown)[:5]}")
    for name, info in reader.tensors.items():
        if name.endswith(("attn_q_norm.weight", "attn_k_norm.weight")):
            _check_qk_norm(name, tuple(info.shape), hp,
                           int(name.split(".")[1]))
    if ("rope_factors_short.weight" in reader.tensors) != \
            ("rope_factors_long.weight" in reader.tensors):
        raise NotImplementedError("rope_factors_short and rope_factors_long "
                                  "come as a pair")
    for i, names in enumerate(have):
        _check_layer(reader, hp, i, names)
    if "output_norm.weight" not in reader.tensors and \
            hp.arch != "olmo" and not hp.post_norm:
        raise KeyError("output_norm.weight missing")


def _split_rows(reader: GGUFReader, name: str, bounds,
                perms=None) -> list[QTensor]:
    """A fused tensor's row ranges [lo, hi) as QTensors: block quantization
    is per row, so each range is a slice of packed byte rows (the
    reference's split_qkv and fused gate|up split), its rows reordered by
    the range's entry of perms where that is not None."""
    info = reader.tensors[name]
    k, n = info.shape[0], info.shape[1]
    raw = reader.tensor_bytes(name)
    rows = raw.reshape(n, raw.size // n)
    perms = perms or [None] * len(bounds)
    return [repack(np.ascontiguousarray(
        rows[lo:hi] if perm is None else rows[lo:hi][perm]), info.ggml_type,
        hi - lo, k) for (lo, hi), perm in zip(bounds, perms)]


def load_weights(reader: GGUFReader, hp: HParams | None = None
                 ) -> tuple[HParams, LlamaWeights]:
    """Load + repack all tensors of a GGUF of a ported arch into host
    planes."""
    if hp is None:
        # a recurrent or unported arch is refused before its hparams are
        # read as a llama body's
        check_arch(reader.metadata.get("general.architecture", "llama"))
        hp = hparams_from_metadata(reader.metadata)
    _check_supported(reader, hp)
    t = reader.tensors

    def perms(i: int):
        """NORM-rope Q/K rows (and biases) are un-permuted to half-split at
        the layer's own head counts (deci's per-layer KV heads); NEOX rows
        are half-split already."""
        if hp.rope_type != "norm":
            return None, None
        return (_unpermute_rows(hp.n_head_of(i), hp.head_dim, hp.rope_dim),
                _unpermute_rows(hp.n_head_kv_of(i), hp.head_dim,
                                hp.rope_dim))

    def layer(i: int) -> LayerWeights:
        p = f"blk.{i}."
        opt = lambda name: _f32(reader, p + name) if p + name in t else None
        lw = LayerWeights(
            attn_norm=opt("attn_norm.weight"),
            wo=(_repack_2d(reader, p + "attn_output.weight")
                if p + "attn_output.weight" in t else None),
            ffn_norm=opt("ffn_norm.weight"))
        q_perm, k_perm = perms(i)
        n_q = hp.n_head_of(i) * hp.head_dim
        n_kv = hp.n_head_kv_of(i) * hp.head_dim
        if p + "attn_kv_a_mqa.weight" in t:
            # MLA: only the pe rows of a NORM-rope file (deepseek2) are
            # permuted; minicpm3's are NEOX already
            norm_rope = hp.rope_type == "norm"
            mqp = _mla_q_perm(hp) if norm_rope else None
            q_perm = k_perm = None
            if p + "attn_q_a.weight" in t:
                lw.wq_a = _repack_2d(reader, p + "attn_q_a.weight")
                lw.attn_q_a_norm = _f32(reader, p + "attn_q_a_norm.weight")
                lw.wq_b = _repack_2d(reader, p + "attn_q_b.weight", mqp)
            else:
                lw.wq = _repack_2d(reader, p + "attn_q.weight", mqp)
            lw.wkv_a = _repack_2d(reader, p + "attn_kv_a_mqa.weight",
                                  _mla_kva_perm(hp) if norm_rope else None)
            lw.attn_kv_a_norm = _f32(reader, p + "attn_kv_a_norm.weight")
            lw.wkv_b = _repack_2d(reader, p + "attn_kv_b.weight")
        elif p + "attn_qkv.weight" in t:
            # fused [q; k; v] rows, as phi2, phi3, falcon, gptneox, qwen,
            # codeshell, gpt2, starcoder, bloom, mpt, jais, nomic-bert and
            # openelm (at the layer's head counts) store them, with the
            # fused bias split alike; NORM-rope q and k rows (a chatglm
            # file as llama.cpp converts it) are un-permuted as the
            # separate tensors are, where the reference leaves them
            # interleaved (ROADMAP §3, fault 14). Without rope (gpt2,
            # bloom, mpt, jais) the same permutation of q and k would
            # cancel in q . k, and the rows stay in the reference's order
            fused_perm = q_perm is not None and hp.pos_embd == "rope"
            lw.wq, lw.wk, lw.wv = _split_rows(
                reader, p + "attn_qkv.weight",
                ((0, n_q), (n_q, n_q + n_kv), (n_q + n_kv, n_q + 2 * n_kv)),
                [q_perm, k_perm, None] if fused_perm else None)
            if p + "attn_qkv.bias" in t:
                bias = _f32(reader, p + "attn_qkv.bias")
                lw.bq, lw.bk, lw.bv = (bias[:n_q], bias[n_q:n_q + n_kv],
                                       bias[n_q + n_kv:n_q + 2 * n_kv])
                if fused_perm:
                    lw.bq, lw.bk = lw.bq[q_perm], lw.bk[k_perm]
        elif p + "attn_q.weight" in t:
            lw.wq = _repack_2d(reader, p + "attn_q.weight", q_perm)
            lw.wk = _repack_2d(reader, p + "attn_k.weight", k_perm)
            lw.wv = _repack_2d(reader, p + "attn_v.weight")
        # deci's attention-free and linear-attention layers carry no q, k
        # and v planes
        for name, perm in (("attn_q.bias", q_perm), ("attn_k.bias", k_perm),
                           ("attn_v.bias", None)):
            if p + name in t:
                bias = _f32(reader, p + name)
                setattr(lw, _BIASES[name],
                        bias if perm is None else bias[perm])
        for name, field in _QUIRK_VECTORS.items():
            if p + name in t:
                arr = _f32(reader, p + name)
                if arr.ndim == 2 and q_perm is not None:
                    # per-head LayerNorm weights and biases [H, d] of a
                    # NORM-rope file (Command R+, chameleon) follow the
                    # rows' within-head map
                    arr = arr[:, _unpermute_rows(1, hp.head_dim)]
                setattr(lw, field, arr)
        if hp.swin_norm:
            # chameleon-34B: no pre-norms; the attention and FFN norms
            # apply to the branch outputs, the sandwich post-norm slots
            lw.attn_post_norm, lw.attn_norm = lw.attn_norm, None
            lw.ffn_post_norm, lw.ffn_norm = lw.ffn_norm, None
        if hp.arch == "grok":
            # the norms of the attention and MoE branch outputs
            lw.attn_post_norm, lw.attn_out_norm = lw.attn_out_norm, None
            lw.ffn_post_norm, lw.layer_out_norm = lw.layer_out_norm, None
        if hp.arch == "dbrx" and lw.ffn_norm is None:
            # dbrx's pre-MoE norm, under the encoders' name
            lw.ffn_norm, lw.attn_out_norm = lw.attn_out_norm, None
        if lw.wk is not None:
            lw.wqkv = fuse_qtensors([lw.wq, lw.wk, lw.wv])
            if lw.wqkv is not None:
                lw.wq = lw.wk = lw.wv = None  # fused plane replaces them
        if p + "ffn_gate_inp.weight" in t:
            # an F32 router gives a 'dense' QTensor (a plain product)
            lw.gate_inp = _repack_2d(reader, p + "ffn_gate_inp.weight")
            lw.gate_exps = _repack_3d(reader, p + "ffn_gate_exps.weight")
            lw.up_exps = _repack_3d(reader, p + "ffn_up_exps.weight")
            lw.down_exps = _repack_3d(reader, p + "ffn_down_exps.weight")
            if p + "ffn_up_shexp.weight" in t:
                for f in ("gate", "up", "down"):
                    setattr(lw, f"{f}_shexp", _repack_2d(
                        reader, p + f"ffn_{f}_shexp.weight"))
            lw.gate_inp_shexp = opt("ffn_gate_inp_shexp.weight")
            lw.exp_probs_b = opt("exp_probs_b.bias")
            lw.ffn_norm_exps = opt("ffn_norm_exps.weight")
            if p + "ffn_gate.weight" not in t:
                return lw
        lw.w_down = _repack_2d(reader, p + "ffn_down.weight")
        n_up, n_ff = t[p + "ffn_up.weight"].shape[-1], hp.n_ff_of(i)
        if p + "ffn_gate.weight" in t:
            lw.w_gate = _repack_2d(reader, p + "ffn_gate.weight")
            lw.w_up = _repack_2d(reader, p + "ffn_up.weight")
        elif n_up == 2 * n_ff:
            # phi3's [gate | up] rows in one ffn_up
            lw.w_gate, lw.w_up = _split_rows(
                reader, p + "ffn_up.weight", ((0, n_ff), (n_ff, n_up)))
        else:   # non-gated: up -> activation -> down
            lw.w_up = _repack_2d(reader, p + "ffn_up.weight")
            return lw
        lw.w_gateup = fuse_qtensors([lw.w_gate, lw.w_up])
        if lw.w_gateup is not None:
            lw.w_gate = lw.w_up = None
        return lw

    # layers are independent: repack them in parallel (numpy releases the GIL)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        f_embd = ex.submit(_repack_2d, reader, "token_embd.weight", None,
                           "rows")
        # the lm head pads N to tile_n=1024 multiples, as the reference
        # does; a file without output.weight (gemma) ties it to the
        # embedding; an encoder has none
        head = "output.weight" if "output.weight" in t else "token_embd.weight"
        f_out = None if hp.post_norm else ex.submit(
            _repack_2d, reader, head, None, "t", 1024)
        layer_list = list(ex.map(layer, range(hp.n_layer)))
        tok_embd = f_embd.result()
        output = None if f_out is None else f_out.result()
    inv_freq, mscale = layers.rope_freqs(hp)
    inv_freq_long = None
    if "rope_factors_short.weight" in t:
        # phi3 long rope: per-pair factors divide the base frequencies; the
        # short table serves by default, the long one past rope_orig_ctx
        short_f = _f32(reader, "rope_factors_short.weight")
        long_f = _f32(reader, "rope_factors_long.weight")
        if short_f.shape != inv_freq.shape or long_f.shape != inv_freq.shape:
            raise ValueError(
                f"rope factor tensors must be [rope_dim/2]={inv_freq.shape}; "
                f"got short {short_f.shape} long {long_f.shape}")
        inv_freq_long = np.asarray(inv_freq / long_f, np.float32)
        inv_freq = inv_freq / short_f
    inv_freq_swa = None
    if hp.rope_freq_base_swa > 0 and \
            hp.rope_freq_base_swa != hp.rope_freq_base:
        # the sliding-window layers' own base, unscaled (reference
        # load_weights builds it with rope_scaling "none")
        inv_freq_swa = np.asarray(layers.rope_freqs(dataclasses.replace(
            hp, rope_freq_base=hp.rope_freq_base_swa,
            rope_scaling="none"))[0])
    top = lambda name: _f32(reader, name) if name in t else None
    w = LlamaWeights(
        tok_embd=tok_embd,
        output_norm=top("output_norm.weight"),
        output=output,
        layers=layer_list,
        rope_inv_freq=np.asarray(inv_freq),
        rope_mscale=float(mscale),
        rope_inv_freq_swa=inv_freq_swa,
        rope_inv_freq_long=inv_freq_long,
        output_norm_b=top("output_norm.bias"),
        output_b=top("output.bias"),
        pos_embd=top("position_embd.weight"),
        type_embd=top("token_types.weight"),
        tok_norm=top("token_embd_norm.weight"),
        tok_norm_b=top("token_embd_norm.bias"),
        nope_global=hp.nope_global,
    )
    return hp, w


# ---------------------------------------------------------------------------
# forward


def linear(x: torch.Tensor, qt: QTensor, plain: bool = False,
           out_dtype=torch.float32) -> torch.Tensor:
    return (qmm_plain if plain else qmm)(x, qt, out_dtype=out_dtype)


def lora_delta(x: torch.Tensor, lora) -> torch.Tensor | None:
    """scale * (x A^T) B^T, the low-rank update, rounded as the reference
    rounds it: bf16 operands, products accumulated in float32, the first
    product rounded to bf16 before the second. A and B hold bf16 values
    in float32, so both products are float32 matmuls of bf16-rounded
    operands (with TF32 off, as torch leaves it by default)."""
    if lora is None:
        return None
    a, b, sc = lora
    u = torch.matmul(x.to(torch.bfloat16).float(), a.t())
    d = torch.matmul(u.to(torch.bfloat16).float(), b.t())
    return d * sc


def linear_lora(x: torch.Tensor, qt: QTensor, lora, plain: bool = False,
                out_dtype=torch.float32) -> torch.Tensor:
    """linear() plus the optional low-rank update."""
    y = linear(x, qt, plain, out_dtype)
    d = lora_delta(x, lora)
    return y if d is None else y + d.to(y.dtype)


def embed(w: LlamaWeights, tokens: torch.Tensor,
          scale: float = 1.0) -> torch.Tensor:
    """Embedding rows in bf16; a scale (gemma: sqrt(n_embd), not exact in
    bf16) multiplies in float32 before the bf16 rounding, as the
    reference orders it."""
    e = qgather(tokens, w.tok_embd, dtype=torch.bfloat16)
    if scale != 1.0:
        e = (e.float() * scale).to(torch.bfloat16)
    return e


def embed_extras(w: LlamaWeights, hp: HParams, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """The input-embedding additions of an encoder or a file without rope
    positions, in float32, then bf16: the token-type row 0 (the encoders;
    "sentence A", as the reference and llama.cpp take it), the learned
    absolute position rows at `positions` (gpt2, starcoder, bert), then
    the embedding LayerNorm (bloom, the encoders)."""
    xf = x.float()
    if w.type_embd is not None:
        xf = xf + w.type_embd[0]
    if w.pos_embd is not None:
        xf = xf + w.pos_embd[positions.long()]
    if w.tok_norm is not None:
        xf = layers.layer_norm(xf, w.tok_norm, w.tok_norm_b, hp.rms_eps)
    return xf.to(torch.bfloat16)


def embed_input(w: LlamaWeights, hp: HParams, tokens: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """The layers' input: the embedding rows (scaled), and on an encoder
    or a file without rope positions its extras (embed_extras)."""
    x = embed(w, tokens, hp.embd_scale)
    if hp.pos_embd == "rope" and not hp.post_norm:
        return x
    return embed_extras(w, hp, x, positions)


def alibi_of(hp: HParams, device) -> torch.Tensor | None:
    """The ALiBi slopes [n_head] float32 on device, or None without ALiBi."""
    if not hp.alibi:
        return None
    return torch.from_numpy(layers.alibi_slopes(
        hp.n_head, hp.alibi_max_bias, hp.alibi_style)).to(device)


def qkv_proj(cur: torch.Tensor, lw: LayerWeights, plain: bool = False):
    """Q/K/V projections, via the fused wqkv plane when available, each
    with its LoRA update when one is attached."""
    lora = lw.lora
    if lw.wqkv is not None:
        split = qmm_split_plain if plain else qmm_split
        outs = split(cur, lw.wqkv)
        deltas = [lora_delta(cur, lora.get(f)) for f in ("wq", "wk", "wv")]
        return tuple(o if d is None else o + d for o, d in zip(outs, deltas))
    return tuple(linear_lora(cur, getattr(lw, f), lora.get(f), plain)
                 for f in ("wq", "wk", "wv"))


def gateup_proj(cur: torch.Tensor, lw: LayerWeights, plain: bool = False):
    """SwiGLU gate/up projections, fused when available, each with its
    LoRA update when one is attached."""
    lora = lw.lora
    if lw.w_gateup is not None:
        split = qmm_split_plain if plain else qmm_split
        outs = split(cur, lw.w_gateup)
        deltas = [lora_delta(cur, lora.get(f)) for f in ("w_gate", "w_up")]
        return tuple(o if d is None else o + d for o, d in zip(outs, deltas))
    return tuple(linear_lora(cur, getattr(lw, f), lora.get(f), plain)
                 for f in ("w_gate", "w_up"))


def _norm(hp: HParams, x: torch.Tensor, weight, bias) -> torch.Tensor:
    """The arch's norm: LayerNorm (weight and bias each optional), or RMS
    norm, where a missing weight is the identity (olmo2's pre-norms)."""
    if hp.norm_type == "ln":
        return layers.layer_norm(x, weight, bias, hp.rms_eps)
    return x if weight is None else layers.rms_norm(x, weight, hp.rms_eps)


def _add(y: torch.Tensor, bias) -> torch.Tensor:
    return y if bias is None else y + bias


def _qk_norm(y: torch.Tensor, weight, bias, hp: HParams) -> torch.Tensor:
    """Per-head QK norm of y [B, T, H, D]: [H, D] weights are distinct
    LayerNorms, with chameleon's biases where given, [D] weights one RMS
    norm."""
    if weight is None:
        return y
    if weight.ndim == 2:
        return layers.layer_norm(y, weight, bias, hp.rms_eps)
    return layers.rms_norm(y, weight, hp.rms_eps)


def _attention(cur: torch.Tensor, lw: LayerWeights, hp: HParams,
               positions, inv_freq, mscale: float, attend, plain: bool,
               tap, li: int = 0, mrope_pos=None) -> torch.Tensor:
    """The attention branch of layer li on the normed input cur [B, T, C]
    at the layer's head counts: its output after wo and its bias, float32
    [B, T, C]. mrope_pos [B, T, 3] (qwen2vl image tokens) ropes q and k
    by their M-RoPE streams instead of positions."""
    b, tdim, _ = cur.shape
    h, kvh, d = hp.n_head_of(li), hp.n_head_kv_of(li), hp.head_dim
    if tap is not None:
        tap("attn_in", cur)
    q, k, v = qkv_proj(cur, lw, plain)
    if hp.clamp_kqv > 0:    # olmo clip_qkv
        q, k, v = (y.clamp(-hp.clamp_kqv, hp.clamp_kqv) for y in (q, k, v))
    q, k, v = _add(q, lw.bq), _add(k, lw.bk), _add(v, lw.bv)
    flat = lw.attn_q_norm is not None and lw.attn_q_norm.shape[-1] != d
    if flat:    # olmo2: RMS over the flat q and k, before the head split
        q = layers.rms_norm(q, lw.attn_q_norm, hp.rms_eps)
        k = layers.rms_norm(k, lw.attn_k_norm, hp.rms_eps)
    q = q.reshape(b, tdim, h, d)
    k = k.reshape(b, tdim, kvh, d)
    v = v.reshape(b, tdim, kvh, d)
    if not flat:     # per-head QK norms, before rope
        q = _qk_norm(q, lw.attn_q_norm, lw.attn_q_norm_b, hp)
        k = _qk_norm(k, lw.attn_k_norm, lw.attn_k_norm_b, hp)
    # no rope on a file without rope positions (learned rows entered at
    # the embedding; ALiBi biases the logits) or on cohere2's global layers
    if mrope_pos is not None and hp.mrope_sections:
        q = layers.apply_mrope(q, mrope_pos, inv_freq, hp.mrope_sections,
                               mscale)
        k = layers.apply_mrope(k, mrope_pos, inv_freq, hp.mrope_sections,
                               mscale)
    elif hp.pos_embd == "rope" and inv_freq is not None:
        q = layers.apply_rope(q, positions, inv_freq, mscale)
        k = layers.apply_rope(k, positions, inv_freq, mscale)
    attn_out = attend(q.to(torch.bfloat16), k.to(torch.bfloat16),
                      v.to(torch.bfloat16)).reshape(b, tdim, h * d)
    if lw.attn_sub_norm is not None:   # bitnet: RMS before wo
        attn_out = layers.rms_norm(attn_out, lw.attn_sub_norm, hp.rms_eps)
    if tap is not None:
        tap("attn_out", attn_out)
    return _add(linear_lora(attn_out, lw.wo, lw.lora.get("wo"), plain), lw.bo)


def mla_qkv(cur: torch.Tensor, lw: LayerWeights, hp: HParams, positions,
            inv_freq, mscale: float, plain: bool = False):
    """MLA projections of the normed input cur [B, T, C] (deepseek2,
    minicpm3): q by the low-rank wq_a -> RMS -> wq_b or a plain wq, each
    head [nope | pe]; wkv_a -> [compressed kv | one shared k_pe]; RMS of
    the compressed kv -> wkv_b -> each head [k_nope | v]. Rope turns the
    pe slices only (k_pe once, broadcast to every head); v is zero-padded
    to head_dim, so the paged KV cache and the attention kernels run at
    one head dim. Returns q, k, v [B, T, H, head_dim]."""
    b, tdim, _ = cur.shape
    h, dk, rd, dv = hp.n_head, hp.head_dim, hp.rope_dim, hp.v_dim
    nope = dk - rd
    if lw.wq_a is not None:
        qa = layers.rms_norm(linear(cur, lw.wq_a, plain), lw.attn_q_a_norm,
                             hp.rms_eps)
        q = linear(qa.to(torch.bfloat16), lw.wq_b, plain)
    else:
        q = linear_lora(cur, lw.wq, lw.lora.get("wq"), plain)
    q = q.reshape(b, tdim, h, dk)
    kva = linear(cur, lw.wkv_a, plain)
    kv_c = layers.rms_norm(kva[..., :hp.n_lora_kv], lw.attn_kv_a_norm,
                           hp.rms_eps)
    kvb = linear(kv_c.to(torch.bfloat16), lw.wkv_b, plain).reshape(
        b, tdim, h, nope + dv)
    q_pe = layers.apply_rope(q[..., nope:], positions, inv_freq, mscale)
    k_pe = layers.apply_rope(kva[..., None, hp.n_lora_kv:], positions,
                             inv_freq, mscale)
    q = torch.cat([q[..., :nope], q_pe], dim=-1)
    k = torch.cat([kvb[..., :nope], k_pe.expand(b, tdim, h, rd)], dim=-1)
    v = torch.nn.functional.pad(kvb[..., nope:], (0, dk - dv))
    return q, k, v


def _mla_attention(cur, lw, hp, positions, inv_freq, mscale, attend,
                   plain: bool, tap) -> torch.Tensor:
    """The MLA attention branch on the normed input: mla_qkv, attention at
    head_dim, the output cut to v_dim a head, then wo and its bias,
    float32 [B, T, C]."""
    b, tdim, _ = cur.shape
    if tap is not None:
        tap("attn_in", cur)
    q, k, v = mla_qkv(cur, lw, hp, positions, inv_freq, mscale, plain)
    attn_out = attend(q.to(torch.bfloat16), k.to(torch.bfloat16),
                      v.to(torch.bfloat16))[..., :hp.v_dim]
    attn_out = attn_out.reshape(b, tdim, hp.n_head * hp.v_dim)
    if tap is not None:
        tap("attn_out", attn_out)
    return _add(linear_lora(attn_out, lw.wo, lw.lora.get("wo"), plain), lw.bo)


def forward_layer(x: torch.Tensor, lw: LayerWeights, hp: HParams,
                  positions: torch.Tensor, inv_freq: torch.Tensor,
                  mscale: float, attend, plain: bool = False,
                  tap=None, li: int = 0, mrope_pos=None) -> torch.Tensor:
    """Layer li. x [B, T, C] bf16; attend(q, k, v) writes the KV and
    returns [B, T, H, D]; inv_freq is the layer's rope table; mrope_pos
    [B, T, 3], qwen2vl's image streams, replaces positions in the rope of
    a sequential layer (the reference's one M-RoPE branch). tap, if
    given, is called as tap(role, activation) with the input of each
    projection: "attn_in" (q, k, v), "attn_out" (wo, or the linear
    attention's projection), "ffn_in" (gate and up, or up alone, or the
    router and experts), "ffn_act" (down). A layer that does not attend
    (attends) never calls attend. An MLA layer adds its attention branch
    as it is (no post norm, no residual scale, as the reference adds it);
    arctic's layer adds its dense MLP on the post-attention sum and its
    experts on the layer input (_forward_layer_arctic)."""
    if hp.post_norm:
        return _forward_layer_postnorm(x, lw, hp, positions, inv_freq,
                                       mscale, attend, plain, tap)
    if hp.parallel_residual:
        return _forward_layer_parallel(x, lw, hp, positions, inv_freq,
                                       mscale, attend, plain, tap, li)
    if attention_free(hp, li):        # deci: the block is its FFN
        return _forward_layer_ffn(x, lw, hp, plain, tap)
    cur = _norm(hp, x, lw.attn_norm, lw.attn_norm_b)
    if lw.wkv_a is not None:
        o = _mla_attention(cur, lw, hp, positions, inv_freq, mscale, attend,
                           plain, tap)
        return _forward_layer_ffn(x + o.to(x.dtype), lw, hp, plain, tap)
    if linear_attention(hp, li):
        # deci: wo on the normed input replaces attention; its adapter
        # applies as llama.cpp's build_lora_mm applies it (the reference
        # drops it, ROADMAP §3 fault 20)
        if tap is not None:
            tap("attn_out", cur)
        o = linear_lora(cur, lw.wo, lw.lora.get("wo"), plain)
        return _forward_layer_ffn(x + o.to(x.dtype), lw, hp, plain, tap)
    o = _attention(cur, lw, hp, positions, inv_freq, mscale, attend, plain,
                   tap, li, mrope_pos)
    if lw.attn_post_norm is not None:  # sandwich norm on the branch
        o = layers.rms_norm(o, lw.attn_post_norm, hp.rms_eps)
    if hp.residual_scale != 1.0:       # granite
        o = o * hp.residual_scale
    if lw.ffn_norm_exps is not None:
        return _forward_layer_arctic(x, x + o.to(x.dtype), lw, hp, plain,
                                     tap)
    x = x + o.to(x.dtype)
    return _forward_layer_ffn(x, lw, hp, plain, tap)


def _forward_layer_arctic(x_in, x, lw, hp, plain: bool = False,
                          tap=None) -> torch.Tensor:
    """Arctic's FFN half: the dense MLP on the norm of the post-attention
    sum x, the experts on ffn_norm_exps of the layer input x_in, both
    added to x; then the control vector. The tap sees the dense MLP's
    input (the experts read another one)."""
    dense = _dense_ffn(_norm(hp, x, lw.ffn_norm, lw.ffn_norm_b), lw, hp,
                       plain, tap)
    x = x + dense.to(x.dtype)
    moe = moe_ffn(_norm(hp, x_in, lw.ffn_norm_exps, None), lw, hp, plain)
    x = x + moe.to(x.dtype)
    if lw.cvec is not None:
        x = x + lw.cvec.to(x.dtype)
    return x


def _forward_layer_parallel(x, lw, hp, positions, inv_freq, mscale, attend,
                            plain: bool = False, tap=None,
                            li: int = 0) -> torch.Tensor:
    """A parallel-residual layer, x + attn(norm(x)) + ffn(norm'(x)), with
    the arch's norm (hp.norm_type: LayerNorms, or RMS norms for plamo):
    the FFN reads the attention's norm (phi2, falcon-7B, command-r,
    cohere2, plamo), its own attn_norm_2 (falcon-40B) or a dedicated
    ffn_norm (gptneox). The FFN is non-gated, or gated SwiGLU (command-r,
    cohere2, plamo). The adapters apply as in a sequential layer, the
    control vector to the layer's output."""
    cur = _norm(hp, x, lw.attn_norm, lw.attn_norm_b)
    if lw.attn_norm_2 is not None:
        ffn_in = _norm(hp, x, lw.attn_norm_2, lw.attn_norm_2_b)
    elif lw.ffn_norm is not None:
        ffn_in = _norm(hp, x, lw.ffn_norm, lw.ffn_norm_b)
    else:
        ffn_in = cur
    o = _attention(cur, lw, hp, positions, inv_freq, mscale, attend, plain,
                   tap, li)
    ffn = _add(_ffn(ffn_in, lw, hp, plain, tap), lw.b_down)
    x = x + (o + ffn).to(x.dtype)
    if lw.cvec is not None:
        x = x + lw.cvec.to(x.dtype)
    return x


def _forward_layer_postnorm(x, lw, hp, positions, inv_freq, mscale, attend,
                            plain: bool = False, tap=None) -> torch.Tensor:
    """An encoder layer (bert, nomic-bert, jina-bert-v2): attention from
    the layer input (the projections' biases; rope on nomic-bert), then
    x = LN(x + attn), x = LN(x + ffn(x)), the sums in float32. The
    adapters apply as in a sequential layer; no control vector, as in the
    reference and llama.cpp's bert graph."""
    o = _attention(x, lw, hp, positions, inv_freq, mscale, attend, plain,
                   tap)
    x = layers.layer_norm(x.float() + o, lw.attn_out_norm,
                          lw.attn_out_norm_b, hp.rms_eps).to(x.dtype)
    ffn = _add(_ffn(x, lw, hp, plain, tap), lw.b_down)
    return layers.layer_norm(x.float() + ffn, lw.layer_out_norm,
                             lw.layer_out_norm_b, hp.rms_eps).to(x.dtype)


def _route(router: torch.Tensor, lw: LayerWeights, hp: HParams):
    """The top-k experts of each row of router logits [M, E] and their
    weights, in the reference's order of operations: softmax or sigmoid
    probabilities, the selection biased by exp_probs_b where given (the
    weights stay unbiased), weights renormalized under norm_topk, times
    expert_weights_scale; or phimoe's sparsemixer: two picks, each
    weighted by the softmax at its pick over the experts within
    2 * router_jitter (relative) of the best left, not renormalized. Torch
    ops on the router's device, no host sync."""
    if hp.expert_gating == "sparsemixer":
        eps2 = 2.0 * hp.router_jitter

        def pick(scores):
            m = scores.amax(dim=-1, keepdim=True)
            f = torch.maximum(scores.abs(), m)
            g = scores.masked_fill((m - scores) / f > eps2, float("-inf"))
            i = scores.argmax(dim=-1, keepdim=True)
            return i, torch.softmax(g, dim=-1).gather(-1, i)

        i1, w1 = pick(router)
        i2, w2 = pick(router.scatter(-1, i1, float("-inf")))
        topi, topv = torch.cat([i1, i2], dim=-1), torch.cat([w1, w2], dim=-1)
    else:
        probs = (torch.sigmoid(router) if hp.expert_gating == "sigmoid"
                 else torch.softmax(router, dim=-1))
        if lw.exp_probs_b is not None:
            topi = torch.topk(probs + lw.exp_probs_b, hp.n_expert_used,
                              dim=-1).indices
            topv = probs.gather(-1, topi)
        else:
            topv, topi = torch.topk(probs, hp.n_expert_used, dim=-1)
        if hp.norm_topk:
            topv = topv / topv.sum(dim=-1, keepdim=True)
    if hp.expert_weights_scale != 1.0:
        topv = topv * hp.expert_weights_scale
    return topi, topv


def moe_ffn(x: torch.Tensor, lw: LayerWeights, hp: HParams,
            plain: bool = False) -> torch.Tensor:
    """The routed experts: the router's logits, the routing (_route), the
    experts through the grouped matmul (_moe_grouped). x [B, T, C] ->
    [B, T, C] float32."""
    b, tdim = x.shape[0], x.shape[1]
    xf = x.reshape(-1, x.shape[-1])
    topi, topv = _route(linear(xf, lw.gate_inp, plain), lw, hp)
    out = _moe_grouped(xf, lw, hp, topi, topv, plain)
    return out.reshape(b, tdim, hp.n_embd)


def shared_expert_ffn(cur: torch.Tensor, lw: LayerWeights, hp: HParams,
                      plain: bool = False) -> torch.Tensor:
    """The shared experts on the normed input: the gated FFN of the
    arch's activation, times sigmoid(cur . gate_inp_shexp) in float32
    where that vector exists (qwen2moe), always on otherwise (deepseek,
    deepseek2). float32 [B, T, C]."""
    g = linear(cur, lw.gate_shexp, plain)
    u = linear(cur, lw.up_shexp, plain)
    sh = linear(layers.swiglu(g, u, hp.act_fn), lw.down_shexp, plain)
    if lw.gate_inp_shexp is not None:
        sh = sh * torch.sigmoid(cur.float() @ lw.gate_inp_shexp.float()
                                )[..., None]
    return sh


def _moe_grouped(xf, lw, hp, topi, topv, plain: bool = False):
    """Route once, reuse the plan for gate/up/down: one gather into
    scratch-row space, gate -> the arch's gated activation -> down there,
    one weighted scatter-add back per token."""
    m = xf.shape[0]
    tile_m = (gmm_mod.TILE_GEMV if m * hp.n_expert_used <= 256
              else gmm_mod.TILE_GEMM)
    routing = gmm_mod.route_tokens(topi, topv, n_expert_local=hp.n_expert,
                                   expert_offset=0, tile_m=tile_m)
    xs = xf[routing.tok_idx.long()]
    g = gmm_mod.gmm_apply(xs, lw.gate_exps, routing, tile_m, plain)
    u = gmm_mod.gmm_apply(xs, lw.up_exps, routing, tile_m, plain)
    h = layers.swiglu(g, u, hp.act_fn)
    y = gmm_mod.gmm_apply(h, lw.down_exps, routing, tile_m, plain)
    return gmm_mod.combine(y, routing, m)


def _ffn(cur: torch.Tensor, lw: LayerWeights, hp: HParams,
         plain: bool = False, tap=None) -> torch.Tensor:
    """The FFN on its normed input cur, before the down bias: the routed
    experts of a MoE layer, or the dense FFN (_dense_ffn). float32
    [B, T, C]."""
    if lw.gate_inp is not None:
        if tap is not None:
            tap("ffn_in", cur)
        return moe_ffn(cur, lw, hp, plain)
    return _dense_ffn(cur, lw, hp, plain, tap)


def _dense_ffn(cur: torch.Tensor, lw: LayerWeights, hp: HParams,
               plain: bool = False, tap=None) -> torch.Tensor:
    """gate|up (+ gate and up biases) -> SwiGLU or GeGLU (-> bitnet's
    sub-norm) -> down; or a non-gated up (+ bias) -> GELU (tanh or erf)
    or squared ReLU -> down. float32 [B, T, C]."""
    if tap is not None:
        tap("ffn_in", cur)
    if lw.w_gate is None and lw.w_gateup is None:
        u = _add(linear_lora(cur, lw.w_up, lw.lora.get("w_up"), plain),
                 lw.b_up)
        act = layers.activation(u, hp.act_fn).to(torch.bfloat16)
    else:
        g, u = gateup_proj(cur, lw, plain)
        act = layers.swiglu(_add(g, lw.b_gate), _add(u, lw.b_up), hp.act_fn)
        if lw.ffn_sub_norm is not None:   # bitnet: RMS before ffn_down
            act = layers.rms_norm(act, lw.ffn_sub_norm, hp.rms_eps)
    if tap is not None:
        tap("ffn_act", act)
    return linear_lora(act, lw.w_down, lw.lora.get("w_down"), plain)


def _forward_layer_ffn(x: torch.Tensor, lw: LayerWeights, hp: HParams,
                       plain: bool = False, tap=None) -> torch.Tensor:
    """FFN half of a sequential layer: the norm, the FFN and its down
    bias, the shared experts, the residual scale, the post-FFN norm, the
    residual; then the control vector, if any."""
    cur = _norm(hp, x, lw.ffn_norm, lw.ffn_norm_b)
    ffn = _add(_ffn(cur, lw, hp, plain, tap), lw.b_down)
    if lw.up_shexp is not None:
        ffn = ffn + shared_expert_ffn(cur, lw, hp, plain)
    if hp.residual_scale != 1.0:       # granite
        ffn = ffn * hp.residual_scale
    if lw.ffn_post_norm is not None:
        ffn = layers.rms_norm(ffn, lw.ffn_post_norm, hp.rms_eps)
    x = x + ffn.to(x.dtype)
    if lw.cvec is not None:
        x = x + lw.cvec.to(x.dtype)
    return x


def final_norm(w: LlamaWeights, hp: HParams, x: torch.Tensor) -> torch.Tensor:
    """The output norm, RMS or LayerNorm (+ bias) by the arch: lm_head's
    and every pooled embedding's. An encoder's layers end in their own
    LayerNorm, and it has none."""
    if hp.post_norm:
        return x
    return _norm(hp, x, w.output_norm, w.output_norm_b)


def lm_head(w: LlamaWeights, hp: HParams, x: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    """Final norm + output projection (+ bias), divided by the logits
    scale, then the final softcap (gemma2) -> float32 logits
    [..., n_vocab]. An encoder has no LM head and raises."""
    if w.output is None:
        raise NotImplementedError(
            f"arch {hp.arch} is an encoder: it has no LM head and gives "
            "embeddings only (Context.embed)")
    logits = _add(linear(final_norm(w, hp, x), w.output, plain), w.output_b)
    if hp.logits_scale != 1.0:
        logits = logits / hp.logits_scale
    if hp.final_softcap > 0:
        logits = torch.tanh(logits / hp.final_softcap) * hp.final_softcap
    return logits
